"""Carrying a registration across: the JAX package saves it, the port loads
it, every field is equal; and the port stands alone (no JAX import)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stitchingvideo_tpu.models.registration import Registration as JReg
from stitchingvideo_tpu_torch.models.camera import Cameras
from stitchingvideo_tpu_torch.models.registration import Registration

FRAME_HW = (128, 512)
ROI_HW = (112, 400)
CORNERS = ((0, 0), (330, 6), (660, 3))
# canvas-x ownership ranges of the seam masks; 300..365 is owned twice, so
# the first owner must win
OWN_X = ((0, 365), (300, 700), (680, 1 << 20))


def make_registration_dict(seed: int = 0, src_indices=(0, 1, 2)) -> dict:
    """A small 3-camera registration in the JAX package's state_dict format,
    built in numpy (no registration is run)."""
    rng = np.random.default_rng(seed)
    n = len(CORNERS)
    fh, fw = FRAME_HW
    Hr, Wr = ROI_HW
    yr, xr = np.meshgrid(np.arange(Hr, dtype=np.float32),
                         np.arange(Wr, dtype=np.float32), indexing="ij")
    xmaps, ymaps, valid, seams, gains = [], [], [], [], []
    for i, (cx, cy) in enumerate(CORNERS):
        rot = 0.03 * (i - 1)
        sx = 40 + xr * (fw - 80) / Wr + rot * yr + rng.uniform(0, 1)
        sy = 6 + yr * (fh - 12) / Hr - rot * xr * 0.2 + rng.uniform(0, 1)
        xmaps.append(sx.astype(np.float32))
        ymaps.append(sy.astype(np.float32))
        valid.append((sx >= 0) & (sx < fw - 1) & (sy >= 0) & (sy < fh - 1))
        canvas_x = cx + xr
        seams.append((canvas_x >= OWN_X[i][0]) & (canvas_x < OWN_X[i][1]))
        gains.append((1.0 + 0.1 * np.sin(xr / (17.0 + i)) + 0.02 * i)
                     .astype(np.float32))
    R = np.stack([np.eye(3, dtype=np.float32)] * n)
    R[:, 0, 1] = rng.uniform(-0.1, 0.1, n)
    return {
        "focal": rng.uniform(300, 400, n).astype(np.float32),
        "aspect": np.ones(n, np.float32),
        "ppx": np.full(n, fw / 2, np.float32),
        "ppy": np.full(n, fh / 2, np.float32),
        "R": R, "t": np.zeros((n, 3), np.float32),
        "corners": np.asarray(CORNERS, np.int32),
        "valid": np.stack(valid), "xmaps": np.stack(xmaps),
        "ymaps": np.stack(ymaps), "seam_masks": np.stack(seams),
        "gain_maps": np.stack(gains),
        "canvas_wh": np.asarray((1088, 128)),
        "extent_wh": np.asarray((1060, 118)),
        "roi_hw": np.asarray(ROI_HW),
        "warp_kind": np.asarray("cylindrical"),
        "warp_scale": np.asarray(350.0),
        "src_indices": np.asarray(src_indices),
    }


def test_registration_saved_by_jax_loads_equal(tmp_path):
    jreg = JReg.from_state_dict(make_registration_dict(src_indices=(0, 2, 3)))
    path = str(tmp_path / "reg.npz")
    jreg.save(path)
    reg = Registration.load(path, device="cpu")
    want = jreg.state_dict()
    got = reg.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert reg.n_cameras == jreg.n_cameras == 3
    assert (reg.canvas_wh, reg.extent_wh, reg.roi_hw, reg.src_indices) == \
        (jreg.canvas_wh, jreg.extent_wh, jreg.roi_hw, jreg.src_indices)
    assert (reg.warp_kind, reg.warp_scale) == (jreg.warp_kind,
                                               jreg.warp_scale)
    assert reg.xmaps.dtype == torch.float32 and reg.valid.dtype == torch.bool
    np.testing.assert_array_equal(reg.cameras.K().numpy(),
                                  np.asarray(jreg.cameras.K()))


def test_legacy_state_without_optional_keys():
    d = make_registration_dict()
    for k in ("extent_wh", "src_indices"):
        d.pop(k)
    reg = Registration.from_state_dict(d, device="cpu")
    jreg = JReg.from_state_dict(d)
    assert reg.extent_wh is None and reg.src_indices is None
    for k, v in jreg.state_dict().items():
        np.testing.assert_array_equal(reg.state_dict()[k], v, err_msg=k)


@pytest.mark.parametrize("entry", ["from_state_dict", "load",
                                   "cameras_create"])
def test_default_device_needs_cuda(entry, tmp_path, monkeypatch):
    """With no device given, state goes to CUDA or the call raises: a
    registration never lands on the CPU unasked."""
    d = make_registration_dict()
    path = str(tmp_path / "reg.npz")
    np.savez(path, **d)
    call = {
        "from_state_dict": lambda **kw: Registration.from_state_dict(d, **kw),
        "load": lambda **kw: Registration.load(path, **kw),
        "cameras_create": lambda **kw: Cameras.create(d["focal"], d["ppx"],
                                                      d["ppy"], **kw),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    # asked for, the CPU works
    got = call(device="cpu")
    assert (got.focal if entry == "cameras_create" else got.xmaps).device \
        == torch.device("cpu")


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX or the JAX
    package, in a fresh interpreter."""
    mods = ["stitchingvideo_tpu_torch", "stitchingvideo_tpu_torch.config",
            "stitchingvideo_tpu_torch.device",
            "stitchingvideo_tpu_torch.models.camera",
            "stitchingvideo_tpu_torch.models.registration",
            "stitchingvideo_tpu_torch.video.lut",
            "stitchingvideo_tpu_torch.video.runtime",
            "stitchingvideo_tpu_torch.ops._cuda",
            "stitchingvideo_tpu_torch.ops.composite",
            "stitchingvideo_tpu_torch.ops.composite_mat",
            "stitchingvideo_tpu_torch.ops.composite_mat2",
            "stitchingvideo_tpu_torch.ops.composite_feather",
            "stitchingvideo_tpu_torch.ops.distance",
            "stitchingvideo_tpu_torch.ops.remap_tiled",
            "stitchingvideo_tpu_torch.ops.pyramid_planar",
            "stitchingvideo_tpu_torch.ops.window_probe",
            "stitchingvideo_tpu_torch.blend.multiband",
            "stitchingvideo_tpu_torch.blend.multiband_video",
            "stitchingvideo_tpu_torch.geometry.rotation",
            "stitchingvideo_tpu_torch.geometry.projections",
            "stitchingvideo_tpu_torch.geometry.autocalib",
            "stitchingvideo_tpu_torch.ops.fma",
            "stitchingvideo_tpu_torch.ops.color",
            "stitchingvideo_tpu_torch.ops.filters",
            "stitchingvideo_tpu_torch.ops.features",
            "stitchingvideo_tpu_torch.ops.matching",
            "stitchingvideo_tpu_torch.ops.homography",
            "stitchingvideo_tpu_torch.ops.ransac",
            "stitchingvideo_tpu_torch.ops.remap",
            "stitchingvideo_tpu_torch.register.graph",
            "stitchingvideo_tpu_torch.register.estimator",
            "stitchingvideo_tpu_torch.register.bundle",
            "stitchingvideo_tpu_torch.register.wave",
            "stitchingvideo_tpu_torch.register.pipeline",
            "stitchingvideo_tpu_torch.utils.synthetic"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'cv2', 'stitchingvideo_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
