"""stitchingvideo_tpu_torch — the PyTorch + CUDA port of stitchingvideo_tpu.

The video hot loop runs on an NVIDIA H100 through kernels written by hand in
`csrc/`: the seam-select mode (`compose_mode='lut'`) with its `mat2`, `mat`
and `tiled` kernels, and the feather mode (`compose_mode='feather'`).
Registration is taken as state: a `Registration` `.npz` that the JAX package
wrote (`VideoStitcher.load_registration`), or a `CompositeLUT` (and, for
feather, the `Registration`) handed to `VideoStitcher.install_lut`.

The package imports torch and numpy only. CUDA sources are compiled with
nvcc on first use, so the package imports on a machine without a GPU; its
entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

from .config import (ComposeConfig, FeatureConfig, MatchConfig, ParallelConfig,
                     RegistrationConfig, ScaleConfig, StitchConfig,
                     UndistortConfig, VideoConfig, cli_default_config)
from .models.camera import Cameras
from .models.registration import Registration
from .video.lut import (CompositeLUT, build_lut, composite_frame,
                        composite_frame_u8)
from .video.runtime import FrameStats, VideoStitcher

__version__ = "0.1.0"

__all__ = [
    "Cameras", "CompositeLUT", "ComposeConfig", "FeatureConfig", "FrameStats",
    "MatchConfig", "ParallelConfig", "Registration", "RegistrationConfig",
    "ScaleConfig", "StitchConfig", "UndistortConfig", "VideoConfig",
    "VideoStitcher", "build_lut", "cli_default_config", "composite_frame",
    "composite_frame_u8",
]
