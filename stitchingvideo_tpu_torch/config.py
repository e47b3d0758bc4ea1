"""Typed configuration for the whole pipeline.

One dataclass covers every flag of the reference CLI
(reference stitching/OpenCV2.4.11-Stitching/stitching_detailed.cpp:64-326) plus
the constants hard-coded into the real-time drivers (64-bit driver
stitching_detailed.cpp:29-47, :355-367, :843). Defaults follow the reference's
real-time driver where the two disagree (e.g. cylindrical warp, conf_thresh 0.6).

A copy of `stitchingvideo_tpu/config.py` with the same names and defaults:
the port never imports the JAX package, whose `__init__` pulls in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Feature detection/description (reference src/matchers.cpp:272-434)."""
    kind: str = "orb"                 # 'orb' (grid FAST+rBRIEF) | 'harris_brief'
                                      # | 'grad' (float SURF-class: Harris +
                                      #   oriented gradient histograms, L2)
    max_keypoints: int = 1024         # fixed capacity per image (static shapes)
    fast_threshold: float = 20.0      # FAST circle contrast threshold (on 0..255)
    grid: Tuple[int, int] = (3, 1)    # spatial grid like OrbFeaturesFinder(:370)
    patch_size: int = 31              # descriptor patch (ORB standard)
    descriptor_bits: int = 256
    nms_radius: int = 1               # 3x3 non-max suppression
    border: int = 24                  # keypoints excluded this close to edge
    num_levels: int = 1               # image-pyramid levels (ORB nlevels parity)
    scale_factor: float = 1.5         # pyramid decimation ratio


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Pairwise matching (reference src/matchers.cpp:147-202, :575-651)."""
    match_conf: float = 0.3           # Lowe ratio: d0 < (1-conf)*d1
    max_matches: int = 512            # fixed capacity per pair
    ransac_thresh: float = 3.0        # px reprojection threshold (findHomography default)
    ransac_iters: int = 512           # fixed hypothesis batch
    min_matches_for_h: int = 6        # below this, pair invalid (cf. :597)
    near_dup_confidence: float = 3.0  # confidence>3 zeroed as duplicate (:627)


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Camera estimation (reference src/motion_estimators.cpp, src/autocalib.cpp)."""
    conf_thresh: float = 0.6          # RT driver value (64-bit :358); CLI default 1.0
    ba_kind: str = "ray"              # 'ray' | 'reproj' | 'no'
    ba_refine_mask: str = "xxxxx"     # fx,skew,ppx,aspect,ppy refinement flags
    ba_iters: int = 50                # fixed LM outer iterations
    ba_min_inliers: int = 12          # pairs below this don't become BA edges
                                      # (a near-threshold spurious pair with a
                                      # handful of false inliers can poison LM)
    wave_correct: Optional[str] = "horiz"  # 'horiz' | 'vert' | None


@dataclasses.dataclass(frozen=True)
class ComposeConfig:
    """Warp + photometric + seams + blending.

    Reference CLI defaults (stitching_detailed.cpp:122-143) with RT-driver
    overrides noted.
    """
    warp_type: str = "cylindrical"    # RT driver (:365); CLI default 'spherical'
    expos_comp: str = "gain_blocks"   # 'no' | 'gain' | 'gain_blocks'
    expos_block_size: int = 32        # BlocksGainCompensator (exposure_compensate.hpp:89)
    seam_find: str = "gc_color"       # 'no'|'voronoi'|'gc_color'|'gc_colorgrad'|'dp_color'|'dp_colorgrad'
    blend_type: str = "multiband"     # 'no' | 'feather' | 'multiband'
    blend_strength: float = 5.0       # → blend width, bands (CLI :731-750)
    feather_sharpness: float = 0.02   # FeatherBlender default (blenders.hpp:72)
    faithful: bool = True             # still stitch(): use the OpenCV-faithful
                                      # compose path (models/compose_cv.py,
                                      # PSNR>=40dB parity); video keeps the
                                      # fused LUT fast path either way


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    """Multi-resolution decoupling (SURVEY §5.7; CLI :122-127)."""
    work_megapix: float = 0.6
    seam_megapix: float = 0.1
    compose_megapix: float = -1.0     # -1 = full resolution


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """Real-time mode (reference 64-bit driver)."""
    num_cameras: int = 4              # driver constant (:29)
    reregister_seconds: float = 30.0  # re-registration period (:843)
    crop_top_frac: float = 0.1        # upblack/downblack (:47)
    crop_bottom_frac: float = 0.1
    crop_left_px: int = 10            # leftblack/rightblack (:47)
    crop_right_px: int = 10
    compose_mode: str = "lut"         # 'lut' (reference parity) | 'feather' | 'multiband'
    kernel: str = "auto"              # composite kernel: 'auto' (mat2 > mat >
                                      # tiled > gather) or pinned; 'mat' has a
                                      # ~3x faster per-registration weight
                                      # build at ~15% lower hot-loop throughput
    pipeline_depth: int = 1           # run() frames in flight: 1 = deliver
                                      # frame i before reading i+1 (reference
                                      # hot-loop semantics, :724-770); K>1
                                      # pipelines K dispatches + async D2H so
                                      # delivery runs at kernel rate with a
                                      # K-frame bounded lag (video/stream.py)


@dataclasses.dataclass(frozen=True)
class UndistortConfig:
    """Fisheye/radial undistortion (64-bit driver :201-238, camera-mp4.yml)."""
    enabled: bool = False
    fx: float = 655.6037
    fy: float = 656.4377
    cx: float = 625.0631
    cy: float = 361.9647
    dist: Tuple[float, float, float, float] = (-0.38219, 0.19472, -0.00363, 0.00237)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout (SURVEY §2.3, §5.8)."""
    canvas_shards: int = 1            # canvas bands of the compose (parallel/)
    camera_shards: int = 1            # camera axis for registration fan-out
    axis_names: Tuple[str, str] = ("camera", "canvas")


@dataclasses.dataclass(frozen=True)
class StitchConfig:
    features: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    register: RegistrationConfig = dataclasses.field(default_factory=RegistrationConfig)
    compose: ComposeConfig = dataclasses.field(default_factory=ComposeConfig)
    scales: ScaleConfig = dataclasses.field(default_factory=ScaleConfig)
    video: VideoConfig = dataclasses.field(default_factory=VideoConfig)
    undistort: UndistortConfig = dataclasses.field(default_factory=UndistortConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "StitchConfig":
        return dataclasses.replace(self, **kw)


def cli_default_config() -> StitchConfig:
    """Config matching the reference *CLI* defaults (stitching_detailed.cpp:122-143)."""
    cfg = StitchConfig()
    return cfg.replace(
        compose=dataclasses.replace(cfg.compose, warp_type="spherical"),
        register=dataclasses.replace(cfg.register, conf_thresh=1.0),
    )
