"""stitchingvideo_tpu_torch — the PyTorch + CUDA port of stitchingvideo_tpu.

The video hot loop runs on an NVIDIA H100 through kernels written by hand in
`csrc/`: the seam-select mode (`compose_mode='lut'`) with its `mat2`, `mat`
and `tiled` kernels, the feather mode (`compose_mode='feather'`) and the
multiband mode (`compose_mode='multiband'`, whose warp stage is the kernel
and whose pyramids are plain PyTorch).
Registration from frames to cameras runs on the device too
(`register_images`: features, pairwise matching + RANSAC, rotations, bundle
adjustment, wave correction). The hot loop takes its state as a
`Registration` `.npz` that the JAX package wrote
(`VideoStitcher.load_registration`), or a `CompositeLUT` (and, for feather
and multiband, the `Registration`) handed to `VideoStitcher.install_lut`.

The package imports torch and numpy only. CUDA sources are compiled with
nvcc on first use, so the package imports on a machine without a GPU; its
entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

from .blend.multiband_video import (MultibandVideoState,
                                    build_multiband_state,
                                    multiband_video_frame,
                                    multiband_video_frames_batched)
from .config import (ComposeConfig, FeatureConfig, MatchConfig, ParallelConfig,
                     RegistrationConfig, ScaleConfig, StitchConfig,
                     UndistortConfig, VideoConfig, cli_default_config)
from .models.camera import Cameras
from .models.registration import Registration
from .register.pipeline import RegistrationResult, register_images
from .video.lut import (CompositeLUT, build_lut, composite_frame,
                        composite_frame_u8)
from .video.runtime import FrameStats, VideoStitcher

__version__ = "0.1.0"

__all__ = [
    "Cameras", "CompositeLUT", "ComposeConfig", "FeatureConfig", "FrameStats",
    "MatchConfig", "MultibandVideoState", "ParallelConfig", "Registration",
    "RegistrationConfig", "RegistrationResult",
    "ScaleConfig", "StitchConfig", "UndistortConfig", "VideoConfig",
    "VideoStitcher", "build_lut", "build_multiband_state",
    "cli_default_config", "composite_frame", "composite_frame_u8",
    "multiband_video_frame", "multiband_video_frames_batched",
    "register_images",
]
