"""stitchingvideo_tpu_torch — the PyTorch + CUDA port of stitchingvideo_tpu.

The video hot loop runs on an NVIDIA H100 through kernels written by hand in
`csrc/`: the seam-select mode (`compose_mode='lut'`) with its `mat2`, `mat`
and `tiled` kernels, the feather mode (`compose_mode='feather'`) and the
multiband mode (`compose_mode='multiband'`, whose warp stage is the kernel
and whose pyramids are plain PyTorch).
Registration runs on the device too: `register_images` (features, pairwise
matching + RANSAC, rotations, bundle adjustment, wave correction) gives the
cameras, and `Stitcher.estimate_transform` the whole `Registration` (seams,
exposure gains, per-pixel maps; the graph cut's max-flow runs on the host,
in C++ that g++ builds on first use). `VideoStitcher.register` builds the
hot loop's state from a frame set, `VideoStitcher.run` streams a frame
source and re-registers in a worker thread, and `save_registration` /
`load_registration` persist the state (either package reads the other's
file); `install_lut` takes a `CompositeLUT` (and, for feather and
multiband, the `Registration`) directly. The still path runs too:
`Stitcher.stitch` (the OpenCV-faithful compose of `models/compose_cv.py` by
default, or `estimate_transform` + `compose_panorama`), and in feather or
multiband mode `VideoStitcher.composite` serves the full blend for a
registration that has no state of the mode.
Ingest and output are the reference's too: frame sources over still
replays, frame directories, video files and URLs (cv2) and shared-memory
rings (`SharedMemorySource`, fed by producer processes through
`native/sharemem.cpp`, the JAX package's ring layout); the sinks of
`video/sink.py`; the CLI, `python -m stitchingvideo_tpu_torch.cli`
(`stitch`, and `video` with `--mode replay|dirs|videos|shm|shm_attach`);
and the chessboard calibration, `python -m
stitchingvideo_tpu_torch.tools.calibrate`.

The package imports torch and numpy only (`cv2` and `imageio` inside the
functions that read or write files). CUDA sources are compiled with
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
from .models.stitcher import Stitcher
from .register.pipeline import RegistrationResult, register_images
from .video.lut import (CompositeLUT, build_lut, composite_frame,
                        composite_frame_u8)
from .video.runtime import FrameStats, VideoStitcher
from .video.sources import (DirectorySource, FrameSource, ReplaySource,
                            SharedMemorySource, SyntheticSource,
                            VideoFileSource)

__version__ = "0.1.0"

__all__ = [
    "Cameras", "CompositeLUT", "ComposeConfig", "DirectorySource",
    "FeatureConfig", "FrameStats",
    "MatchConfig", "MultibandVideoState", "ParallelConfig", "Registration",
    "RegistrationConfig", "RegistrationResult",
    "ScaleConfig", "StitchConfig", "Stitcher", "UndistortConfig", "VideoConfig",
    "FrameSource", "ReplaySource", "SharedMemorySource", "SyntheticSource",
    "VideoFileSource",
    "VideoStitcher", "build_lut", "build_multiband_state",
    "cli_default_config", "composite_frame", "composite_frame_u8",
    "multiband_video_frame", "multiband_video_frames_batched",
    "register_images",
]
