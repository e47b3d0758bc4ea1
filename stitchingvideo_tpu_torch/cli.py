"""CLI mirroring the reference's flag set.

Port of `stitchingvideo_tpu/cli.py`, run as

    python -m stitchingvideo_tpu_torch.cli stitch IMAGES... [flags]
    python -m stitchingvideo_tpu_torch.cli video INPUTS... --mode MODE [flags]

Parity target: the reference CLI (stitching_detailed.cpp printUsage
:64-119, parseCmdArgs :145-326) so its .bat scenarios translate 1:1, e.g.
RunTest2.bat's `OpenCV2.4.11-Stitching img1..img6` -> `stitch img1..img6`,
plus a `video` subcommand for the RT-driver mode the reference compiles
constants for. Both run on the card unless `--device cpu` is given; with
no card and no `--device cpu` they raise, as the API does.
`video --canvas_shards N` composes over N canvas bands (`parallel/`): on
the card it needs N visible cards, with `--device cpu` the bands share the
CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def _build_cfg(args) -> "StitchConfig":
    from .config import StitchConfig
    cfg = StitchConfig()
    compose_megapix = args.compose_megapix
    if getattr(args, "preview", False):
        compose_megapix = 0.6   # reference --preview (:319-322)
    match_conf = args.match_conf
    if match_conf is None:
        # per-detector ratio retune, like the reference's surf/orb split
        # (stitching_detailed.cpp:190-199: surf 0.65, orb 0.3). Our 128-dim
        # gradient histograms sit between: 0.5 measured on the reference
        # footage gives near-pure inlier sets (40/40, 30/32 per pair) where
        # 0.65 starves the match graph and 0.3 admits junk on degraded rigs
        match_conf = 0.5 if args.features == "grad" else 0.3
    cfg = cfg.replace(
        scales=dataclasses.replace(
            cfg.scales, work_megapix=args.work_megapix,
            seam_megapix=args.seam_megapix, compose_megapix=compose_megapix),
        features=dataclasses.replace(
            cfg.features, kind=args.features),
        match=dataclasses.replace(cfg.match, match_conf=match_conf),
        register=dataclasses.replace(
            cfg.register, conf_thresh=args.conf_thresh, ba_kind=args.ba,
            ba_refine_mask=args.ba_refine_mask,
            wave_correct=None if args.wave_correct == "no" else args.wave_correct),
        compose=dataclasses.replace(
            cfg.compose, warp_type=args.warp, seam_find=args.seam,
            expos_comp=args.expos_comp, blend_type=args.blend,
            blend_strength=args.blend_strength),
    )
    if getattr(args, "undistort", False):
        und = dataclasses.replace(cfg.undistort, enabled=True)
        if args.undistort_params:
            v = [float(x) for x in args.undistort_params.split(",")]
            if len(v) != 8:
                raise SystemExit("--undistort_params needs 8 comma-separated "
                                 "values: FX,FY,CX,CY,K1,K2,P1,P2")
            und = dataclasses.replace(
                und, fx=v[0], fy=v[1], cx=v[2], cy=v[3],
                dist=(v[4], v[5], v[6], v[7]))
        cfg = cfg.replace(undistort=und)
    return cfg


def _add_common(p: argparse.ArgumentParser) -> None:
    # flag names/defaults follow the reference CLI (:122-143)
    p.add_argument("--work_megapix", type=float, default=0.6)
    p.add_argument("--seam_megapix", type=float, default=0.1)
    p.add_argument("--compose_megapix", type=float, default=-1.0)
    p.add_argument("--features", choices=["orb", "harris_brief", "grad"],
                   default="orb",
                   help="orb = binary rBRIEF (reference --features orb); "
                        "grad = float SURF-class gradient histograms "
                        "(reference --features surf, its default)")
    p.add_argument("--match_conf", type=float, default=None,
                   help="Lowe-ratio confidence; defaults 0.3 for binary "
                        "descriptors, 0.5 for --features grad (per-detector "
                        "retune like the reference's surf/orb split, "
                        "CLI :190-199)")
    p.add_argument("--conf_thresh", type=float, default=1.0)
    p.add_argument("--ba", choices=["no", "reproj", "ray"], default="ray")
    p.add_argument("--ba_refine_mask", default="xxxxx")
    p.add_argument("--wave_correct", choices=["no", "horiz", "vert"],
                   default="horiz")
    p.add_argument("--warp", default="spherical",
                   help="plane|cylindrical|spherical|fisheye|stereographic|"
                        "compressedPlaneA2B1|...|mercator|transverseMercator")
    p.add_argument("--seam", choices=["no", "voronoi", "gc_color", "gc_colorgrad",
                                      "dp_color", "dp_colorgrad"],
                   default="gc_color")
    p.add_argument("--expos_comp", choices=["no", "gain", "gain_blocks"],
                   default="gain_blocks")
    p.add_argument("--blend", choices=["no", "feather", "multiband"],
                   default="multiband")
    p.add_argument("--blend_strength", type=float, default=5.0)
    p.add_argument("--save_graph", default=None,
                   help="write DOT match graph to this file")
    p.add_argument("--output", default="result.jpg")
    p.add_argument("--log_timing", action="store_true",
                   help="print per-stage timing JSON (reference resultTime.txt parity)")
    p.add_argument("--preview", action="store_true",
                   help="faster preview mode: compose at 0.6 MP "
                        "(reference --preview, stitching_detailed.cpp:319)")
    p.add_argument("--try_gpu", choices=["yes", "no"], default="no",
                   help="accepted for flag parity; compute runs on "
                        "--device either way (the reference's GPU path is "
                        "a stub, src/warpers.cpp:298)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on; 'cuda' (the default) "
                        "raises when no CUDA device is present, 'cpu' runs "
                        "the plain PyTorch path")
    p.add_argument("--undistort", action="store_true",
                   help="fisheye/radial undistortion composed into the warp "
                        "maps (reference RT driver RunTestEyeFishMap)")
    p.add_argument("--undistort_params", default=None, metavar="FX,FY,CX,CY,K1,K2,P1,P2",
                   help="undistortion intrinsics+distortion (default: the "
                        "reference's hard-coded fisheye rig, 64-bit driver "
                        ":209-216)")


def _load_images(paths):
    import imageio.v3 as iio
    return [np.asarray(iio.imread(p))[..., :3] for p in paths]


def _device(args):
    """--device as a torch device: 'cuda' with no card raises, as the API's
    default device does (no silent fall back to the CPU)."""
    from .device import resolve_device
    return resolve_device(None if args.device == "cuda" else args.device,
                          "the CLI (--device cuda)")


def cmd_stitch(args) -> int:
    from .models.stitcher import Stitcher
    cfg = _build_cfg(args)
    device = _device(args)
    images = _load_images(args.images)
    st = Stitcher(cfg, device)
    t0 = time.perf_counter()
    # stitch() routes through the OpenCV-faithful compose path by default
    # (cfg.compose.faithful) — the PSNR-parity still pipeline
    pano, mask = st.stitch(images)
    t1 = time.perf_counter()
    print(f"stitched in {t1 - t0:.2f}s, pano {pano.shape[1]}x{pano.shape[0]}")
    if args.save_graph:
        from .register.graph import matches_graph_dot
        names = [str(p) for p in args.images]
        dot = matches_graph_dot(names, st._last_result.pair_stats,
                                args.conf_thresh)
        with open(args.save_graph, "w") as f:
            f.write(dot)
    import imageio.v3 as iio
    iio.imwrite(args.output, pano)
    print(f"wrote {args.output}")
    if args.log_timing:
        from .utils.timing import GLOBAL_TRACER
        print(GLOBAL_TRACER.dumps())
    return 0


def _unlink_rings(names) -> None:
    """Remove the rings of `names` that exist (the owner's cleanup after
    its producers are gone)."""
    from .video.sharemem import ShmRing
    for n in names:
        try:
            ShmRing.open(n).close(unlink=True)
        except OSError:
            pass


def cmd_video(args) -> int:
    import os
    import time as _time

    from .video.runtime import VideoStitcher
    from .video.sources import (DirectorySource, ReplaySource,
                                SharedMemorySource, VideoFileSource,
                                spawn_video_producer)
    cfg = _build_cfg(args)
    device = _device(args)
    cfg = cfg.replace(video=dataclasses.replace(
        cfg.video, reregister_seconds=args.reregister_seconds,
        compose_mode=args.compose_mode,
        pipeline_depth=args.pipeline_depth))
    mesh = None
    if getattr(args, "canvas_shards", 1) > 1:
        from .parallel.mesh import make_mesh
        cfg = cfg.replace(parallel=dataclasses.replace(
            cfg.parallel, canvas_shards=args.canvas_shards))
        # before any producer starts: on CUDA this needs canvas_shards
        # visible cards (the reference needs as many chips); on the CPU the
        # bands share the CPU device
        n = args.canvas_shards
        mesh = make_mesh(canvas=n, devices=None if device.type == "cuda"
                         else [device] * n)
    producers = []
    src = None
    try:
        if args.mode == "replay":
            src = ReplaySource(_load_images(args.inputs), jitter=2)
        elif args.mode == "dirs":
            src = DirectorySource(args.inputs, loop=True)
        elif args.mode == "shm":
            # the reference RT scenario: spawn one decode-producer process
            # per camera (WinExec(GetFromRtsp.exe ...), 64-bit driver
            # :785-793), then consume the shared-memory rings. Names carry a
            # time nonce so a PID-reused run can never attach a stale ring.
            names = [f"/svt_cli_{os.getpid()}_{int(_time.time()) % 10**6}_{i}"
                     for i in range(len(args.inputs))]
            producers = [spawn_video_producer(nm, uri, loop=True)
                         for nm, uri in zip(names, args.inputs)]
            deadline = _time.time() + 60
            while _time.time() < deadline and src is None:
                if any(p.poll() is not None for p in producers):
                    raise SystemExit("a decode producer exited at startup "
                                     "(bad input URI?)")
                try:
                    src = SharedMemorySource(names, timeout_s=5.0)
                except OSError:
                    _time.sleep(0.2)
            if src is None:
                raise SystemExit("shared-memory producers never came up")
        elif args.mode == "shm_attach":
            # attach to rings published by already-running producers
            src = SharedMemorySource(args.inputs, timeout_s=5.0)
        else:
            src = VideoFileSource(args.inputs)
    except BaseException:
        # startup failure must not orphan looping producer processes, nor
        # leave the rings those that came up created
        for p in producers:
            p.terminate()
        for p in producers:
            p.wait()
        if producers:
            _unlink_rings(names)
        raise
    # everything below runs under the same cleanup as the stream loop: a
    # failure here (bad --load_registration path, unwritable --output) must
    # not orphan the looping decode producers or leak their /dev/shm rings
    sink = None
    try:
        vs = VideoStitcher(cfg, device, mesh=mesh)
        if args.load_registration:
            # stream through the checkpointed registration immediately — the
            # cold slow path is skipped (reference camera-mp4.yml intent,
            # SURVEY §5.4, actually wired)
            vs.load_registration(args.load_registration)
        from .video.sink import make_sink

        def _on_key(k: int) -> None:
            # 'a' forces re-registration (reference 64-bit driver :768)
            if k == ord("a"):
                vs.force_reregister()

        sink = make_sink(args.output, fps=args.output_fps,
                         display=args.display, on_key=_on_key)
        on_frame = sink.write if sink is not None else None
        stats = vs.run(src, on_frame=on_frame, max_frames=args.frames)
        if args.save_registration:
            vs.save_registration(args.save_registration)
            print(f"registration saved to {args.save_registration}")
    finally:
        if sink is not None:
            sink.close()
        for p in producers:
            p.terminate()
        for p in producers:
            p.wait()
        if args.mode == "shm":
            src.close(unlink=True)   # we own the rings: no /dev/shm leak
        else:
            src.close()
    print(f"frames: {stats.frames}, fps: {stats.fps():.1f}, "
          f"registrations: {vs.registrations}" +
          (f", wrote {sink.frames_written} frames to {args.output}"
           if sink is not None and args.output else ""))
    if args.log_timing:
        from .utils.timing import GLOBAL_TRACER
        print(GLOBAL_TRACER.dumps())
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m stitchingvideo_tpu_torch.cli",
        description="panorama/video stitcher on PyTorch and CUDA "
                    "(reference-compatible flags)")
    sub = parser.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("stitch", help="batch still-image panorama "
                                       "(reference CLI mode)")
    ps.add_argument("images", nargs="+")
    _add_common(ps)
    ps.set_defaults(func=cmd_stitch)

    pv = sub.add_parser("video", help="real-time streaming mode "
                                      "(reference 64-bit driver mode)")
    pv.add_argument("inputs", nargs="+",
                    help="images (replay), directories, or video files/URLs")
    pv.add_argument("--mode",
                    choices=["replay", "dirs", "videos", "shm", "shm_attach"],
                    default="replay",
                    help="replay stills | frame directories | "
                         "cv2.VideoCapture files/URLs | spawn decode-producer "
                         "processes into shared memory (reference RT "
                         "scenario) | attach to existing shm rings")
    pv.add_argument("--compose_mode", choices=["lut", "feather", "multiband"],
                    default="lut",
                    help="per-frame composite: 'lut' = reference-parity seam "
                         "select; 'feather' = full feather blend, also "
                         "hot-loop grade")
    pv.add_argument("--frames", type=int, default=100)
    pv.add_argument("--reregister_seconds", type=float, default=30.0)
    pv.add_argument("--pipeline_depth", type=int, default=1,
                    help="frames in flight in the hot loop (1 = reference "
                         "semantics; K>1 overlaps dispatch/kernel/fetch, "
                         "delivery lags ingest by up to K-1 frames)")
    pv.add_argument("--output_fps", type=float, default=30.0,
                    help="frame rate stamped on the encoded --output video")
    pv.add_argument("--display", action="store_true",
                    help="show each composited frame in a window "
                         "(reference imshow loop, 64-bit driver :762-768)")
    pv.add_argument("--save_registration", default=None, metavar="PATH.npz",
                    help="persist the registration after the run; a later "
                         "run with --load_registration composes in seconds")
    pv.add_argument("--load_registration", default=None, metavar="PATH.npz",
                    help="start from a saved registration (skips the cold "
                         "slow path entirely)")
    pv.add_argument("--canvas_shards", type=int, default=1,
                    help="compose the panorama in this many canvas bands, "
                         "one a device: on CUDA it needs as many visible "
                         "cards; with --device cpu the bands share the CPU")
    _add_common(pv)
    pv.set_defaults(func=cmd_video)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
