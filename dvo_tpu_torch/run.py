"""CLI entry point of the PyTorch port — ``python -m dvo_tpu.run`` with the
same flags and the same JSON report, on a CUDA card (or, with ``--device
cpu``, on the CPU through the kernels' plain versions): a dataset in, a
TUM trajectory out, optional per-frame JSONL metrics and ATE.

Examples:
    python -m dvo_tpu_torch.run --data /path/to/logicool0 --mode mono \\
        --out traj.txt --max-frames 100
    python -m dvo_tpu_torch.run --data /path/to/tum/fr1_xyz --mode rgbd \\
        --format tum --out traj.txt --gt groundtruth.txt
    python -m dvo_tpu_torch.run --data /path/to/logicool0 --mode mono --ba \\
        --pose-graph --pose-graph-every 4 --out traj.txt
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True, help="sequence directory")
    ap.add_argument("--mode", choices=["mono", "rgbd"], default="mono")
    ap.add_argument("--format", choices=["info", "tum", "kinect", "euroc"], default="info",
                    help="info = reference info.txt (mono); tum = TUM rgb.txt/depth.txt; "
                         "kinect = info.txt with 'rgb depth' pairs + dual-camera registration; "
                         "euroc = EuRoC MAV ASL directory (mono)")
    ap.add_argument("--calib", default=None,
                    help="calibration YAML (default: logicool/TUM presets)")
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--gt", default=None, help="ground-truth TUM file for ATE")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=24,
                    help="frames per chunk of the chunked path: raw uint8/uint16 frames "
                         "go to the device through pinned double-buffered staging, and each "
                         "chunk's results are drained while the next one runs (same "
                         "trajectory as per-frame up to float noise).  0 = per-frame dispatch")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the torch.Generator that draws the monocular bootstrap "
                         "noise and depth-filter reset planes; torch cannot replay "
                         "jax.random, so a mono trajectory differs from dvo_tpu's for the "
                         "same seed")
    ap.add_argument("--no-undistort", action="store_true")
    ap.add_argument("--kinect-gray-cull", type=int, default=2,
                    help="host pre-cull stride for the kinect COLOR stream "
                         "(1 disables; depth is always pre-culled exactly — "
                         "utils.runner.run_kinect docstring)")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the hand-written kernels on the first CUDA card (an error "
                         "when there is none); cpu: their plain PyTorch versions")
    ap.add_argument("--metrics", default=None,
                    help="write per-frame JSONL metrics to this path")
    ap.add_argument("--checkpoint", default=None,
                    help="save the final VO state (.npz, dvo_tpu's keys) here (mono mode)")
    ap.add_argument("--ba", action="store_true",
                    help="run windowed bundle adjustment on every keyframe "
                         "promotion (mono mode)")
    ap.add_argument("--ba-window", type=int, default=4,
                    help="BA window size in keyframes (<= history capacity)")
    ap.add_argument("--ba-iters", type=int, default=5,
                    help="BA Gauss-Newton iterations per window")
    ap.add_argument("--pose-graph", action="store_true",
                    help="global pose-graph refinement over the keyframe "
                         "trajectory at sequence end (odometry + BA-window + "
                         "re-tracked loop-closure constraints; mono mode)")
    ap.add_argument("--pose-graph-every", type=int, default=0,
                    help="with --pose-graph: additionally refine every K "
                         "keyframe promotions and write the corrections "
                         "back into the live keyframe ring, so mid-run "
                         "drift repairs the mapping geometry as it happens "
                         "(0 = refine only at sequence end)")
    ap.add_argument("--plot", default=None,
                    help="write a trajectory PNG (needs matplotlib)")
    ap.add_argument("--gallery", default=None,
                    help="write the final keyframe-ring gallery PNG (mono mode)")
    ap.add_argument("--trace", default=None,
                    help="write a torch.profiler Chrome trace of the whole run into this "
                         "directory (trace.json)")
    ap.add_argument("--stream", action="store_true",
                    help="live mode (reference USE_CAMERA, main.cpp:10,26-30): "
                         "watch --data for new PNGs and odometrize them as "
                         "they appear; the TUM file is appended live")
    ap.add_argument("--stream-idle", type=float, default=5.0,
                    help="stop streaming after this many seconds without a new frame")
    return ap


@contextlib.contextmanager
def _trace(directory: str, cuda: bool, deferred: bool = False):
    """A ``torch.profiler`` capture written to ``directory/trace.json``:
    from the start of the block, or, ``deferred``, from the first call of
    the function the block is given (a runner's ``trace_begin``: a step
    with BA must not be captured while a profiler records, so such a run is
    traced from its first chunk's end) to the end of the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(directory, exist_ok=True)
    prof = profile(activities=activities)
    started = []

    def begin():
        if not started:
            prof.start()
            started.append(True)

    if not deferred:
        begin()
    try:
        yield begin
        if cuda and started:
            torch.cuda.synchronize()
    finally:
        if started:
            prof.stop()
    if started:
        prof.export_chrome_trace(os.path.join(directory, "trace.json"))


def main(argv=None):
    args = _parser().parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (torch.cuda.is_available() is "
                         "False); pass --device cpu to run the plain versions")
    device = torch.device(args.device)
    if args.device == "cuda":
        # Pose math in full float32 (TF32 keeps ~3 digits).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.utils.datasets import (
        Calibration,
        EuRoCSequence,
        InfoSequence,
        KinectCalibration,
        TUMSequence,
    )
    from dvo_tpu_torch.utils.metrics import MetricsLogger
    from dvo_tpu_torch.utils.runner import run_kinect, run_monocular, run_rgbd
    from dvo_tpu_torch.utils.trajectory import ate_rmse, read_tum, write_tum

    metrics = MetricsLogger(args.metrics)
    # mono estimates depth up to scale: ATE with Umeyama scale alignment
    # there (the kinect modes carry metric depth).
    ate_with_scale = args.mode == "mono" and args.format != "kinect"
    cfg_mono = DVOConfig.monocular()
    if args.ba:
        cfg_mono = dataclasses.replace(
            cfg_mono, ba=dataclasses.replace(cfg_mono.ba, enabled=True, window=args.ba_window,
                                             iterations=args.ba_iters))
    trace_ctx = (_trace(args.trace, args.device == "cuda",
                        deferred=args.ba and args.device == "cuda" and not args.stream)
                 if args.trace else contextlib.nullcontext())

    if args.stream:
        if args.mode != "mono" or args.format != "info":
            raise SystemExit("--stream supports --mode mono --format info")
        from dvo_tpu_torch.utils.stream import run_stream, watch_directory

        calib = Calibration.from_yaml(args.calib) if args.calib else Calibration.logicool()
        with trace_ctx:
            ts, poses, secs = run_stream(
                watch_directory(args.data, idle_timeout_s=args.stream_idle),
                calib, cfg_mono, seed=args.seed, undistort=not args.no_undistort,
                trajectory_out=args.out, verbose=args.verbose, device=device,
            )
        metrics.close()
        print(json.dumps({
            "frames": len(ts),
            "fps": round(float(1.0 / np.median(secs)), 2) if len(secs) else None,
            "trajectory": args.out,
            "streamed": True,
        }))
        return 0

    if args.format == "kinect":
        seq = InfoSequence(os.path.join(args.data, "info.txt"))
        kcal = (KinectCalibration.from_yaml(args.calib) if args.calib
                else KinectCalibration.kinect_v2())
        with trace_ctx as trace_begin:
            ts, poses, secs = run_kinect(
                seq, kcal, cfg=cfg_mono if args.mode == "mono" else None, mode=args.mode,
                max_frames=args.max_frames, undistort=not args.no_undistort,
                verbose=args.verbose, metrics=metrics, chunk=args.chunk,
                gray_cull=args.kinect_gray_cull, device=device, trace_begin=trace_begin,
            )
    else:
        if args.format == "euroc":
            if args.mode != "mono":
                raise SystemExit("EuRoC sequences are monocular; use --mode mono")
            seq = EuRoCSequence(args.data)
            calib = Calibration.from_yaml(args.calib) if args.calib else Calibration.euroc_cam0()
        elif args.format == "tum":
            seq = TUMSequence(args.data)
            calib = (Calibration.from_yaml(args.calib) if args.calib
                     else Calibration.tum_freiburg1())
        else:
            seq = InfoSequence(os.path.join(args.data, "info.txt"))
            calib = Calibration.from_yaml(args.calib) if args.calib else Calibration.logicool()
        with trace_ctx as trace_begin:
            if args.mode == "mono":
                ts, poses, secs = run_monocular(
                    seq, calib, cfg_mono, seed=args.seed, max_frames=args.max_frames,
                    undistort=not args.no_undistort, verbose=args.verbose, metrics=metrics,
                    checkpoint_out=args.checkpoint, gallery_out=args.gallery,
                    pose_graph=args.pose_graph, pose_graph_every=args.pose_graph_every,
                    chunk=args.chunk, device=device, trace_begin=trace_begin,
                )
            else:
                ts, poses, secs = run_rgbd(
                    seq, calib, DVOConfig.rgbd(), max_frames=args.max_frames,
                    undistort=not args.no_undistort, verbose=args.verbose, metrics=metrics,
                    chunk=args.chunk, device=device,
                )

    metrics.close()
    write_tum(args.out, ts, poses)
    if args.plot:
        from dvo_tpu_torch.utils.viz import plot_trajectory

        plot_trajectory(poses, args.plot, gt=read_tum(args.gt)[1] if args.gt else None)
    report = {
        "frames": len(ts),
        "fps": round(float(1.0 / np.median(secs)), 2) if len(secs) else None,
        "trajectory": args.out,
    }
    if args.chunk and len(ts) < 5 * args.chunk:
        # With few chunks the median per-frame wall still carries the first
        # chunk's one-time costs.
        report["note"] = (
            "short run: fps includes the first chunk's one-time costs (on a CUDA card: "
            "context creation and the nvcc build of the kernels at first use); "
            "steady-state throughput needs >= 5 chunks"
        )
    if args.gt:
        gt_t, gt_xyz = read_tum(args.gt)
        report["ate_rmse_m"] = round(
            ate_rmse(ts, poses[:, :3, 3], gt_t, gt_xyz, with_scale=ate_with_scale), 4)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
