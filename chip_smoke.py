#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dvo_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one line each (or a few):
  1. device   — the card's name and power limit (nvidia-smi); TF32 off.
  2. build    — compile ``dvo_tpu_torch/csrc/*.cu`` with nvcc (first use).
  3. kernels  — each kernel against its plain PyTorch version on the card,
                on inputs from a real run at the paths' shapes (the mono
                states come from runs on the CPU with the plain versions,
                moved to the card: no kernel under test made them): the GN step
                (``gn``) and the GN level loop (``gn_level``: its launch
                shape from the kernel's C entries against
                ``gn_level.launch_shape``; xi, statistics,
                equal ``iterations`` and counts, the same bits on a second
                run, a level with no valid pixel; timed against the plain
                loop and the stepwise loop, one ``gn`` launch per step) at
                30x40, 60x80 and 120x160 (mono) and at 27x32, 53x64, 106x128
                and 212x256 (RGB-D); epipolar with the full 8-slot ring at
                120x160, both entries (the fused one against
                ``epipolar_fields`` + ``epipolar_update_plain``, the fields one
                against ``epipolar_update_plain``: maps, ages, all counts, the
                same bits on a second run, whether bit-identical; timed
                against the plain version and against fields + the fields
                entry), and once more on a state early in the run (ring not
                full, some pixels aged out); the same kernel built with 4, 8,
                16 and 32 lanes a pixel, one line each; regularize (its
                launch from the C entries against ``regularize.LAUNCH``,
                ``torch.equal`` to the plain version, then every launch of
                ``tools/regularize_sweep`` held bitwise and timed, at
                120x160, 106x128 and on synthetic maps at 212x256 and
                37x53, beside the launch floor); the
                regularize-and-cull launch (``torch.equal`` on every level of
                both pyramids, timed against the three launches it replaces);
                and the frame build (held equal with ``torch.equal``) for the
                RGB-D build and one plane at 212x256 x 4 levels and, at
                120x160 x 3, the mono tracking build, a build with depth, the
                depth/sigma pair and one plane.  All of it but the RGB-D part
                again at Kinect mono's shapes (106x128 x 3), on a
                ``monocular_init_with_depth`` state of the RGB-D frames run
                until its ring is full.  Then the gate census of the depth
                update on this rig (``gate_census``: which observation gate
                rejects each pixel first, on the plain version) and the
                analytic rig (``render_planes``: textured planes at known
                depths rendered per view by ray-plane intersection; the first
                keyframe with the true depth): its accepted observations per
                depth update over PLANE_FRAMES frames, and both epipolar
                entries, the regularize-and-cull launch and the frame builds
                held and timed on it.  Call times from CUDA events, device
                times from ``torch.profiler``; each kernel's bound from its
                ``work()`` on these inputs, and its launch floor: an empty
                launch and a copy of its bytes (``csrc/floor.cu``).
     stable   — how far float noise steers a monocular rig (ROADMAP queue
                C, v): the mono path on ``render`` + the first keyframe at
                frame 0's true depth (STABLE_RIG) and on ``render_planes``,
                each run with the shipped ``gn_level`` launch shapes, with
                ``gn_level.cu`` built with every shape at the shipped ones
                (bitwise equal) and at another shape on every level (8 <-> 16
                blocks): pose difference and decisions over the first
                STABLE_FRAMES frames (held for STABLE_RIG) and over the run
                (printed).
  4. main     — ``monocular_init`` + ``monocular_run`` with
                ``DVOConfig.monocular()`` on 48 synthetic 640x480 uint8
                frames (chunks of 24), through the graphed step driver
                (``models/graphed``: one CUDA graph per run, captured by an
                untimed chunk from the same first state, replayed per frame);
                then the eager step loop twice and the graphed run again (A,
                B, B, A), every run's poses bitwise equal to the first's;
                the level kernel's device us a frame by level (a
                ``torch.profiler`` window of the graphed run), its steps a
                frame by level and its bound on those steps;
                every kernel of the path must have
                launched: per frame ``gn_level`` three times, the frame build,
                the regularize-and-cull launch and epipolar once (both mapping
                branches are enqueued on every frame), ``regularize`` never.  Then the same
                run with the mapper on its fields route (the 24 field planes
                prepared in PyTorch ops and handed to the kernel's fields
                entry; the reference rebuilt by three launches), twice, and
                on the fused route again (A, B, B, A): ms/frame, device ops
                per frame and idle share of each, and one frame that is no
                keyframe profiled on both.  Then the first 24 frames with the
                stepwise GN loop, twice, and with the level kernel again (A,
                B, B, A), as for the routes.
  5. cpu      — the CPU (plain versions, same reset planes) against the
                card: the stable rig's first 8 frames as one trajectory
                (poses within POSE_TOL, keyframe flags equal; STABLE_FRAMES
                printed); the main path's noise-bootstrapped rig frame by
                frame (``tools/step_gate``: the card's state before each of
                the 48 frames, from the eager step loop, copied to the CPU and
                stepped there with the card's tracking, and with its own where
                the card's GN converged at every level; ``T_world`` within
                POSE_TOL, the decision equal, the reference's depth and sigma
                within MAP_VALUE_TOL on MAP_SHARE of the pixels), its whole
                trajectory against the CPU's printed.
  6. rgbd     — ``rgbd_init`` + ``rgbd_run_raw`` with ``DVOConfig.rgbd()``
                on 64 synthetic 512x424 frames (uint8 gray, uint16 depth
                counts with holes) in one chunk, graphed, against the eager
                step loop as in phase 4; every twist must recover the
                step; ``gn_level`` (four per frame) and the frame build must
                have launched, the level kernel's device us and steps a frame
                by level as in phase 4; the first 8 frames again on the CPU
                must agree.  Then A, B, B, A and the profiles as in phase 4.
  7. monodepth — ``monocular_init_with_depth`` + ``monocular_run`` on 12
                640x480 frames; the path's four kernels must have launched.
  8. syncs    — host syncs per frame under ``set_sync_debug_mode`` in a
                run's second chunk, after its graph was captured in the
                first: none on the RGB-D path and none over 24 mono frames
                (the keyframe decision stays on the device); one capture per
                run, counted apart with the syncs of the chunk that captured.
     graphs   — one ``monocular_step`` (no BA; on the stable rig, from its
                first promotion past 24 frames) and one ``rgbd_step`` captured
                in a CUDA graph (capture raises on a host sync) and replayed
                on six frames each, every replay equal bitwise to the eager
                step on the same inputs; the launch counters count the
                captured kernels per replay; ms per replay against the eager
                step in turns, device ops and device-busy us of a replay.
     streams  — ``monocular_init_batched`` + ``monocular_run_batched`` on
                4 streams of 24 640x480 frames (own texture, motion and focal
                length each, per-stream K, two chunks), and
                ``rgbd_run_batched`` on 4 RGB-D streams: every stream bitwise
                equal to its own single-stream run (concurrent replays on
                separate CUDA streams must not race), launches 4 times the
                single-stream path's, one capture per stream.  Then the
                scaling turns B = 1, 2, 4, 8, 16, 16, 8, 4, 2, 1 (mono, 24
                frames a stream): aggregate frames/s of a chunk that only
                replays, device-busy ms of a 4-frame chunk, peak device
                memory.
     parallel — ``dvo_tpu_torch.parallel``: ``monocular_run_streams`` and
                ``rgbd_run_streams`` on a one-rank NCCL group over a
                ``stream`` mesh, bitwise equal to the batched drivers.
     sharded  — the sharded solvers (``parallel.{tracking,mapping,ba}``).
                First, on one card without collectives, ``gn.cu`` on 2 and
                4 row blocks (nonzero row offsets) of the mono frame's
                120x160 and 60x80 levels, of the step's 120x160 level and of
                a 212x256 level (RGB-D shapes), each block against its plain
                version, equal bitwise to a second launch, and the blocks'
                sums against the whole-image launch (rtol 1e-5, atol 1e-4,
                the count exact); the fused epipolar entry on 2 and 4 row
                blocks of the analytic rig, each block equal bitwise to the
                whole launch's rows, its counts adding up; ``gn.cu`` timed
                on the 30x160 and 106x256 blocks (one launch, and the
                ``gn_terms`` call) beside its bound and the launch floor, a
                30x160 epipolar block timed; the step kernel against its
                plain version (step 0, step 1, a frozen step, no valid
                pixel, no Cholesky factor).  Then
                ``__graft_entry__.dryrun_multichip``'s step
                (``sharded_track`` at 120x160 x 3 levels,
                ``sharded_depth_update`` against a 4-slot ring at a 0.2 m
                offset, ``bundle_adjust_sharded`` over a window of 7 at
                212x256, 2 iterations) and ``sharded_track`` on a 212x256 x
                4 pair with ``DVOConfig.rgbd()``'s tracker, on a one-rank
                NCCL group: both tracks within rtol 1e-4 atol 2e-5 of
                ``track`` (the level kernel) and of the stepwise track and
                equal bitwise over two calls, ``gn`` once per GN step and
                ``gn_step`` once per GN step and once per sharded level (its
                seed), at most 3 device ops a GN step, no host sync in the
                tracking loop, mapping and BA equal bitwise to the
                single-device port; the tracking part on the eager loop
                (``eager_sharded_track_level``: ``gn_iteration`` fed
                ``gn.cu``, ~250 ops a step) and on the
                card's route in turns (A, B, B, A); and in 4
                processes on this card in a gloo group on a (kf 2, tile 2)
                mesh (this script started with ``--sharded-rank``), every
                rank equal, held against the single-device port (tracks
                rtol 1e-4 atol 2e-5, the maps bitwise, BA twists 1e-3 and
                costs 5e-3): ms per part and the launches of every rank.
                With four cards, the same step on NCCL through ``torchrun
                --nproc-per-node 4``.
  9. cli      — ``python -m dvo_tpu_torch.run`` (its ``main``, in this
                process) on PNG sequences written from the frames above with
                a zlib writer, and calibration YAMLs: RGB-D (the 64 frames of
                phase 6, ``--chunk 24``), mono (the 48 frames of phase 4,
                ``--chunk 24 --checkpoint``) and Kinect in both modes (8
                pairs of 1920x1080 color and 512x424 depth, ``--chunk 3``).
                Prints the decode route and, per path, ms/frame with the wall
                split into decode (the time the runner waits for its next
                frame) and dispatch/drain; on RGB-D, mono and Kinect RGB-D the
                PIL route's pool against decoding on the calling thread, in
                turns.  Requires finite poses
                and the launches of each path's kernels; the RGB-D poses
                within 1e-5 of ``rgbd_init`` + ``rgbd_run_raw`` on the same
                frames; the reloaded checkpoint's next step equal to the live
                state's; no host sync inside an RGB-D chunk's dispatch; the
                Kinect RGB-D poses within 5e-3 of the RGB-D CLI's; each Kinect
                mode's first 5 frames (one chunk and a tail) within 1e-5 of
                the same command with ``--device cpu``, both fed the same
                reset planes.  Then ``--trace``, ``--gallery`` and ``--stream``
                once each on the card (8 mono frames): the trace file must
                exist, the gallery PNG must have the ring's size, the stream
                must odometrise every frame of the directory.
 10. ba       — the mono path of phase 4 with ``cfg.ba`` on (window 4, 5
                iterations: the CLI's defaults): poses, keyframes and
                ``ba_cost`` of the stable rig's first 24 frames against the
                CPU's (the noise-bootstrapped rig's printed), and each of
                the noise-bootstrapped rig's steps that runs a
                ``bundle_adjust`` against the same step on the CPU from the
                card's state (``tools/step_gate`` at BA_SOLVE_TOL); every
                promotion with a full window has a finite ``ba_cost`` >= 0
                and ``ba_window_xi`` is (4, 6); the launches are exactly the
                mono path's; over six frames that hold a solve, no host sync
                (BA is an IF node of the captured step), one condition
                launch and one BA region a frame, a ``ba`` stage marker
                once a solve; device ops, device-busy and wall ms of one ``bundle_adjust`` with the targets batched
                and with the literal double loop; the run with and without BA
                in turns (A, B, B, A).
 11. posegraph — ``optimize_pose_graph_padded`` on a drifting circle with
                closures on the card against the CPU; then the CLI with ``--ba
                --pose-graph --pose-graph-every 4`` (``--chunk 24`` and
                ``--chunk 0``) on a 49-frame mono PNG sequence that goes out
                and comes back over its own frames, so that loop closures
                exist: finite poses, the graph's node, edge and closure
                counts, the closure re-tracks' launches counted exactly.
``python3 chip_smoke.py --back-end`` runs phases 1, 2, 10 and 11 only (a
shorter call while working on the back end; it prints no result line);
``--streams`` runs phases 1, 2 and streams only (for the scaling turns under
another environment, e.g. ``CUDA_DEVICE_MAX_CONNECTIONS=32``; no result
line); ``--sharded`` runs phases 1, 2 and the sharded step only (on a
machine with four cards its NCCL run too; no result line); ``--pose`` runs
phases 1, 2 and pose only and prints the pose rows as its JSON line.
     pose     — ``csrc/pose.cu``'s entries (``ops/cuda/pose``) against their
                plain versions on the card at the main path's shapes (a
                ring of 8): POSE_DRAWS draws of twists as a run makes them
                (and the warm start's gate on both sides, both promotion
                branches), each bitwise the plain version's (and so within
                ENTRY_TOL * max(1, |plain|)), the same bits on a second
                launch; device us and ops of a
                launch, call ms of the launch and of the plain version, the
                plain version's device ops, the bound, the launch floor.
                Every path below launches the pose entries (``pose`` in
                MONO_KERNELS, RGBD_KERNELS): 3 a mono frame, 2 an RGB-D
                frame on the main paths.
Each path's launch counts are set to 0 just before it runs and read just
after.  Then a JSON line of per-kernel results and, last, the device JSON
line.  Any failure raises (exit code != 0) before the last line is printed.
It imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
import zlib
from types import SimpleNamespace

import numpy as np
import torch

SEED = 0
N_FRAMES = 48           # frames after the first (keyframe) one
CHUNK = 24
CPU_FRAMES = 8
STEPWISE_FRAMES = 24    # frames of the stepwise-GN yardstick runs (one chunk)
H, W = 480, 640
STEP_XI = (0.014, 0.004, 0.006, 0.001, -0.002, 0.001)  # per-frame motion
# RGB-D: Kinect v2 depth resolution, culled once by DVOConfig.rgbd() to a
# 256x212 base with 4 levels.
RGBD_FRAMES = 64        # frames after the first one, in one chunk
RH, RW = 424, 512
RGBD_STEP = (0.004, -0.002, 0.002, 0.001, -0.0015, 0.0005)
DEPTH_SCALE = 5000.0    # TUM counts per metre
HOLES = 0.03            # share of pixels without a depth measurement
NOISE = 0.06            # gray sensor noise (std): GN then iterates as on real frames
MONO_DEPTH_FRAMES = 12
SYNC_FRAMES = 4
CLI_CHUNK = 24          # the CLI's default --chunk
KINECT_FRAMES = 8       # Kinect pairs: 1920x1080 color, 512x424 depth
KINECT_CHUNK = 3        # 7 steps: two chunks and a one-frame tail
KINECT_CPU_FRAMES = 5   # the Kinect CLI on the CPU: one chunk and a one-frame tail
KINECT_WARM = 8         # frames per run while the Kinect-mono ring fills
EARLY_FRAMES = 6        # the mono run whose ring is not full yet (2 promotions)
# The stable monocular rig (ROADMAP queue C, v): render's frames, the first
# keyframe at frame 0's true depth (monocular_init_with_depth, as the
# monodepth phase starts).  No monocular rig is stable for long: the depth
# update's gates and BA's are discrete, and a pixel that an ulp flips (a
# fusion that becomes a reset) grows over the frames after it.  Rehearsed
# on the CPU, every level's xi moved by 2e-7 relative: this rig first left
# POSE_TOL at frame 14-25 (six noise draws), render_planes' at frame 11-19 or
# not within 32 (six draws), the noise-bootstrapped rig at frame 9 (one).  So
# the whole-trajectory gates at POSE_TOL hold its first STABLE_FRAMES frames
# (the monodepth phase's run), and the per-frame gates
# (dvo_tpu_torch/tools/step_gate.py) hold every frame of the main path.
STABLE_RIG = "render+depth"
STABLE_SIGMA = 0.1      # the first keyframe's depth sigma [m]
STABLE_FRAMES = MONO_DEPTH_FRAMES

# Tolerances of a kernel against its plain version on the card.  Both are
# built to round the same way per pixel (no FMA contraction, IEEE division
# and sqrt); what differs is summation order (GN's block reduction vs
# torch.einsum) and the plain version's batched 3x3 matmuls, which can move
# a warped coordinate by an ulp and so flip a pixel sitting exactly on a
# strict gate.
GN_REL_TOL = 1e-4        # max |dH|, |dg|, |drsum| over the plain value's max
GN_COUNT_TOL = 0.001     # share of pixels whose gate may flip
# The GN level loop against gn_level_plain.  The kernel's pixels round as the
# plain version's; its sums run in another order, its 6x6 Cholesky solve is
# not cuSOLVER's and its 3x3 products are not cuBLAS's, so each step differs
# by float noise, carried through up to 15 steps (measured 3.4e-7 on xi at
# 27x32 over 15 steps that never converge).  ``iterations`` and the valid
# counts must be equal: a step whose update norm sits within float noise of
# the threshold could flip them, and would fail here.
GN_LEVEL_XI_TOL = 5e-6   # max |d xi|
GN_LEVEL_STAT_TOL = 1e-3  # residuals and update norms, over the plain maximum
SLOW_REPS = 5            # timing repeats of the plain loop and the stepwise loop
PROFILE_FRAMES = 4       # frames per torch.profiler window
PROFILE_TRIES = 4        # windows taken before a profile counts as lost
MAP_VALUE_TOL = 1e-5     # per-pixel |d| <= tol * (1 + |d_plain|) ...
MAP_SHARE = 0.999        # ... on at least this share of pixels
STATS_TOL = 0.01         # epipolar counts within 1% (or 2 pixels)
# Measured on an H100 (700 W): GN 3.6e-6 relative with equal counts,
# epipolar and regularize bit-identical to their plain versions.
# CUDA run vs CPU run of the first frames: the GN kernel's summation order
# differs from the CPU's einsum, so poses agree to float noise carried
# through 8 frames of tracking (measured 1.4e-7 on the H100), not bit for bit.
POSE_TOL = 1e-5
# Every RGB-D frame-to-frame twist against the rendered step (|d xi|).  The
# frames are inverse warps of frame 0 with depth0 plus gray noise, tracked
# against the approximate per-frame depth depth0 - k * tz
# (tests/test_odometry.py) with DVOConfig.rgbd()'s 1.5e-3 update-norm gate,
# so the bound comes from a measured error, not from float noise: the first
# 20 frames on the CPU missed the step by at most 2.0e-3 (median 1.0e-3).
STEP_TOL = 5e-3
# The Kinect RGB-D CLI against the plain RGB-D CLI on the same frames: the
# registration lands on the depth view's own pixels, so what differs is the
# depth holes, which the Kinect path masks out of the gray (measured 8.1e-4
# on the H100).  Held to the rendered-step bound.
KINECT_GAP_TOL = STEP_TOL
# The back end.  One bundle_adjust on the same window differs between the
# card and the CPU by far more than float noise: a projected coordinate that
# moves by an ulp flips a pixel across a validity or Huber gate, and on
# depths grown from the noise bootstrap thousands of pixels sit near one
# (measured on the H100: 3.5e-4 on the twists of a solve that moves them by
# 1.8e-3, costs within 1.1e-3; batched against looped targets, whose pixels
# round alike, 6.5e-6).  Through the ring's depths that feeds the next
# promotions: CUDA vs CPU poses 1.4e-6 before the first BA, 1.4e-5 at it,
# 1.0e-3 at the second, 1.1e-2 at the third (the same digits in two calls).
BA_WINDOW, BA_ITERS = 4, 5   # python -m dvo_tpu_torch.run --ba's defaults
BA_CPU_FRAMES = 24
BA_FIRST_TOL = 1e-3          # poses up to the frame before the second (1.7e-4 measured)
BA_POSE_TOL = 5e-2           # poses over all BA_CPU_FRAMES frames
BA_SOLVE_TOL = 2e-3          # one bundle_adjust, card vs CPU and batched vs loop
BA_SYNC_FRAMES = 6
PG_EVERY = 4                 # --pose-graph-every in the posegraph phase
# The pose-graph solve on the card against the CPU.  The costs agree to four
# digits; the twists differ by 1.7e-3 (measured): once the cost is on its
# plateau a step is accepted or rejected on float noise, and the accepted
# ones move along the graph's weakly constrained directions.
PG_XI_TOL = 5e-3
PG_COST_TOL = 1e-2           # final cost, relative
# The CLI's chunked path against its per-frame path with --ba --pose-graph,
# over the first CPU_FRAMES frames (before the first BA promotion), at the
# tolerance tests/test_runner.py holds dvo_tpu's pair to.  Later frames are
# printed: the two paths normalise gray with different roundings, and BA
# amplifies that as it does the card-vs-CPU difference above.
PG_CLI_TOL = 5e-3
PG_CLI_ALL_TOL = 2e-2        # over all frames (5.6e-3 measured)
EXTRA_FRAMES = 8             # frames of the --trace/--gallery/--stream runs
DECODE_THREADS = (8, 4, 2, 1)  # PIL decode threads the cli phase compares
# The regulariser's sweep also on maps of these shapes (regularize_sweep.maps):
# one no path gives it, and one with partial warps and blocks.
REGULARIZE_SHAPES = ((212, 256), (37, 53))
# csrc/pose.cu against ops/cuda/pose's plain versions: elementwise within
# ENTRY_TOL * max(1, |plain|), and on these draws bit for bit.  The kernel
# rounds its products and sums as the library rounds the plain version's
# batched matmuls and reductions on this card (csrc/pose.cu's note); the
# monocular mapper follows float noise, so the benchmark's judge, whose
# reference computes as the plain version does, needs the same bits.
ENTRY_TOL = 4e-6
POSE_DRAWS = 64


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn, calls: int = 1, whole: bool = False):
    """``fn()`` ``calls`` times under ``torch.profiler``: (device ops per
    call, device-busy microseconds per call), from the CUDA-side events
    (kernels, copies and memsets).  The profiler can lose the window's first
    event, and now and then a few more or a whole window.  With ``whole`` (a
    call that issues the same ops every time) the events are therefore
    counted by name: an op's count per call is its events over ``calls``,
    rounded, and its time that count times its mean event — a lost event
    moves neither.  A window that lost more than one event in twenty is taken
    again, up to PROFILE_TRIES times, and the fullest window is used; only a
    run of empty windows fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    best = []
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        best = max(best, events, key=len)
        expected = -(-len(events) // calls) * calls
        if events and (not whole or len(events) >= expected - expected // 20):
            break
    if not best:
        raise AssertionError(f"torch.profiler showed no device event in {PROFILE_TRIES} windows")
    if not whole:
        return len(best) / calls, sum(e.time_range.elapsed_us() for e in best) / calls
    by_name = {}
    for e in best:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    ops, busy_us = 0, 0.0
    for durations in by_name.values():
        per_call = int(len(durations) / calls + 0.5)
        ops += per_call
        busy_us += per_call * statistics.mean(durations)
    return ops, busy_us


def gn_level_per_frame(fn, frames, levels, iterations, valid_counts, shapes, max_iterations):
    """The level kernel on a path: ``fn()`` runs ``frames`` frames whose
    tracker makes ``levels`` ``gn_level`` launches each, coarse to fine and
    back to back.  Under ``torch.profiler`` the device events are ordered by
    start; a frame's launches are a run of ``levels`` consecutive
    ``gn_level`` kernels, and a run that lost an event is left out (the
    profiler loses a few).  ``iterations`` (frames, levels) and
    ``valid_counts`` (frames, levels, max_iterations) are the run's
    ``tracking`` fields, ``shapes`` the levels' (h, w).  Returns, per level:
    the device us a frame, the steps a frame and the us a step; and the
    bound a frame (``gn_level.work()`` on the steps that ran), the frames
    timed and the device-busy us a frame of the whole path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dvo_tpu_torch.ops.cuda import _build, gn_level

    fn()
    runs, busy = [], 0.0
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        runs, run = [], []
        for e in events + [None]:
            if e is not None and "gn_level_kernel" in e.name:
                run.append(e.time_range.elapsed_us())
                continue
            if run and len(run) % levels == 0:
                runs += [run[i:i + levels] for i in range(0, len(run), levels)]
            run = []
        busy = sum(e.time_range.elapsed_us() for e in events) / frames
        if len(runs) >= frames - frames // 20:
            break
    if not runs:
        raise AssertionError(f"torch.profiler showed no whole frame of {levels} gn_level "
                             f"launches in {PROFILE_TRIES} windows")
    us = [statistics.mean(r[lv] for r in runs) for lv in range(levels)]
    steps = iterations.double().mean(0).tolist()
    bound = 0.0
    for f in range(iterations.shape[0]):
        for lv in range(levels):
            n = int(iterations[f, lv])
            bound += _build.bound_us(*gn_level.work(shapes[lv], valid_counts[f, lv, :n].tolist(),
                                                    max_iterations))[0]
    return dict(device_us_by_level=us, steps_by_level=steps,
                us_per_step_by_level=[u / max(s, 1e-9) for u, s in zip(us, steps)],
                device_us_per_frame=sum(us), steps_per_frame=sum(steps),
                bound_us_per_frame=bound / iterations.shape[0], frames_timed=len(runs),
                shapes=["x".join(map(str, sh)) for sh in shapes],
                device_busy_us_per_frame=busy)


def level_shapes(h, w, levels):
    """The (h, w) of each pyramid level of an (h, w) base, coarse to fine."""
    return [((h + (1 << k) - 1) >> k, (w + (1 << k) - 1) >> k) for k in range(levels - 1, -1, -1)]


def gn_level_on_path(name, fn, outs, base, levels, max_iterations):
    """``gn_level_per_frame`` on a graphed path's run ``fn`` whose chunk
    results are ``outs``; prints the phase's line.  ``base`` is the (h, w)
    the tracker's finest level has."""
    its = torch.cat([r.tracking.iterations for r in outs]).cpu()
    counts = torch.cat([r.tracking.valid_counts for r in outs]).cpu()
    out = gn_level_per_frame(fn, its.shape[0], levels, its, counts, level_shapes(*base, levels),
                             max_iterations)
    phase(name, "gn_level per frame by level (" + ", ".join(out["shapes"]) + "): device us "
          + ", ".join(f"{u:.2f}" for u in out["device_us_by_level"]) + "; steps "
          + ", ".join(f"{v:.2f}" for v in out["steps_by_level"]) + "; us a step "
          + ", ".join(f"{v:.2f}" for v in out["us_per_step_by_level"])
          + f"; {out['device_us_per_frame']:.2f} us in {out['steps_per_frame']:.2f} steps a "
            f"frame, bound {out['bound_us_per_frame']:.3f} us, of {out['device_busy_us_per_frame']:.1f} "
            f"device-busy us a frame ({out['frames_timed']} frames timed)")
    return out


def with_bound(entry, nbytes, flops):
    """Adds the work of one call and the card's bound for it to a kernel's
    entry: the larger of bytes over the memory rate and operations over the
    float32 peak (``_build.bound_us``); no single PyTorch call computes any
    of these functions, so ``library_ms`` is null."""
    from dvo_tpu_torch.ops.cuda import _build

    us, by = _build.bound_us(nbytes, flops)
    entry.update(bytes=nbytes, flops=flops, bound_us=us, bound_ms=us / 1e3, bound_by=by,
                 library_ms=None)
    if "device_us" in entry:
        entry["device_over_bound"] = entry["device_us"] / us
    return entry


def texture(rng, h, w, terms=8, lo=0.04, hi=0.2):
    """A sum of random sinusoids, normalised to [0, 1]."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(terms):
        fx, fy = rng.uniform(lo, hi, 2)
        ph = rng.uniform(0, 6.28, 2)
        img += rng.uniform(0.5, 1.0) * np.sin(fx * xs + ph[0]) * np.sin(fy * ys + ph[1])
    return (img - img.min()) / (img.max() - img.min())


def smooth_field(rng, h, w):
    """A slowly varying field of about [-4, 4] (a sum of four products of
    low-frequency sines)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    smooth = np.zeros((h, w), np.float32)
    for _ in range(4):
        fx, fy = rng.uniform(0.002, 0.01, 2)
        smooth += np.sin(fx * xs + rng.uniform(0, 6.28)) * np.sin(fy * ys + rng.uniform(0, 6.28))
    return smooth


def render(base, depth, K, step, n: int):
    """Frame 0 and ``n`` frames under constant motion ``step``, each the
    port's inverse warp of frame 0 with ``depth``; float gray in [0, 1]."""
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.ops.warp import warp_image

    dev = base.device
    ones = torch.ones(base.shape, dtype=torch.bool, device=dev)
    step = torch.tensor(step, dtype=torch.float32, device=dev)
    xi = torch.zeros(6, dtype=torch.float32, device=dev)
    grays, masks = [base], [ones]
    for _ in range(n):
        xi = lie.compose(xi, step)
        img, mask = warp_image(xi, base, ones, depth, K)
        grays.append(img)
        masks.append(mask)
    return torch.stack(grays), torch.stack(masks)


# The analytic rig (fault k of the earlier rigs: inverse warps of one frame
# with one depth map, whose observations the gates mostly reject): planes at
# known depths in frame 0's coordinates (x right, y down, z forward),
# n . P = h, a bounded one within (x range, y range); rendered per view by
# ray-plane intersection with a texture defined in 3D, so every view is
# consistent with every other.  The scene is near (0.9-1.6 m) and the motion
# mostly sideways, so that a few promotions give a pixel's born keyframe a
# baseline of several centimetres: the sigma the epipolar geometry gives an
# observation (depth^2 / (focal length x baseline) per pixel of segment)
# then passes the 0.5 m gate.  The first keyframe carries the true depth.
PLANE_FRAMES = 40
PLANE_STEP = (0.012, 0.001, 0.002, 0.0, 0.002, 0.0)
PLANE_SIGMA = 0.1       # the first keyframe's depth sigma [m]
PLANES = (
    ((0.0, 0.0, 1.0), 1.6, None),                              # back wall
    ((0.0, 0.0, 1.0), 0.9, ((-0.35, 0.05), (-0.3, 0.25))),     # a box's front
    ((0.0, 1.0, 0.0), 0.45, None),                             # floor
    ((0.958, 0.0, -0.287), 0.096, None),                       # a slanted wall, right
)


def render_planes(device, n=PLANE_FRAMES):
    """``n`` + 1 views of ``PLANES`` under constant motion PLANE_STEP (view
    k's world-to-camera pose exp(xi_k), as ``render``'s), 640x480: uint8
    gray, masks (a plane was hit) and frame 0's depth, on ``device``.  The
    texture is a sum of ten 3D sinusoids of 50-140 rad/m, sharpened by a
    tanh, so that the culled frames have strong gradients."""
    from dvo_tpu_torch import lie

    rng = np.random.default_rng(SEED + 2)
    dirs = rng.normal(size=(10, 3))
    freqs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True) * rng.uniform(50, 140, (10, 1))
    freqs = torch.tensor(freqs, dtype=torch.float64, device=device)
    phases = torch.tensor(rng.uniform(0, 2 * np.pi, 10), dtype=torch.float64, device=device)
    amps = torch.tensor(rng.uniform(0.5, 1.0, 10), dtype=torch.float64, device=device)
    K = torch.tensor([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], device=device)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device),
                            torch.arange(W, dtype=torch.float64, device=device), indexing="ij")
    rays = torch.stack([(xs - 320.0) / 600.0, (ys - 240.0) / 600.0,
                        torch.ones_like(xs)]).reshape(3, -1)
    step = torch.tensor(PLANE_STEP, dtype=torch.float32, device=device)
    xi = torch.zeros(6, dtype=torch.float32, device=device)
    grays, masks, depth0 = [], [], None
    for k in range(n + 1):
        if k:
            xi = lie.compose(xi, step)
        T = lie.se3_exp(xi).double()
        R, t = T[:3, :3], T[:3, 3]
        c = -(R.T @ t)
        dw = R.T @ rays
        best = torch.full((H * W,), float("inf"), dtype=torch.float64, device=device)
        for normal, h, bounds in PLANES:
            nrm = torch.tensor(normal, dtype=torch.float64, device=device)
            nd = nrm @ dw
            s = (h - nrm @ c) / torch.where(nd.abs() < 1e-12, 1e-12, nd)
            ok = s > 1e-6
            if bounds is not None:
                P = c[:, None] + s * dw
                (x0, x1), (y0, y1) = bounds
                ok = ok & (P[0] >= x0) & (P[0] <= x1) & (P[1] >= y0) & (P[1] <= y1)
            best = torch.where(ok & (s < best), s, best)
        hit = torch.isfinite(best)
        P = c[:, None] + torch.where(hit, best, 1.0) * dw
        tex = (amps[:, None] * torch.sin(freqs @ P + phases[:, None])).sum(0)
        gray = 0.5 + 0.5 * torch.tanh(1.5 * tex)
        grays.append(torch.where(hit, gray, 0.0).reshape(H, W).float())
        masks.append(hit.reshape(H, W))
        if k == 0:
            depth0 = torch.where(hit, best, 0.0).reshape(H, W).float()
    return to_uint8(torch.stack(grays)), torch.stack(masks), K, depth0


GATES = ("no observation (crop, object frame, age, segment)", "no match (SSD)",
         "match off the image", "no gradient at the match", "depth out of band",
         "sigma out of band")


def gate_census(args):
    """Which gate rejects each pixel of the crop first, on the plain version
    (``epipolar_fields``, ``march_plain`` and the gates of
    ``epipolar_update_plain`` in their order), and how the observations that
    pass all of them fare in the depth filter.  Returns a dict of counts."""
    from dvo_tpu_torch.models import mapper
    from dvo_tpu_torch.ops.cuda import epipolar as E
    from dvo_tpu_torch.ops.depth_filter import gaussian_update_with_reset

    obj, obj_xi, rel_xi, depth, sigma, age, hist, reset, cfg = args
    f, _ = mapper.epipolar_fields(*args)
    h, w = depth.shape
    best_s, min_ssd = E.march_plain(f, hist.gray, cfg)
    best_o = (best_s + 1).to(torch.float32)
    mx = f[E.F_START_X] + best_o * f[E.F_DIR_X]
    my = f[E.F_START_Y] + best_o * f[E.F_DIR_Y]
    slot = f[E.F_SLOT].long()
    bxi, byi = torch.round(mx).to(torch.int32), torch.round(my).to(torch.int32)
    bxc, byc = torch.clamp(bxi, 0, w - 1).long(), torch.clamp(byi, 0, h - 1).long()
    gxv, gyv = hist.gx[slot, byc, bxc], hist.gy[slot, byc, bxc]
    g_ok = (bxi >= 0) & (bxi < w) & (byi >= 0) & (byi < h) & hist.gmask[slot, byc, bxc]
    r3q, ttz = f[E.F_R3Q], f[E.F_TTZ]
    a = (r3q * mx - f[E.F_KRQ0], r3q * my - f[E.F_KRQ1], r3q - f[E.F_KRQ2])
    b = (ttz * mx - f[E.F_KT0], ttz * my - f[E.F_KT1], ttz - f[E.F_KT2])
    a_dot_a = a[0] * a[0] + a[1] * a[1] + a[2] * a[2]
    new_depth = -(a[0] * b[0] + a[1] * b[1] + a[2] * b[2]) / torch.where(a_dot_a < 1e-20, 1.0,
                                                                          a_dot_a)
    length = f[E.F_LENGTH]
    g_dot_l = torch.abs(gxv * (-f[E.F_DIR_X]) + gyv * (-f[E.F_DIR_Y]))
    epi = torch.full_like(g_dot_l, cfg.epipolar_sigma ** 2) / torch.clamp(g_dot_l * g_dot_l,
                                                                          min=E.EPS)
    lum = torch.full_like(g_dot_l, 2.0 * cfg.luminance_sigma ** 2) / torch.clamp(
        g_dot_l / length, min=E.EPS)
    new_sigma = (f[E.F_DMAX] - f[E.F_DMIN]) / length * torch.sqrt(epi + lum)
    gates = (f[E.F_BASE_OK] > 0.5,
             min_ssd <= cfg.ssd_window * cfg.matching_threshold_ratio,
             (mx >= 0) & (my >= 0) & (mx <= w) & (my <= h),
             g_ok,
             (new_depth > cfg.accept_depth[0]) & (new_depth < cfg.accept_depth[1]),
             (new_sigma > cfg.accept_sigma[0]) & (new_sigma < cfg.accept_sigma[1]))
    xs = torch.arange(w, device=depth.device)[None, :]
    ys = torch.arange(h, device=depth.device)[:, None]
    alive = ((xs >= cfg.crop_x[0]) & (xs <= cfg.crop_x[1]) & (ys >= cfg.crop_y[0])
             & (ys <= cfg.crop_y[1])).expand(h, w)
    out = {"crop_pixels": int(alive.sum())}
    for name, gate in zip(GATES, gates):
        out[name] = int((alive & ~gate).sum())
        alive = alive & gate
    _, _, accepted = gaussian_update_with_reset(f[E.F_PRIOR_D], f[E.F_PRIOR_S], new_depth,
                                                new_sigma, f[E.F_RESET_D], obs_valid=alive,
                                                cfg=cfg.depth_filter)
    out["observed"] = int(alive.sum())
    out["accepted"] = int(accepted.sum())
    out["rejected by the filter"] = out["observed"] - out["accepted"]
    return out


def to_uint8(grays):
    return torch.clamp(torch.round(grays * 255.0), 0, 255).to(torch.uint8)


def render_sequence(device):
    """N_FRAMES + 1 frames of a static textured scene under constant small
    motion, rendered with the port's inverse warp; uint8, 640x480.  Also
    returns frame 0's depth."""
    rng = np.random.default_rng(SEED)
    base = texture(rng, H, W)
    depth = (1.5 + 0.1 * smooth_field(rng, H, W)).astype(np.float32)
    K = torch.tensor([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], device=device)
    depth_t = torch.from_numpy(depth).to(device)
    grays, masks = render(torch.from_numpy(base).to(device), depth_t, K, STEP_XI, N_FRAMES)
    return to_uint8(grays), masks, K, depth_t


def render_rgbd(device):
    """RGBD_FRAMES + 1 frames at 512x424, shipped as a sensor would: uint8
    gray with NOISE and uint16 depth counts (DEPTH_SCALE per metre) with
    HOLES of the pixels at 0, all on the host.  Frame k's depth is
    depth0 - k * tz."""
    rng = np.random.default_rng(SEED + 1)
    base = texture(rng, RH, RW, 12, 0.1, 0.5)
    depth0 = (1.8 + 0.1 * smooth_field(rng, RH, RW)).astype(np.float32)
    K = torch.tensor([[365.0, 0, 256.0], [0, 365.0, 212.0], [0, 0, 1]])
    grays, masks = render(torch.from_numpy(base).to(device), torch.from_numpy(depth0).to(device),
                          K.to(device), RGBD_STEP, RGBD_FRAMES)
    noise = rng.standard_normal(grays.shape, dtype=np.float32) * np.float32(NOISE)
    grays = grays + torch.from_numpy(noise).to(device)
    k = np.arange(RGBD_FRAMES + 1, dtype=np.float32)[:, None, None]
    depths = depth0[None] - k * np.float32(RGBD_STEP[2])
    counts = np.round(depths * DEPTH_SCALE).astype(np.uint16)
    counts[rng.random(counts.shape) < HOLES] = 0
    return to_uint8(grays).cpu(), masks.cpu(), torch.from_numpy(counts), K


def _flat(out):
    """The tensors of a frame-build output (lists, tuples, per-level dicts)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _flat(v)]
    return []


def check_framebuild(label, wrapper, plain, *args):
    """The kernel's planes against the plain version's, with torch.equal.
    Returns (max abs error, kernel ms, plain ms)."""
    got, want = _flat(wrapper(*args)), _flat(plain(*args))
    torch.cuda.synchronize()
    if len(got) != len(want) or not got:
        raise AssertionError(f"framebuild {label}: {len(got)} planes vs {len(want)}")
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"framebuild {label}: plane {i} differs from the plain version")
        if a.is_floating_point():
            err = max(err, (a - b).abs().max().item())
    ms = timed(lambda: wrapper(*args))
    plain_ms = timed(lambda: plain(*args))
    phase("kernels", f"framebuild {label}: {len(got)} planes equal, "
                     f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def check_gn(obj_scenes, ref_scenes, T_inv, cfg, gn_times, tag=""):
    """GN kernel vs plain at every level; fills gn_times[tag + shape] and
    returns (max abs error, max relative error, the work() of each call by
    shape, from its own valid count)."""
    from dvo_tpu_torch.ops.cuda import gn

    gn_err, gn_rel, work = 0.0, 0.0, {}
    for level, (obj, ref) in enumerate(zip(obj_scenes, ref_scenes)):
        args = (obj.gray, obj.mask, ref.depth, ref.sigma, ref.gray, ref.mask,
                ref.gx, ref.gy, ref.gmask, ref.K, T_inv, level, cfg)
        got = gn.gn_terms(*args)
        want = gn.gn_terms_plain(*args)
        torch.cuda.synchronize()
        for part, a, b in zip(("H", "g", "rsum"), got[:3], want[:3]):
            scale = max(b.abs().max().item(), 1e-12)
            rel = (a - b).abs().max().item() / scale
            if rel > GN_REL_TOL:
                raise AssertionError(f"gn level {level} {part}: relative error {rel:.3g}")
            gn_err = max(gn_err, (a - b).abs().max().item())
            gn_rel = max(gn_rel, rel)
        n = obj.gray.numel()
        dcount = abs(int(got[3]) - int(want[3]))
        if dcount > max(2, GN_COUNT_TOL * n):
            raise AssertionError(f"gn level {level}: count {int(got[3])} vs {int(want[3])}")
        shape = tag + "x".join(map(str, obj.gray.shape))
        ms = timed(lambda: gn.gn_terms(*args))
        plain_ms = timed(lambda: gn.gn_terms_plain(*args))
        gn_times[shape] = (ms, plain_ms)
        work[shape] = gn.work(obj.gray.shape, int(want[3]))
        phase("kernels", f"gn {shape}: count {int(got[3])} vs plain {int(want[3])}, "
                         f"max relative error so far {gn_rel:.3g}, "
                         f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return gn_err, gn_rel, work


def stepwise_level(planes, K, xi0, level_index, cfg):
    """The stepwise GN loop: the masked loop with one ``csrc/gn.cu``
    launch per step and the solve and pose update in PyTorch ops."""
    from dvo_tpu_torch.ops.cuda import gn, gn_level

    return gn_level.gn_level_plain(planes, K, xi0, level_index, cfg, terms=gn.gn_terms)


@contextlib.contextmanager
def stepwise_tracker():
    """The tracker runs every level through ``stepwise_level`` in place of
    the level kernel."""
    from dvo_tpu_torch.models import tracker

    with patched(tracker, "gn_level", stepwise_level):
        yield


def check_gn_level(obj_scenes, ref_scenes, cfg, times, tag=""):
    """The level kernel vs ``gn_level_plain`` at every level, coarse to fine,
    each level starting from the plain loop's xi of the level before (as
    ``track`` chains them), and its launch shape from the kernel's C entries
    against ``gn_level.launch_shape``.  Fills times[tag + shape] = (kernel,
    plain loop, stepwise loop ms, the launch shape), work[tag + shape] =
    (bytes, flops) of the call.
    Returns (max |d xi|, max relative statistics error, work by shape, the
    finest level's arguments)."""
    from dvo_tpu_torch.models.tracker import level_planes
    from dvo_tpu_torch.ops.cuda import _build, gn_level

    dev = obj_scenes[0].gray.device
    xi = torch.zeros(6, dtype=torch.float32, device=dev)
    max_dxi, max_rel, work = 0.0, 0.0, {}
    lib = _build.library()
    for level, (obj, ref) in enumerate(zip(obj_scenes, ref_scenes)):
        h, w = obj.gray.shape
        shape_c = (lib.dvo_gn_level_blocks(h, w), lib.dvo_gn_level_threads(h, w))
        if shape_c != gn_level.launch_shape(h, w):
            raise AssertionError(f"gn_level {h}x{w}: the kernel's launch shape {shape_c}, "
                                 f"launch_shape {gn_level.launch_shape(h, w)}")
        args = (level_planes(obj, ref), ref.K, xi, level, cfg)
        got = gn_level.gn_level(*args)
        again = gn_level.gn_level(*args)
        want = gn_level.gn_level_plain(*args)
        torch.cuda.synchronize()
        shape = tag + "x".join(map(str, obj.gray.shape))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"gn_level {shape}: two runs on the same inputs differ")
        dxi = (got[0] - want[0]).abs().max().item()
        if not dxi <= GN_LEVEL_XI_TOL:
            raise AssertionError(f"gn_level {shape}: |d xi| {dxi:.3g}")
        if int(got[4]) != int(want[4]) or not torch.equal(got[3], want[3]):
            raise AssertionError(f"gn_level {shape}: iterations {int(got[4])} vs "
                                 f"{int(want[4])}, counts {got[3].tolist()} vs "
                                 f"{want[3].tolist()}")
        for part, a, b in zip(("residuals", "update norms"), got[1:3], want[1:3]):
            rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-12)
            if not rel <= GN_LEVEL_STAT_TOL:
                raise AssertionError(f"gn_level {shape} {part}: relative error {rel:.3g}")
            max_rel = max(max_rel, rel)
        max_dxi = max(max_dxi, dxi)
        iters = int(want[4])
        work[shape] = gn_level.work(obj.gray.shape, want[3][:iters].tolist(),
                                    cfg.max_iterations)
        ms = timed(lambda: gn_level.gn_level(*args))
        plain_ms = timed(lambda: gn_level.gn_level_plain(*args), SLOW_REPS, 1)
        step_ms = timed(lambda: stepwise_level(*args), SLOW_REPS, 1)
        times[shape] = (ms, plain_ms, step_ms, shape_c)
        phase("kernels", f"gn_level {shape}: launch shape {shape_c[0]} x {shape_c[1]} (the C "
                         f"entries equal launch_shape), {iters} steps, |d xi| {dxi:.3g}, counts "
                         f"and iterations equal, repeats bitwise, kernel {ms:.4f} ms, plain loop "
                         f"{plain_ms:.3f} ms, stepwise loop {step_ms:.3f} ms")
        xi, fine_args = want[0], args

    # a level with no valid pixel: one step, mean residual -1, xi as composed with 0
    obj, ref = obj_scenes[-1], ref_scenes[-1]
    planes = list(level_planes(obj, ref))
    planes[1] = torch.zeros_like(planes[1])
    args = (tuple(planes), ref.K, xi, len(obj_scenes) - 1, cfg)
    got, want = gn_level.gn_level(*args), gn_level.gn_level_plain(*args)
    torch.cuda.synchronize()
    if (int(got[4]) != 1 or int(want[4]) != 1 or got[1][0].item() != -1.0
            or got[3].abs().sum().item() != 0
            or not (got[0] - want[0]).abs().max().item() <= GN_LEVEL_XI_TOL):
        raise AssertionError(f"gn_level {tag}no valid pixel: {[t.tolist() for t in got]}")
    phase("kernels", f"gn_level {tag}no valid pixel: 1 step, residual -1, xi kept "
                     f"(|d xi| {(got[0] - want[0]).abs().max().item():.3g})")
    return max_dxi, max_rel, work, fine_args


def compare_maps(name, got, want):
    """Share of pixels within MAP_VALUE_TOL and the max abs error."""
    from dvo_tpu_torch.tools.step_gate import map_agreement

    share, err = map_agreement(got, want, MAP_VALUE_TOL)
    if share < MAP_SHARE:
        raise AssertionError(f"{name}: only {share:.4f} of pixels within tolerance")
    return err, share


def depth_update_args(state, gray, mask, K, cfg):
    """The arguments ``models.mapper.depth_update`` gets for the next frame
    of ``state`` (already culled): tracked, posed, with a reset plane from
    SEED.  Returns (the arguments, the tracked frame)."""
    from dvo_tpu_torch.models.frame import build_tracking_frame, with_pose
    from dvo_tpu_torch.models.tracker import track
    from dvo_tpu_torch.ops.depth_filter import draw_reset_depth

    dev = gray.device
    frame = build_tracking_frame(gray, mask, K, cfg.pyramid.levels, 0, state.frame_count)
    frame = with_pose(frame, track(frame, state.ref, cfg.tracker).xi, state.ref.xi)
    base = state.ref.base
    reset = draw_reset_depth(base.shape, cfg.mapper.depth_filter,
                             torch.Generator(device=dev).manual_seed(SEED), dev)
    return (frame.base, frame.xi, frame.relative_xi, base.depth, base.sigma, state.ref.age,
            state.history, reset, cfg.mapper), frame


STAT_NAMES = ("observed", "accepted", "rejected", "aged_out")


def check_epipolar(label, args, timed_too=True):
    """Both entries of ``csrc/epipolar.cu`` on the ``depth_update`` arguments
    ``args``: the fused entry (through ``models.mapper.depth_update``)
    against ``epipolar_fields`` + ``epipolar_update_plain``, the fields entry
    against ``epipolar_update_plain``; depth and sigma by ``compare_maps``,
    the share of equal ages, every count within STATS_TOL; a second run of
    each must give the same bits.  Returns (the fields entry's result dict,
    the fused entry's)."""
    from dvo_tpu_torch.models import mapper
    from dvo_tpu_torch.ops.cuda import epipolar

    obj, obj_xi, rel_xi, depth, sigma, age, hist, reset, cfg = args
    ring = (hist.gray, hist.gx, hist.gy, hist.gmask)
    fields, aged_out = mapper.epipolar_fields(*args)
    want = epipolar.epipolar_update_plain(fields, *ring, cfg)
    want_stats = want[3].tolist() + [int(aged_out)]
    table = mapper.pose_table(obj.K, obj_xi, rel_xi, hist)

    def fused_entry():
        return epipolar.epipolar_fused(obj.gray, obj.mask, depth, sigma, age, reset, table,
                                       *ring, hist.head, hist.count, cfg)

    def unpack(out):
        return out[:3] + (torch.stack([getattr(out[3], k) for k in STAT_NAMES]),)

    runs = {
        "fields": (lambda: epipolar.epipolar_update(fields, *ring, cfg), want_stats[:3]),
        "fused": (lambda: unpack(mapper.depth_update(*args)), want_stats),
    }
    out = {}
    for entry, (fn, stats) in runs.items():
        got, again = fn(), fn()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"epipolar {entry} {label}: two runs on the same inputs differ")
        err_d, share_d = compare_maps(f"epipolar {entry} depth", got[0], want[0])
        err_s, _ = compare_maps(f"epipolar {entry} sigma", got[1], want[1])
        age_share = (got[2] == want[2]).double().mean().item()
        if age_share < MAP_SHARE:
            raise AssertionError(f"epipolar {entry} age: only {age_share:.4f} of pixels equal")
        if got[2].dtype != torch.int32:
            raise AssertionError(f"epipolar {entry}: age is {got[2].dtype}")
        for k, (a, b) in enumerate(zip(got[3].tolist(), stats)):
            if abs(a - b) > max(2, STATS_TOL * b):
                raise AssertionError(f"epipolar {entry} {STAT_NAMES[k]}: {a} vs {b}")
        identical = all(torch.equal(a, b) for a, b in zip(got[:3], want[:3])) \
            and got[3].tolist() == stats
        out[entry] = dict(max_abs_err=max(err_d, err_s), bit_identical=identical,
                          stats=got[3].tolist(), plain_stats=stats, depth_share=share_d,
                          age_share=age_share)
        phase("kernels", f"epipolar {entry} entry {label}: counts {got[3].tolist()} vs plain "
                         f"{stats}, depth share {share_d:.5f}, max err {max(err_d, err_s):.3g}, "
                         f"ages equal {age_share:.5f}, repeat bitwise, bit-identical to the "
                         f"plain version: {identical}")
    if not timed_too:
        return out["fields"], out["fused"]

    base_ok = fields[epipolar.F_BASE_OK] > 0.5
    slots = torch.unique(fields[epipolar.F_SLOT][base_ok]).numel()
    samples = int(epipolar.marched_samples(fields, cfg))
    shape = depth.shape
    plain_fields = lambda: epipolar.epipolar_update_plain(fields, *ring, cfg)
    plain_fused = lambda: epipolar.epipolar_update_plain(mapper.epipolar_fields(*args)[0],
                                                         *ring, cfg)
    by_fields = lambda: mapper.depth_update_by_fields(*args)
    f, u = out["fields"], out["fused"]
    f.update(ms=timed(runs["fields"][0]), plain_ms=timed(plain_fields))
    f["device_launches"], f["device_us"] = device_profile(runs["fields"][0], 20, True)
    # The fused entry alone (the kernel's row), the whole depth_update around
    # it (pose table included), and the route it replaces: fields + fields entry.
    u.update(ms=timed(fused_entry), plain_ms=timed(plain_fused),
             depth_update_ms=timed(lambda: mapper.depth_update(*args)),
             by_fields_ms=timed(by_fields))
    u["device_launches"], u["device_us"] = device_profile(fused_entry, 20, True)
    u["depth_update_device_ops"], u["depth_update_device_us"] = device_profile(
        lambda: mapper.depth_update(*args), 10, True)
    u["by_fields_device_ops"], u["by_fields_device_us"] = device_profile(by_fields, 10, True)
    for entry in (f, u):
        entry.update(slots_in_use=slots, marched_samples=samples,
                     observing_pixels=int(base_ok.sum()))
    with_bound(f, *epipolar.work(shape, slots, samples))
    with_bound(u, *epipolar.work_fused(shape, slots, samples, hist.capacity))
    phase("kernels", f"epipolar {label}: {slots} born slots in use, {int(base_ok.sum())} "
                     f"observing pixels, {samples} samples marched; fields entry {f['ms']:.4f} "
                     f"ms (plain {f['plain_ms']:.4f}), device {f['device_us']:.2f} us in "
                     f"{f['device_launches']:g} ops, bound {f['bound_us']:.3f} us; fused entry "
                     f"{u['ms']:.4f} ms, device {u['device_us']:.2f} us in "
                     f"{u['device_launches']:g} ops, bound {u['bound_us']:.3f} us; depth_update "
                     f"{u['depth_update_ms']:.4f} ms, {u['depth_update_device_ops']:g} device ops, "
                     f"{u['depth_update_device_us']:.2f} us; fields + fields entry "
                     f"{u['by_fields_ms']:.4f} ms, {u['by_fields_device_ops']:g} device ops, "
                     f"{u['by_fields_device_us']:.2f} us; fields + plain {u['plain_ms']:.4f} ms")
    return f, u


def check_regularize_cull(label, ref, depth, sigma, age, cfg):
    """The regularize-and-cull launch against its plain version
    (``regularize_plain`` then the pair's culls), ``torch.equal`` on every
    level of both pyramids, and ``with_regularized_depth`` against the three
    launches it replaces (pair build, ``csrc/regularize.cu``, one-plane
    build).  Returns its result dict."""
    from dvo_tpu_torch.models import frame
    from dvo_tpu_torch.ops.cuda import framebuild

    levels = ref.levels
    got = framebuild.regularize_cull_pyramid(depth, sigma, levels, cfg)
    again = framebuild.regularize_cull_pyramid(depth, sigma, levels, cfg)
    want = framebuild.regularize_cull_pyramid_plain(depth, sigma, levels, cfg)
    three = frame.with_regularized_depth_plain(ref, depth, sigma, age, cfg)
    torch.cuda.synchronize()
    if len(got) != levels or len(want) != levels:
        raise AssertionError(f"regularize_cull {label}: {len(got)} levels")
    for i, ((gd, gs), (ad, as_), (wd, ws), scene) in enumerate(zip(got, again, want,
                                                                  three.scenes)):
        for what, a, b in (("depth vs plain", gd, wd), ("sigma vs plain", gs, ws),
                           ("depth repeat", gd, ad), ("sigma repeat", gs, as_),
                           ("depth vs three launches", gd, scene.depth),
                           ("sigma vs three launches", gs, scene.sigma)):
            if a.shape != b.shape or not torch.equal(a, b):
                raise AssertionError(f"regularize_cull {label}: level {i} {what} differs")
    one = lambda: frame.with_regularized_depth(ref, depth, sigma, age, cfg)
    split = lambda: frame.with_regularized_depth_plain(ref, depth, sigma, age, cfg)
    plain = lambda: framebuild.regularize_cull_pyramid_plain(depth, sigma, levels, cfg)
    out = dict(max_abs_err=0.0, bit_identical=True, ms=timed(one), three_launches_ms=timed(split),
               plain_ms=timed(plain))
    out["device_launches"], out["device_us"] = device_profile(one, 20, True)
    out["three_launches_device_ops"], out["three_launches_device_us"] = device_profile(
        split, 20, True)
    with_bound(out, *framebuild.work_regularize_cull(depth.shape, levels))
    phase("kernels", f"regularize_cull {label}: {levels} levels of depth and sigma equal to "
                     f"the plain version and to the three launches, repeat bitwise; "
                     f"{out['ms']:.4f} ms, device {out['device_us']:.2f} us in "
                     f"{out['device_launches']:g} launch; the three launches "
                     f"{out['three_launches_ms']:.4f} ms, {out['three_launches_device_us']:.2f} us "
                     f"in {out['three_launches_device_ops']:g}; plain {out['plain_ms']:.4f} ms; "
                     f"bound {out['bound_us']:.3f} us")
    return out


def kernel_phase(state, grays, masks, K, cfg, tag="", sweeps=None):
    """Each kernel vs its plain version at a monocular path's shapes, on the
    state a real run left behind (full ring) and the next frame: GN at every
    level, both epipolar entries, regularize, the regularize-and-cull launch
    and the four frame builds (tracking frame, a frame with depth, the
    depth/sigma pair and one plane).  ``tag`` prefixes the labels; the
    regulariser's sweep rows (``tools/regularize_sweep``) on the state's
    maps go to the list ``sweeps``, if given.  Returns (one entry per kernel,
    with its times by shape; the frame builds' (error, ms, plain ms) by
    label)."""
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.models.frame import build_tracking_frame, normalize_gray, with_pose
    from dvo_tpu_torch.models.tracker import level_planes, track
    from dvo_tpu_torch.ops.cuda import _build, framebuild, gn, gn_level, regularize
    from dvo_tpu_torch.tools import framebuild_floor, regularize_sweep

    frame = build_tracking_frame(grays, masks, K, cfg.pyramid.levels, 0, state.frame_count)
    tr = track(frame, state.ref, cfg.tracker)
    frame = with_pose(frame, tr.xi, state.ref.xi)
    T_inv = lie.se3_exp(-tr.xi)
    results = []
    base = state.ref.base
    shape = "x".join(map(str, base.shape))

    # --- GN at every pyramid level (the finest carries the crop) ---
    gn_times = {}
    gn_err, gn_rel, gn_work = check_gn(frame.scenes, state.ref.scenes, T_inv, cfg.tracker,
                                       gn_times, tag)
    ms, plain_ms = gn_times[tag + shape]
    fine = len(frame.scenes) - 1
    planes = level_planes(frame.scenes[fine], state.ref.scenes[fine])
    K_fine = state.ref.scenes[fine].K
    ops, us = device_profile(lambda: gn.gn_terms(*planes, K_fine, T_inv, fine, cfg.tracker),
                             20, True)
    results.append(with_bound(
        dict(name="gn", route="cuda", source="dvo_tpu_torch/csrc/gn.cu",
             replaces="dvo_tpu/ops/pallas/gn.py:45", max_abs_err=gn_err, max_rel_err=gn_rel,
             ms=ms, plain_ms=plain_ms, device_us=us, device_launches=ops,
             times_by_shape=gn_times, work_by_shape=gn_work), *gn_work[tag + shape]))

    # --- the GN level loop at every pyramid level, chained coarse to fine ---
    lv_times = {}
    dxi, lv_rel, lv_work, level_args = check_gn_level(frame.scenes, state.ref.scenes,
                                                      cfg.tracker, lv_times, tag)
    ms, plain_ms, step_ms = lv_times[tag + shape][:3]
    ops, us = device_profile(lambda: gn_level.gn_level(*level_args), 20, True)
    step_ops, step_us = device_profile(lambda: stepwise_level(*level_args), 2, True)
    phase("kernels", f"{tag}gn_level {shape}: device {us:.2f} us in {ops:g} launches; "
                     f"stepwise loop {step_us:.2f} us in {step_ops:g}")
    results.append(with_bound(
        dict(name="gn_level", route="cuda", source="dvo_tpu_torch/csrc/gn_level.cu",
             replaces="dvo_tpu/ops/pallas/gn.py:45", max_abs_err=dxi, max_rel_err=lv_rel,
             ms=ms, plain_ms=plain_ms, stepwise_ms=step_ms, device_us=us, device_launches=ops,
             stepwise_device_us=step_us, stepwise_device_launches=step_ops,
             times_by_shape=lv_times, work_by_shape=lv_work), *lv_work[tag + shape]))

    # --- epipolar against the full ring: the fields entry and the fused one ---
    hist = state.history
    if hist.count != hist.capacity:
        raise AssertionError(f"ring holds {hist.count} of {hist.capacity} keyframes")
    epi_args, _ = depth_update_args(state, grays, masks, K, cfg)
    if not torch.equal(epi_args[2], frame.relative_xi):
        raise AssertionError("the depth update's frame is not the tracked one")
    by_fields, fused = check_epipolar(f"{tag}{shape}", epi_args)
    for name, entry, what in (("epipolar", by_fields, "fields entry"),
                              ("epipolar_fused", fused, "fused entry")):
        results.append(dict(name=name, route="cuda", counter="epipolar", entry=what,
                            source="dvo_tpu_torch/csrc/epipolar.cu",
                            replaces="dvo_tpu/ops/pallas/epipolar.py:64",
                            no_library_call="a data-dependent march along each pixel's "
                                            "epipolar segment with a depth filter", **entry,
                            times_by_shape={tag + shape: (entry["ms"], entry["plain_ms"])}))

    # --- regularize: the shipped launch (its C entries against
    # regularize.LAUNCH), bitwise against the plain version, then every
    # launch of the sweep on the same maps ---
    lib = _build.library()
    launch = (regularize.KINDS[lib.dvo_regularize_kind()], lib.dvo_regularize_block_rows(),
              lib.dvo_regularize_thread_rows())
    if launch != regularize.LAUNCH:
        raise AssertionError(f"regularize: the kernel's launch {launch}, LAUNCH "
                             f"{regularize.LAUNCH}")
    got = regularize.regularize(base.depth, base.sigma, cfg.mapper)
    again = regularize.regularize(base.depth, base.sigma, cfg.mapper)
    want = regularize.regularize_plain(base.depth, base.sigma, cfg.mapper)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not torch.equal(got, again):
        raise AssertionError(f"{tag}regularize {shape}: {int((got != want).sum())} pixels "
                             "differ from the plain version, or a repeat differs")
    err = (got - want).abs().max().item()
    ms = timed(lambda: regularize.regularize(base.depth, base.sigma, cfg.mapper))
    plain_ms = timed(lambda: regularize.regularize_plain(base.depth, base.sigma, cfg.mapper))
    ops, us = device_profile(lambda: regularize.regularize(base.depth, base.sigma, cfg.mapper),
                             20, True)
    nbytes, flops = regularize.work(base.shape)
    fl = framebuild_floor.floor_us(nbytes, device_profile)
    (gx, gy), (bx, by) = regularize.launch_grid(*base.shape)
    phase("kernels", f"{tag}regularize {shape}: launch {regularize_sweep.label(launch)} ({gx} x "
                     f"{gy} blocks of {bx} x {by}; the C entries equal LAUNCH), bitwise equal to "
                     f"the plain version, repeat bitwise, kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms, device {us:.2f} us in {ops:g} launches; empty launch "
                     f"{fl['empty_us']:.2f} us, a copy of its {fl['copy_bytes']} B "
                     f"{fl['copy_us']:.2f} us, bound {_build.bound_us(nbytes, flops)[0]:.3f} us")
    if sweeps is not None:
        sweeps += regularize_sweep.sweep({tag + shape: (base.depth, base.sigma)}, cfg.mapper,
                                         sys.modules[__name__],
                                         say=lambda line: phase("kernels", line))
    results.append(with_bound(
        dict(name="regularize", route="cuda", source="dvo_tpu_torch/csrc/regularize.cu",
             replaces="dvo_tpu/ops/pallas/regularize.py:29", max_abs_err=err, ms=ms,
             plain_ms=plain_ms, device_us=us, device_launches=ops, bit_identical=True,
             launch=regularize_sweep.label(launch), blocks=gx * gy, threads=bx * by,
             times_by_shape={tag + shape: (ms, plain_ms)}),
        nbytes, flops))

    # --- regularize and cull in one launch (the mapper's reference rebuild) ---
    rc = check_regularize_cull(f"{tag}{shape}x{cfg.pyramid.levels}", state.ref, base.depth,
                               base.sigma, state.ref.age, cfg.mapper)
    results.append(dict(name="regularize_cull", route="cuda",
                        source="dvo_tpu_torch/csrc/framebuild.cu",
                        replaces="dvo_tpu/ops/pallas/framebuild.py:103 and "
                                 "dvo_tpu/ops/pallas/regularize.py:29",
                        no_library_call="a gated 4-neighbour fusion with a scatter to every "
                                        "pyramid level", **rc,
                        times_by_shape={tag + shape: (rc["ms"], rc["plain_ms"])}))

    # --- the frame builds: tracking frame, a keyframe with depth (the first
    # frame's), the depth/sigma pair (promotion) and one plane (regularize) ---
    levels = cfg.pyramid.levels
    gray = normalize_gray(grays)
    builds = {
        "tracking": (framebuild.build_pyramid_planes, framebuild.build_pyramid_planes_plain,
                     gray, masks, None, None, levels),
        "depth": (framebuild.build_pyramid_planes, framebuild.build_pyramid_planes_plain,
                  gray, masks, base.depth, base.sigma, levels),
        "pair": (framebuild.cull_pyramid_pair, framebuild.cull_pyramid_pair_plain,
                 base.depth, base.sigma, levels),
        "one": (framebuild.cull_pyramid_one, framebuild.cull_pyramid_one_plain,
                base.depth, levels),
    }
    fb = {}
    for kind, args in builds.items():
        label = f"{tag}{kind} {shape}x{levels}"
        fb[label] = check_framebuild(label, *args)
    return results, fb


PLANE_WARM = 12         # frames of the analytic rig before its kernels are held


def plane_rig_phase(dev, card_line, cfg, resets, kernels, fb, old_census):
    """The mono path on the analytic rig (``render_planes``): the first
    keyframe with the true depth, PLANE_FRAMES frames; the accepted
    observations per depth update; then, on the state PLANE_WARM frames in,
    the gate census, both epipolar entries, the regularize-and-cull launch and
    the frame builds held against their plain versions and timed.  Adds to
    the ``kernels`` entries and to ``fb``; returns the rig's summary and the
    ``depth_update`` arguments it held the kernels on."""
    from dvo_tpu_torch.models.frame import normalize_gray
    from dvo_tpu_torch.models.odometry import (
        _cull_chunk,
        monocular_init_with_depth,
        monocular_run,
    )
    from dvo_tpu_torch.ops.cuda import framebuild

    grays, masks, K, depth0 = render_planes(dev, PLANE_FRAMES + 1)
    start = monocular_init_with_depth(grays[0], masks[0], depth0,
                                      torch.full_like(depth0, PLANE_SIGMA), K, cfg,
                                      device=dev)
    n = PLANE_FRAMES
    (_, res), secs, launches = run_path("planes", lambda: monocular_run(
        start, grays[1:1 + n], masks[1:1 + n], K, cfg, resets[:n].to(dev)))
    kf = res.is_keyframe
    require_launched("planes", launches, MONO_KERNELS, (cfg.pyramid.levels, n),
                     mono=("fused", n, int(kf.sum()), 0))
    accepted = res.mapping.accepted[~kf].tolist()
    if not torch.isfinite(res.T_world).all():
        raise AssertionError("planes: non-finite pose")
    warm, _ = monocular_run(start, grays[1:1 + PLANE_WARM], masks[1:1 + PLANE_WARM], K, cfg,
                            resets[:PLANE_WARM].to(dev))
    cfg0, K0, (g, m) = _cull_chunk(cfg, K, grays[1 + PLANE_WARM], masks[1 + PLANE_WARM])
    args, _ = depth_update_args(warm, g, m, K0, cfg0)
    census = gate_census(args)
    shape = "x".join(map(str, g.shape))
    phase("kernels", f"planes: {n} frames, {int(kf.sum())} promotions, accepted per depth "
                     f"update {accepted} ({sum(accepted)} in all, {secs * 1e3 / n:.2f} ms/frame); "
                     f"gate census {PLANE_WARM} frames in: {census}; the earlier rig's: "
                     f"{old_census}")
    by_fields, fused = check_epipolar(f"planes {shape}", args)
    base = warm.ref.base
    rc = check_regularize_cull(f"planes {shape}x{cfg.pyramid.levels}", warm.ref, base.depth,
                               base.sigma, warm.ref.age, cfg.mapper)
    levels = cfg.pyramid.levels
    gray = normalize_gray(g)
    for kind, args_fb in (("tracking", (gray, m, None, None, levels)),
                          ("depth", (gray, m, base.depth, base.sigma, levels))):
        label = f"planes {kind} {shape}x{levels}"
        fb[label] = check_framebuild(label, framebuild.build_pyramid_planes,
                                     framebuild.build_pyramid_planes_plain, *args_fb)
    entries = {k["name"]: k for k in kernels}
    for name, got in (("epipolar", by_fields), ("epipolar_fused", fused),
                      ("regularize_cull", rc)):
        entry = entries[name]
        entry["bit_identical"] = entry["bit_identical"] and got["bit_identical"]
        entry["planes"] = {k: v for k, v in got.items() if k in (
            "bit_identical", "stats", "ms", "plain_ms", "device_us", "device_launches",
            "bound_us", "observing_pixels", "marched_samples", "slots_in_use")}
    return dict(frames=n, promotions=int(kf.sum()), accepted_per_update=accepted,
                accepted_sum=sum(accepted), census=census, earlier_rig_census=old_census,
                ms_per_frame=secs * 1e3 / n), args


def kinect_mono_kernel_phase(dev, grays, masks, counts, K, cfg, sweeps=None):
    """The kernels at the shapes of ``--format kinect --mode mono``: the
    512x424 depth camera culled twice by ``DVOConfig.monocular()``, a
    106x128 base with 3 levels.  ``monocular_init_with_depth`` on the RGB-D
    frames, run on the CPU (the plain versions: a state the kernels under
    test did not make) KINECT_WARM frames at a time until the keyframe ring
    is full, moved to the card, then ``kernel_phase`` on the next frame."""
    from dvo_tpu_torch.models.odometry import (
        _cull_chunk,
        monocular_init_with_depth,
        monocular_run,
        raw_depth,
    )
    from dvo_tpu_torch.tools.step_gate import on_device

    d0, s0 = raw_depth(counts[0].cpu(), DEPTH_SCALE)
    state = monocular_init_with_depth(grays[0].cpu(), masks[0].cpu(), d0, s0, K.cpu(), cfg,
                                      device="cpu")
    i = 1
    while state.history.count < state.history.capacity:
        if i + KINECT_WARM >= grays.shape[0]:
            raise AssertionError(f"kinect mono: the ring holds {int(state.history.count)} "
                                 f"keyframes after {i - 1} frames")
        sl = slice(i, i + KINECT_WARM)
        state, _ = monocular_run(state, grays[sl].cpu(), masks[sl].cpu(), K.cpu(), cfg)
        i += KINECT_WARM
    state = on_device(state, dev)
    cfg0, K0, (gray, mask) = _cull_chunk(cfg, K.to(dev), grays[i].to(dev), masks[i].to(dev))
    phase("kernels", f"kinect mono: the ring full after {i - 1} frames on the CPU")
    return kernel_phase(state, gray, mask, K0, cfg0, tag="kinect_mono ", sweeps=sweeps)


def stable_start(cfg, grays, masks, K, depth, device):
    """The stable rig's first state: frame 0 with its true depth, sigma
    STABLE_SIGMA (``monocular_init_with_depth``)."""
    from dvo_tpu_torch.models.odometry import monocular_init_with_depth

    return monocular_init_with_depth(grays[0], masks[0], depth,
                                     torch.full_like(depth, STABLE_SIGMA), K, cfg, device=device)


def decisions(kf) -> str:
    """A run's keyframe decisions, one character a frame (K: promotion)."""
    return "".join("K" if k else "." for k in kf.tolist())


def stable_rig_phase(dev, card_line, cfg, grays, masks, K, depth, resets):
    """How far float noise steers a monocular rig (ROADMAP queue C, v): each
    candidate's whole mono path (``monocular_run``, graphed, one chunk) with
    the shipped ``gn_level`` launch shapes, with ``gn_level.cu`` built with
    every shape at the shipped ones (must be bitwise equal: the build adds
    shapes, no arithmetic), and at another shape on every level
    (``gn_level_stamps.other_shape``: 8 <-> 16 blocks).  The candidates:
    ``render`` + ``monocular_init_with_depth`` (``STABLE_RIG``) and
    ``render_planes``.  Prints the largest pose difference and both runs'
    decisions over the first STABLE_FRAMES frames and over the whole run;
    STABLE_RIG must keep its decisions and stay within POSE_TOL over the
    first STABLE_FRAMES.  Returns the readings."""
    from dvo_tpu_torch.models.odometry import monocular_init_with_depth, monocular_run
    from dvo_tpu_torch.ops.cuda import gn_level
    from dvo_tpu_torch.tools import gn_level_stamps

    shapes_lib = gn_level_stamps.build_shapes()
    p_grays, p_masks, p_K, p_depth = render_planes(dev, N_FRAMES)
    rigs = {
        STABLE_RIG: (lambda: stable_start(cfg, grays, masks, K, depth, dev), grays, masks, K),
        "planes": (lambda: monocular_init_with_depth(
            p_grays[0], p_masks[0], p_depth, torch.full_like(p_depth, PLANE_SIGMA), p_K, cfg,
            device=dev), p_grays, p_masks, p_K),
    }
    runs = {"shipped": contextlib.nullcontext,
            "shipped, every-shape build": lambda: gn_level_stamps.shaped_levels(
                shapes_lib, gn_level.launch_shape),
            "other shapes": lambda: gn_level_stamps.shaped_levels(
                shapes_lib, gn_level_stamps.other_shape)}
    out = {}
    for rig, (start, g, m, K_r) in rigs.items():
        n = g.shape[0] - 1
        got = {}
        for name, ctx in runs.items():
            with ctx():   # a fresh first state: its driver is captured here
                _, res = monocular_run(start(), g[1:], m[1:], K_r, cfg, resets[:n].to(dev))
            got[name] = (res.T_world, res.is_keyframe)
        T0, kf0 = got["shipped"]
        if not all(torch.equal(a, b) for a, b in zip(got["shipped"],
                                                     got["shipped, every-shape build"])):
            raise AssertionError(f"stable {rig}: gn_level.cu built with every shape gives "
                                 "other bits at the shipped shapes")
        T1, kf1 = got["other shapes"]
        per_frame = (T0 - T1).abs().flatten(1).max(dim=1).values
        past = torch.nonzero(per_frame > POSE_TOL).flatten().tolist()
        k = STABLE_FRAMES
        row = dict(frames=n, max_dT_first=per_frame[:k].max().item(),
                   keyframes_equal_first=bool(torch.equal(kf0[:k], kf1[:k])),
                   max_dT=per_frame.max().item(), keyframes_equal=bool(torch.equal(kf0, kf1)),
                   first_frame_past_pose_tol=past[0] if past else None,
                   decisions_shipped=decisions(kf0), decisions_other=decisions(kf1))
        out[rig] = row
        phase("stable", f"{rig}: shipped gn_level shapes vs another shape at every level "
                        f"(8 <-> 16 blocks): max |dT| {row['max_dT_first']:.3g} over the first "
                        f"{k} frames (tol {POSE_TOL}), decisions equal {row['keyframes_equal_first']}"
                        f"; over all {n}: {row['max_dT']:.3g}, first frame past the tolerance "
                        f"{row['first_frame_past_pose_tol']}, decisions equal "
                        f"{row['keyframes_equal']}: shipped {row['decisions_shipped']}, other "
                        f"{row['decisions_other']}; the every-shape build bitwise equal at the "
                        f"shipped shapes on {card_line}")
    chosen = out[STABLE_RIG]
    if not chosen["keyframes_equal_first"] or not chosen["max_dT_first"] <= POSE_TOL:
        raise AssertionError(f"stable: the {STABLE_RIG} rig follows the launch shapes within "
                             f"{STABLE_FRAMES} frames")
    return out


def merge_entry(entry, err, rel, work):
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["max_rel_err"] = max(entry["max_rel_err"], rel)
    entry["work_by_shape"].update(work)


def rgbd_kernel_phase(dev, grays, masks, counts, K, cfg, entries, fb):
    """The GN step and the GN level loop at the four RGB-D levels and the
    RGB-D frame builds, on the first two frames of the RGB-D sequence; adds
    to the ``gn`` and ``gn_level`` entries and to ``fb``.  Returns (the
    RGB-D build's label, its device time, launches and work())."""
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.models.frame import build_frame_with_depth, normalize_gray
    from dvo_tpu_torch.models.odometry import _cull_chunk, raw_depth
    from dvo_tpu_torch.models.tracker import track
    from dvo_tpu_torch.ops.cuda import framebuild

    cfg0, K0, (g, m, c) = _cull_chunk(cfg, K.to(dev), grays[:2].to(dev), masks[:2].to(dev),
                                      counts[:2].to(dev))
    depths, sigmas = raw_depth(c, DEPTH_SCALE)
    levels = cfg.pyramid.levels
    ref = build_frame_with_depth(g[0], m[0], depths[0], sigmas[0], K0, levels, 0, 0)
    obj = build_frame_with_depth(g[1], m[1], depths[1], sigmas[1], K0, levels, 0, 1)
    tr = track(obj, ref, cfg0.tracker)
    merge_entry(entries["gn"], *check_gn(obj.scenes, ref.scenes, lie.se3_exp(-tr.xi),
                                         cfg0.tracker, entries["gn"]["times_by_shape"]))
    merge_entry(entries["gn_level"],
                *check_gn_level(obj.scenes, ref.scenes, cfg0.tracker,
                                entries["gn_level"]["times_by_shape"])[:3])

    holes = m[1] & (depths[1] > 0)
    if bool(holes.all()):
        raise AssertionError("the RGB-D build's mask has no holes")
    shape = f"{'x'.join(map(str, g[1].shape))}x{levels}"
    build_args = (normalize_gray(g[1]), holes, depths[1], sigmas[1], levels)
    fb[f"rgbd {shape}"] = check_framebuild(
        f"rgbd {shape}", framebuild.build_pyramid_planes, framebuild.build_pyramid_planes_plain,
        *build_args)
    fb[f"one {shape}"] = check_framebuild(
        f"one {shape}", framebuild.cull_pyramid_one, framebuild.cull_pyramid_one_plain,
        depths[1], levels)
    reads = [device_profile(lambda: framebuild.build_pyramid_planes(*build_args), 20, True)
             for _ in range(2)]
    ops, us = reads[-1]
    phase("kernels", f"framebuild rgbd {shape}: device {' / '.join(f'{r[1]:.2f}' for r in reads)} "
                     f"us in {ops:g} launches (two windows)")
    return f"rgbd {shape}", dict(device_us=us, device_launches=ops), \
        framebuild.work(g[1].shape, levels, 3, True)


def sync_stacks(fn, syncs: list):
    """Run ``fn()`` under ``set_sync_debug_mode("warn")``; appends the call
    stack of every host sync it issues to ``syncs`` and returns its result."""
    caught = []
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda message, *_, **__: caught.append(
            (str(message), traceback.format_stack()[:-1]))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs.extend([f for f in stack if "warnings.py" not in f]
                 for message, stack in caught if "called a synchronizing" in message)
    return out


def count_syncs(fn) -> int:
    """Host syncs that ``fn()`` issues; the call stack of each goes to
    stderr."""
    syncs = []
    sync_stacks(fn, syncs)
    for stack in syncs:
        print("sync at:\n" + "".join(stack[-6:]), file=sys.stderr)
    return len(syncs)


def plain_json(obj, path="result"):
    """``obj`` with every tensor in it as a number or list, each such path
    named on stderr (the result line is built from plain numbers)."""
    if isinstance(obj, torch.Tensor):
        print(f"a tensor at {path}", file=sys.stderr)
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: plain_json(v, f"{path}.{k}") for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain_json(v, f"{path}[{i}]") for i, v in enumerate(obj)]
    return obj


GRAPH_REPLAYS = 6       # replays of each captured step, each against the eager step


def tensors_of(tree):
    """Every tensor of a state or result (dataclasses, tuples, lists), in a
    fixed order; generators and None are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in tensors_of(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensors_of(x)]
    return []


def graph_phase(card_line, name, step, inputs, frames, kernels, levels):
    """``step()`` (one monocular or RGB-D step on a fixed state, reading its
    frame from the static tensors ``inputs``) captured in a CUDA graph —
    capture raises on any host sync, so a capture is the proof that the step
    makes none — and replayed on ``frames`` (tuples of tensors copied into
    ``inputs`` before each replay), each replay held bitwise against the
    eager step on the same inputs.  The launch counters count the captured
    kernels once per replay, so the replays' launches are held as a path's.
    Returns the phase's numbers: ms per replay and per eager step (CUDA
    events, in turns), device ops and device-busy us of one replay, the
    keyframe decisions of the replays."""
    from dvo_tpu_torch.ops.cuda import _build

    def load(frame):
        for dst, src in zip(inputs, frame):
            dst.copy_(src)

    load(frames[0])
    out, replay, captured = _build.capture_graph(step)
    decisions = []

    def replays():
        for frame in frames:
            load(frame)
            replay()
            eager = step()
            got, want = tensors_of(out), tensors_of(eager)
            if len(got) != len(want) or not all(
                    a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(got, want)):
                raise AssertionError(f"graph {name}: a replay differs from the eager step")
            decisions.append(bool(out[1].is_keyframe))

    _, _, launches = run_path(f"{name}_graph", replays)
    n = len(frames)
    # eager steps made launches too: the replays' share is the captured set
    replay_launches = {k: captured[k] * n for k in captured}
    require_launched(f"{name}_graph", {k: launches[k] - replay_launches[k] for k in launches},
                     kernels)
    require_launched(f"{name}_graph", replay_launches, kernels, (levels, n))
    ms_replay, ms_eager = [], []
    for order in ((replay, step), (step, replay)):
        for fn in order:
            (ms_replay if fn is replay else ms_eager).append(timed(fn, reps=20))
    ops, busy = device_profile(replay, 10, True)
    got = dict(captured_launches={k: v for k, v in captured.items() if v},
               replays=n, keyframes=decisions, ms_per_replay=ms_replay,
               ms_per_eager_step=ms_eager, replay_device_ops=ops, replay_device_us=busy)
    phase("graphs", f"{name}: one step captured (no host sync), {n} replays equal to the eager "
                    f"step bitwise (keyframe decisions {decisions}); a replay launches "
                    f"{got['captured_launches']}; ms per replay {ms_replay} vs eager step "
                    f"{ms_eager} (turns); a replay {ops:g} device ops, {busy:.1f} us busy "
                    f"on {card_line}")
    return got


STREAMS = 4             # streams of the batched runs held against single-stream runs
STREAM_FRAMES = 24      # frames per stream after the first
SCALING = (1, 2, 4, 8, 16, 16, 8, 4, 2, 1)   # streams per run of the scaling turns


def render_streams(device):
    """STREAMS mono sequences of STREAM_FRAMES + 1 frames at 640x480 (uint8),
    each with its own texture, depth, motion and focal length: (grays,
    masks) (B, N + 1, H, W) and K (B, 3, 3), on ``device``."""
    rng = np.random.default_rng(SEED + 2)
    grays, masks, Ks = [], [], []
    for b in range(STREAMS):
        base = texture(rng, H, W)
        depth = (1.5 + 0.1 * smooth_field(rng, H, W)).astype(np.float32)
        f = 600.0 * (1.0 + 0.05 * b)
        K = torch.tensor([[f, 0, 320.0], [0, f, 240.0], [0, 0, 1]], device=device)
        g, m = render(torch.from_numpy(base).to(device), torch.from_numpy(depth).to(device), K,
                      tuple(x * (1.0 + 0.25 * b) for x in STEP_XI), STREAM_FRAMES)
        grays.append(to_uint8(g))
        masks.append(m)
        Ks.append(K)
    return torch.stack(grays), torch.stack(masks), torch.stack(Ks)


def rgbd_streams(dev, r_grays, r_masks, r_counts, r_K, cfg_r):
    """STREAMS RGB-D streams cut from the rendered sequence, stream b
    starting at frame 2b: the stack of their first states and their
    (B, STREAM_FRAMES, H, W) gray, mask, depth and sigma chunks on the card."""
    from dvo_tpu_torch.models.odometry import raw_depth, rgbd_init, stack_states

    starts = [2 * b for b in range(STREAMS)]
    pick = lambda x, k: torch.stack([x[s + k] for s in starts]).to(dev)
    d0, s0 = raw_depth(pick(r_counts, 0), DEPTH_SCALE)
    g0, m0 = pick(r_grays, 0), pick(r_masks, 0)
    states = stack_states([rgbd_init(g0[b], m0[b], d0[b], s0[b], r_K, cfg_r, device=dev)
                           for b in range(STREAMS)])
    frames = range(1, 1 + STREAM_FRAMES)
    g = torch.stack([torch.stack([r_grays[s + k] for k in frames]) for s in starts]).to(dev)
    m = torch.stack([torch.stack([r_masks[s + k] for k in frames]) for s in starts]).to(dev)
    c = torch.stack([torch.stack([r_counts[s + k] for k in frames]) for s in starts]).to(dev)
    d, sg = raw_depth(c, DEPTH_SCALE)
    return states, (g, m, d, sg)


def same_tree(a, b) -> bool:
    """Every tensor of two states or results equal bitwise."""
    ta, tb = tensors_of(a), tensors_of(b)
    return len(ta) == len(tb) and all(x.shape == y.shape and x.dtype == y.dtype
                                      and torch.equal(x, y) for x, y in zip(ta, tb))


def streams_phase(dev, card_line, cfg, cfg_r, r_grays, r_masks, r_counts, r_K):
    """B = STREAMS mono and RGB-D streams through the batched drivers (one
    graphed driver per stream, each replayed on its own CUDA stream), each
    stream held bitwise against its own single-stream run (the race check:
    concurrent replays must not disturb one another), the launches against
    B times the single-stream path's, one capture per stream per run.  Then
    the mono scaling turns: aggregate frames/s of the second chunk (replays
    only), device-busy ms of a 4-frame chunk and peak device memory, at
    every B of SCALING."""
    from dvo_tpu_torch.models.odometry import (
        monocular_init,
        monocular_init_batched,
        monocular_run,
        monocular_run_batched,
        rgbd_run,
        rgbd_run_batched,
        select_streams,
        stream_generators,
        unstack_states,
    )
    from dvo_tpu_torch.ops.cuda import _build

    grays, masks, Ks = render_streams(dev)
    half = STREAM_FRAMES // 2
    chunks = (slice(1, 1 + half), slice(1 + half, 1 + STREAM_FRAMES))

    def mono_batched():
        st, out = monocular_init_batched(grays[:, 0], masks[:, 0], Ks, cfg, device=dev), []
        for sl in chunks:
            st, res = monocular_run_batched(st, grays[:, sl], masks[:, sl], Ks, cfg)
            out.append(res)
        return st, out

    (st_b, res_b), _, launches_b = run_path("streams_mono", mono_batched)
    captures_b = _build.CAPTURES
    singles, launches_1 = [], []
    for b in range(STREAMS):
        def mono_single(b=b):
            st = monocular_init(grays[b, 0], masks[b, 0], Ks[b], cfg, device=dev,
                                generator=stream_generators(dev, STREAMS)[b])
            out = []
            for sl in chunks:
                st, res = monocular_run(st, grays[b, sl], masks[b, sl], Ks[b], cfg)
                out.append(res)
            return st, out

        (st_1, res_1), _, launches = run_path(f"streams_mono_single_{b}", mono_single)
        launches_1.append(launches)
        equal = same_tree(st_1, select_streams(st_b, b)) and all(
            same_tree(r1, select_streams(rb, b)) for r1, rb in zip(res_1, res_b))
        if not equal:
            raise AssertionError(f"streams: mono stream {b} differs from its single-stream run")
        singles.append([r.T_world for r in res_1])
    want = {k: sum(l[k] for l in launches_1) for k in launches_b}
    if launches_b != want or launches_b != {k: STREAMS * v for k, v in launches_1[0].items()}:
        raise AssertionError(f"streams: mono launches {launches_b}, expected {want} "
                             f"(the single-stream runs' sum) = {STREAMS} x {launches_1[0]}")
    if captures_b != STREAMS:
        raise AssertionError(f"streams: {captures_b} captures for {STREAMS} streams in one run")
    kf = torch.cat([r.is_keyframe for r in res_b], 1)
    phase("streams", f"mono: {STREAMS} streams x {STREAM_FRAMES} frames 640x480 (own motion and "
                     f"focal length each, two chunks), each bitwise equal to its single-stream "
                     f"run; promotions per stream {kf.sum(1).tolist()}; launches {launches_b} = "
                     f"{STREAMS} x the single-stream path's; {captures_b} captures")

    # RGB-D: four streams, one chunk, each against its own rgbd_run
    states_r, (g, m, d, sg) = rgbd_streams(dev, r_grays, r_masks, r_counts, r_K, cfg_r)
    (st_r, res_r), _, launches_rb = run_path(
        "streams_rgbd", lambda: rgbd_run_batched(states_r, g, m, d, sg, r_K, cfg_r))
    launches_r1 = []
    for b, st in enumerate(unstack_states(states_r)):
        (st_1, res_1), _, launches = run_path(
            f"streams_rgbd_single_{b}", lambda st=st, b=b: rgbd_run(st, g[b], m[b], d[b], sg[b],
                                                                    r_K, cfg_r))
        launches_r1.append(launches)
        if not (same_tree(st_1, select_streams(st_r, b))
                and same_tree(res_1, select_streams(res_r, b))):
            raise AssertionError(f"streams: RGB-D stream {b} differs from its single-stream run")
    if launches_rb != {k: STREAMS * v for k, v in launches_r1[0].items()}:
        raise AssertionError(f"streams: RGB-D launches {launches_rb}, expected {STREAMS} x "
                             f"{launches_r1[0]}")
    phase("streams", f"rgbd: {STREAMS} streams x {STREAM_FRAMES} frames 512x424, each bitwise "
                     f"equal to its single-stream run; launches {launches_rb}")

    # Scaling turns (mono): stream b replays sequence b mod STREAMS.
    turns = []
    for b_count in SCALING:
        idx = [b % STREAMS for b in range(b_count)]
        g_s, m_s, K_s = grays[idx], masks[idx], Ks[idx]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        st = monocular_init_batched(g_s[:, 0], m_s[:, 0], K_s, cfg, device=dev)
        st1, _ = monocular_run_batched(st, g_s[:, 1:], m_s[:, 1:], K_s, cfg)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        monocular_run_batched(st1, g_s[:, 1:], m_s[:, 1:], K_s, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base_mem
        row = dict(streams=b_count, fps=b_count * STREAM_FRAMES / wall,
                   ms_per_frame_round=1e3 * wall / STREAM_FRAMES, init_capture_chunk_s=capture_s,
                   peak_bytes=peak, peak_bytes_per_stream=peak / b_count)
        if b_count not in [t["streams"] for t in turns]:
            ops, busy = device_profile(lambda: monocular_run_batched(
                st1, g_s[:, 1:5], m_s[:, 1:5], K_s, cfg), 1, True)
            row.update(busy_ms_per_frame_round=busy / 4e3, device_ops_per_frame_round=ops / 4)
        turns.append(row)
        phase("streams", f"B = {b_count}: {row['fps']:.1f} frames/s in all "
                         f"({row['ms_per_frame_round']:.3f} ms a frame of every stream), init + "
                         f"capture + first chunk {capture_s:.2f} s, peak memory "
                         f"{peak / 2**20:.1f} MiB ({peak / b_count / 2**20:.1f} MiB a stream)"
                         + (f", device busy {row['busy_ms_per_frame_round']:.3f} ms in "
                            f"{row['device_ops_per_frame_round']:g} ops a frame round"
                            if "busy_ms_per_frame_round" in row else "")
                         + f" on {card_line}")
    fps = {b: [t["fps"] for t in turns if t["streams"] == b] for b in sorted(set(SCALING))}
    phase("streams", f"aggregate frames/s by B (two turns each): {fps}; B = 8 over B = 1: "
                     f"{statistics.mean(fps[8]) / statistics.mean(fps[1]):.2f}x, B = 16 over B = "
                     f"8: {statistics.mean(fps[16]) / statistics.mean(fps[8]):.2f}x")
    return dict(mono=dict(streams=STREAMS, frames=STREAM_FRAMES, launches=launches_b,
                          single_launches=launches_1[0], captures=captures_b,
                          keyframes_per_stream=kf.sum(1).tolist()),
                rgbd=dict(streams=STREAMS, frames=STREAM_FRAMES, launches=launches_rb,
                          single_launches=launches_r1[0]),
                scaling=turns, fps_by_streams=fps, inputs=(grays, masks, Ks))


def parallel_phase(dev, card_line, cfg, cfg_r, inputs, rgbd_inputs):
    """Both stream drivers (``dvo_tpu_torch.parallel``) on a one-rank NCCL
    group over the ``stream`` mesh, each equal bitwise to the batched driver
    on the same streams (results, states, generator states)."""
    import torch.distributed as dist

    from dvo_tpu_torch.models.odometry import (
        monocular_init_batched,
        monocular_run_batched,
        rgbd_run_batched,
    )
    from dvo_tpu_torch.parallel import (
        initialize,
        monocular_run_streams,
        rgbd_run_streams,
        stream_mesh,
    )

    grays, masks, Ks = inputs
    initialize()            # one process: nothing to join
    mesh = stream_mesh()    # a one-rank group of its own
    backend = dist.get_backend()
    try:
        init = lambda: monocular_init_batched(grays[:, 0], masks[:, 0], Ks, cfg, device=dev)
        t0 = time.perf_counter()
        st_s, res_s = monocular_run_streams(mesh, init(), grays[:, 1:], masks[:, 1:], Ks, cfg)
        torch.cuda.synchronize()
        ms_streams = 1e3 * (time.perf_counter() - t0)
        st_b, res_b = monocular_run_batched(init(), grays[:, 1:], masks[:, 1:], Ks, cfg)
        gens = lambda st: [g.get_state() for g in st.generator]
        if not (same_tree(st_s, st_b) and same_tree(res_s, res_b)
                and all(torch.equal(a, b) for a, b in zip(gens(st_s), gens(st_b)))):
            raise AssertionError("parallel: monocular_run_streams differs from the batched driver")
        states_r, frames_r = rgbd_streams(dev, *rgbd_inputs, cfg_r)
        st_rs, res_rs = rgbd_run_streams(mesh, states_r, *frames_r, rgbd_inputs[3], cfg_r)
        st_rb, res_rb = rgbd_run_batched(states_r, *frames_r, rgbd_inputs[3], cfg_r)
        if not (same_tree(st_rs, st_rb) and same_tree(res_rs, res_rb)):
            raise AssertionError("parallel: rgbd_run_streams differs from the batched driver")
    finally:
        dist.destroy_process_group()
    phase("parallel", f"monocular_run_streams and rgbd_run_streams on a one-rank {backend} group "
                      f"({STREAMS} streams x {STREAM_FRAMES} frames each) equal bitwise to the "
                      f"batched drivers (results, states, generators); mono call with its "
                      f"captures and gathers {ms_streams:.1f} ms on {card_line}")
    return dict(backend=backend, ranks=1, streams=STREAMS, frames=STREAM_FRAMES,
                equal_to_batched=True, mono_call_ms=ms_streams)


# The sharded solvers (dvo_tpu_torch.parallel.{tracking,mapping,ba}) on the
# step of __graft_entry__.dryrun_multichip: tracking at 120x160 x 3 levels,
# the depth update against a 4-slot ring with a 0.2 m offset, BA over a
# window of 7 at 212x256 with 2 iterations; one (kf 2, tile 2) mesh.  And
# the track at the RGB-D path's level shapes (DVOConfig.rgbd(): 212x256 x 4;
# at tile 2 the two finer levels sharded, the two coarser on gn_level).
SHARD_H, SHARD_W, SHARD_LEVELS = 120, 160, 3
SHARD_RGBD_H, SHARD_RGBD_W = 212, 256
SHARD_MOTION = (0.008, -0.003, 0.004, 0.001, -0.002, 0.001)  # object frame vs reference
SHARD_MAP_OFFSET = (0.2, 0.0, 0.0, 0.0, 0.0, 0.0)
SHARD_RING = 4
SHARD_BA_H, SHARD_BA_W, SHARD_BA_WINDOW, SHARD_BA_ITERS = 212, 256, 7, 2
SHARD_MESH = (2, 2)          # (kf, tile)
SHARD_RANKS = 4
SHARD_JOIN_S = 600           # each rank is joined with this timeout
SHARD_TILES = (2, 4)         # row blocks of the kernels' checks
SHARD_GN_RTOL, SHARD_GN_ATOL = 1e-5, 1e-4      # block sums vs the whole launch
SHARD_XI_RTOL, SHARD_XI_ATOL = 1e-4, 2e-5      # sharded track vs the level kernel's
SHARD_TURNS = ("eager", "card", "card", "eager")  # the tracking part's routes, in turns
SHARD_BA_XI_TOL, SHARD_BA_COST_RTOL = 1e-3, 5e-3


def sharded_inputs(dev):
    """The sharded step's inputs on ``dev``, made from SEED as
    ``dryrun_multichip``'s: a textured 120x160 reference with a smooth depth
    and, one motion step away, its inverse warp (3 levels each); a ring of 4
    copies of the reference at poses 5 mm apart; a reset plane; a window of
    7 copies of a 212x256 textured keyframe at poses 4 mm apart; and a
    212x256 x 4 pair as the first, tracked with ``DVOConfig.rgbd()``'s
    tracker config."""
    from dvo_tpu_torch.config import BAConfig, DVOConfig, MapperConfig, TrackerConfig
    from dvo_tpu_torch.models.ba import window_from_history
    from dvo_tpu_torch.models.frame import build_frame_with_depth, device_int
    from dvo_tpu_torch.models.history import KeyframeHistory, push
    from dvo_tpu_torch.ops.depth_filter import draw_reset_depth

    rng = np.random.default_rng(SEED + 3)

    def scene(h, w):
        img = torch.tensor(texture(rng, h, w, terms=6, lo=0.1, hi=0.6), device=dev)
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        depth = torch.tensor(1.5 + 0.3 * np.sin(0.1 * xs) * np.cos(0.12 * ys), device=dev)
        K = torch.tensor([[1.0 * w, 0, w / 2], [0, 1.0 * w, h / 2], [0, 0, 1]], device=dev)
        return img, depth, torch.full_like(depth, 0.1), K

    def pair(h, w, levels):
        img, depth, sigma, K = scene(h, w)
        grays, masks = render(img, depth, K, SHARD_MOTION, 1)
        return (build_frame_with_depth(grays[0], masks[0], depth, sigma, K, levels, 0, 0),
                build_frame_with_depth(grays[1], masks[1], depth, sigma, K, levels, 0, 1))

    ref, obj = pair(SHARD_H, SHARD_W, SHARD_LEVELS)
    history = KeyframeHistory.create(SHARD_RING, SHARD_H, SHARD_W, device=dev)
    for i in range(SHARD_RING):
        xi = torch.tensor([0.005 * i, 0, 0, 0, 0, 0], dtype=torch.float32, device=dev)
        history = push(history, dataclasses.replace(ref, xi=xi, frame_id=device_int(i, dev)))
    cfg_m = MapperConfig()
    reset = draw_reset_depth((SHARD_H, SHARD_W), cfg_m.depth_filter,
                             torch.Generator(device=dev).manual_seed(SEED), dev)
    b_img, b_depth, b_sigma, b_K = scene(SHARD_BA_H, SHARD_BA_W)
    ones = torch.ones(b_img.shape, dtype=torch.bool, device=dev)
    b_ref = build_frame_with_depth(b_img, ones, b_depth, b_sigma, b_K, 1, 0, 0)
    ring = KeyframeHistory.create(8, SHARD_BA_H, SHARD_BA_W, device=dev)
    for i in range(SHARD_BA_WINDOW):
        xi = torch.tensor([0.004 * i, 0.001 * i, 0, 0, 0, 0], dtype=torch.float32, device=dev)
        ring = push(ring, dataclasses.replace(b_ref, xi=xi, frame_id=device_int(i, dev)))
    window = window_from_history(ring, b_K, SHARD_BA_WINDOW)
    cfg_r = DVOConfig.rgbd()
    ref_r, obj_r = pair(SHARD_RGBD_H, SHARD_RGBD_W, cfg_r.pyramid.levels)
    return dict(obj=obj, ref=ref, history=history, reset=reset, window=window,
                cfg_t=TrackerConfig(), cfg_m=cfg_m,
                cfg_ba=BAConfig(window=SHARD_BA_WINDOW, iterations=SHARD_BA_ITERS),
                obj_r=obj_r, ref_r=ref_r, cfg_tr=cfg_r.tracker)


def sharded_step(mesh, inp):
    """``dryrun_multichip``'s step through the port's sharded functions on
    ``mesh``: ``sharded_track``, ``sharded_depth_update`` at the tracked pose
    plus SHARD_MAP_OFFSET (tracking alone converges to the small motion,
    whose baseline observes little), ``bundle_adjust_sharded`` over ``kf``;
    then ``sharded_track`` on the RGB-D pair (part ``tracking_rgbd``).
    Each part runs with the launch counts set to 0 just before and read just
    after.  Returns (outputs, ms by part, launches by part)."""
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.parallel import bundle_adjust_sharded, sharded_depth_update, sharded_track

    ms, launches = {}, {}

    def part(name, fn):
        out, secs, launches[name] = run_path(name, fn)
        ms[name] = 1e3 * secs
        return out

    xi = part("tracking", lambda: sharded_track(inp["obj"], inp["ref"], inp["cfg_t"], mesh))
    xi_map = lie.compose(xi, torch.tensor(SHARD_MAP_OFFSET, device=xi.device))
    base = inp["ref"].base
    age0 = torch.zeros(base.shape, dtype=torch.int32, device=xi.device)
    d, s, a, st = part("mapping", lambda: sharded_depth_update(
        inp["obj"].base, xi_map, xi_map, base.depth, base.sigma, age0, inp["history"],
        inp["reset"], inp["cfg_m"], mesh))
    ba = part("ba", lambda: bundle_adjust_sharded(inp["window"], inp["cfg_ba"], mesh, axis="kf"))
    xi_r = part("tracking_rgbd", lambda: sharded_track(inp["obj_r"], inp["ref_r"], inp["cfg_tr"],
                                                        mesh))
    out = dict(xi=xi, xi_rgbd=xi_r, xi_map=xi_map, depth=d, sigma=s, age=a,
               stats=torch.stack([getattr(st, k) for k in STAT_NAMES]),
               ba_xi=ba.xi, ba_depth=ba.depth, ba_costs=ba.costs, ba_counts=ba.counts)
    return out, ms, launches


def sharded_references(inp, out):
    """The single-device port on the step's inputs: ``track`` (the level
    kernel), ``depth_update`` at the pose the sharded step mapped at,
    ``bundle_adjust``, and ``track`` on the RGB-D pair.  Returns (the outputs, each part's ms: host clock
    around the second of two calls, ending in a synchronise)."""
    from dvo_tpu_torch.models.ba import bundle_adjust
    from dvo_tpu_torch.models.mapper import depth_update
    from dvo_tpu_torch.models.tracker import track

    base = inp["ref"].base
    age0 = torch.zeros(base.shape, dtype=torch.int32, device=base.depth.device)
    xi_map = out["xi_map"].to(base.depth.device)
    parts = dict(
        tracking=lambda: track(inp["obj"], inp["ref"], inp["cfg_t"]).xi,
        mapping=lambda: depth_update(inp["obj"].base, xi_map, xi_map, base.depth, base.sigma,
                                     age0, inp["history"], inp["reset"], inp["cfg_m"]),
        ba=lambda: bundle_adjust(inp["window"], inp["cfg_ba"]),
        tracking_rgbd=lambda: track(inp["obj_r"], inp["ref_r"], inp["cfg_tr"]).xi)
    got, ms = {}, {}
    for name, fn in parts.items():
        fn()
        got[name], secs, _ = run_path(name, fn)
        ms[name] = 1e3 * secs
    d, s, a, st = got["mapping"]
    ba = got["ba"]
    return dict(xi=got["tracking"], xi_rgbd=got["tracking_rgbd"], depth=d, sigma=s, age=a,
                stats=torch.stack([getattr(st, k) for k in STAT_NAMES]),
                ba_xi=ba.xi, ba_depth=ba.depth, ba_costs=ba.costs, ba_counts=ba.counts), ms


def check_sharded_result(label, got, want):
    """The sharded step's outputs against the single-device port's:
    both tracks within SHARD_XI_*, the maps and counts bitwise, BA's twists
    within SHARD_BA_XI_TOL and its costs within SHARD_BA_COST_RTOL.
    Returns the differences."""
    got = {k: v.to(want["depth"].device) for k, v in got.items()}
    dxi = {k: track_within(f"sharded {label}", k, got[k], want[k]) for k in ("xi", "xi_rgbd")}
    for k in ("depth", "sigma", "age", "stats"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"sharded {label}: mapping {k} differs from depth_update's")
    dba = (got["ba_xi"] - want["ba_xi"]).abs().max().item()
    dcost = ((got["ba_costs"] - want["ba_costs"]).abs() / want["ba_costs"].abs()).max().item()
    if not (dba <= SHARD_BA_XI_TOL and dcost <= SHARD_BA_COST_RTOL):
        raise AssertionError(f"sharded {label}: BA xi {dba:.3g}, costs {dcost:.3g}")
    if tuple(got["ba_depth"].shape) != (SHARD_BA_WINDOW, SHARD_BA_H, SHARD_BA_W) or \
            not bool(torch.isfinite(got["ba_depth"]).all()):
        raise AssertionError(f"sharded {label}: BA depth {tuple(got['ba_depth'].shape)}")
    return dict(track_max_dxi=dxi["xi"], track_rgbd_max_dxi=dxi["xi_rgbd"], ba_max_dxi=dba,
                ba_costs_max_rel=dcost, mapping_bitwise=True, observed=got["stats"].tolist())


def track_within(label, what, got, want):
    """A sharded track's twist against another's within SHARD_XI_*;
    returns max |d xi|."""
    dxi = (got - want).abs()
    if not bool((dxi <= SHARD_XI_ATOL + SHARD_XI_RTOL * want.abs()).all()):
        raise AssertionError(f"{label}: {what} {got.tolist()} vs {want.tolist()}")
    return dxi.max().item()


def sharded_rank(folder: str, nccl: bool) -> None:
    """One rank of the sharded step (``--sharded-rank FOLDER``, started by
    ``spawn_sharded``): joins the group from the environment — NCCL on the
    rank's card (``--nccl``), else gloo with every rank on card 0 — runs the
    step twice (the first warms the group and the kernels) and saves the
    second's outputs, ms and launches to FOLDER/rank<r>.pt."""
    import torch.distributed as dist

    from dvo_tpu_torch.parallel import initialize, make_mesh

    if not torch.cuda.is_available():
        raise SystemExit("the sharded step needs a CUDA device")
    device = "cuda" if nccl else "cpu"
    initialize(device=device)
    dev = torch.device("cuda", torch.cuda.current_device() if nccl else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mesh = make_mesh(SHARD_MESH, ("kf", "tile"), device)
        inp = sharded_inputs(dev)
        sharded_step(mesh, inp)
        out, ms, launches = sharded_step(mesh, inp)
        torch.save(dict(out={k: v.cpu() for k, v in out.items()}, ms=ms, launches=launches,
                        backend=dist.get_backend(), device=str(dev)),
                   os.path.join(folder, f"rank{dist.get_rank()}.pt"))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_sharded(nccl: bool) -> list:
    """SHARD_RANKS processes of ``sharded_rank``: on NCCL one per card
    through ``torchrun --nproc-per-node``, else on gloo, all on card 0 (NCCL
    refuses two ranks on one card).  Each is joined with SHARD_JOIN_S; a
    rank that fails or hangs fails the phase and every rank is stopped.
    Returns each rank's saved dict, in rank order."""
    here = os.path.dirname(os.path.abspath(__file__))
    folder = tempfile.mkdtemp(prefix="dvo_sharded_")
    me = [os.path.abspath(__file__), "--sharded-rank", folder]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               OMP_NUM_THREADS="1")
    if nccl:
        cmds = [[sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(SHARD_RANKS), *me, "--nccl"]]
        envs = [env]
    else:
        cmds = [[sys.executable, *me]] * SHARD_RANKS
        envs = [dict(env, RANK=str(r), LOCAL_RANK="0", WORLD_SIZE=str(SHARD_RANKS))
                for r in range(SHARD_RANKS)]
    procs = [subprocess.Popen(c, cwd=here, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c, e in zip(cmds, envs)]
    errors = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=SHARD_JOIN_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"sharded: process {r} did not finish in {SHARD_JOIN_S} s")
            if p.returncode != 0:
                errors.append(f"process {r} exit {p.returncode}: {err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise AssertionError("sharded: " + "\n".join(errors))
    ranks = [torch.load(os.path.join(folder, f"rank{r}.pt")) for r in range(SHARD_RANKS)]
    for r, got in enumerate(ranks[1:], 1):
        for k, v in got["out"].items():
            if not torch.equal(v, ranks[0]["out"][k]):
                raise AssertionError(f"sharded: rank {r}'s {k} differs from rank 0's")
    return ranks


def sharded_kernel_checks(card_line, warm, gray, mask, K, cfg, plane_args, kernels):
    """``csrc/gn.cu`` and the fused ``csrc/epipolar.cu`` entry on row blocks,
    on one card without collectives.  GN: T = 2 and 4 blocks of the mono
    frame's two finer levels (the next frame against the warm state), each
    block against its plain version (check_gn's tolerance) and the blocks'
    sums against the whole-image launch (SHARD_GN_*, the count exact).
    Epipolar: T = 2 and 4 blocks of the analytic rig's depth update, each
    equal bitwise to the whole-image launch's rows and held against its
    plain version, the blocks' counts adding up to the whole's.  Adds the
    row-block timings to the ``gn`` and ``epipolar_fused`` entries."""
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.models import mapper
    from dvo_tpu_torch.models.frame import build_tracking_frame
    from dvo_tpu_torch.models.tracker import level_planes, track
    from dvo_tpu_torch.ops.cuda import epipolar

    frame = build_tracking_frame(gray, mask, K, cfg.pyramid.levels, 0, warm.frame_count)
    T_inv = lie.se3_exp(-track(frame, warm.ref, cfg.tracker).xi)
    entries = {k["name"]: k for k in kernels}
    gn_rows = {}
    for level in (len(frame.scenes) - 1, len(frame.scenes) - 2):
        ref = warm.ref.scenes[level]
        h, w = ref.shape
        gn_rows.update(check_gn_blocks(f"{h}x{w}", level_planes(frame.scenes[level], ref), ref.K,
                                       T_inv, level, cfg.tracker))
    # The finest level's second block of four: the row block a sharded track
    # launches at tile 4.
    fine = len(frame.scenes) - 1
    ref = warm.ref.scenes[fine]
    row = time_gn_block(card_line, level_planes(frame.scenes[fine], ref), ref.K, T_inv, fine,
                        cfg.tracker, 4)
    entries["gn"]["row_block"] = dict(row, checks=gn_rows)

    # --- the fused epipolar entry on row blocks of the analytic rig ---
    obj, obj_xi, rel_xi, depth, sigma, age, hist, reset, cfg_m = plane_args
    ring = (hist.gray, hist.gx, hist.gy, hist.gmask)
    h, w = depth.shape
    whole = mapper.depth_update(*plane_args)
    whole_stats = [int(getattr(whole[3], k)) for k in STAT_NAMES]
    epi_rows, identical = {}, True
    for tiles in SHARD_TILES:
        bh = h // tiles
        counts = np.zeros(4, int)
        for t in range(tiles):
            rows = slice(t * bh, (t + 1) * bh)
            kw = dict(y_offset=t * bh, full_shape=(h, w))
            sub = (obj, obj_xi, rel_xi, depth[rows], sigma[rows], age[rows], hist, reset[rows],
                   cfg_m)
            got = mapper.depth_update(*sub, **kw)
            if not all(torch.equal(a, b[rows]) for a, b in zip(got[:3], whole[:3])):
                raise AssertionError(f"epipolar block {t} of {tiles}: differs from the whole "
                                     "launch's rows")
            fields, aged_out = mapper.epipolar_fields(*sub, **kw)
            want = epipolar.epipolar_update_plain(fields, *ring, cfg_m, full_shape=(h, w))
            stats = [int(getattr(got[3], k)) for k in STAT_NAMES]
            plain_stats = want[3].tolist() + [int(aged_out)]
            compare_maps("epipolar block depth", got[0], want[0])
            compare_maps("epipolar block sigma", got[1], want[1])
            for k, (a, b) in enumerate(zip(stats, plain_stats)):
                if abs(a - b) > max(2, STATS_TOL * b):
                    raise AssertionError(f"epipolar block {STAT_NAMES[k]}: {a} vs {b}")
            identical = identical and stats == plain_stats and all(
                torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
            counts += stats
        if counts.tolist() != whole_stats:
            raise AssertionError(f"epipolar {tiles} blocks: counts {counts.tolist()} vs the "
                                 f"whole launch's {whole_stats}")
        epi_rows[f"{h}x{w} T={tiles}"] = dict(stats=counts.tolist())
        phase("sharded", f"epipolar fused entry, {tiles} row blocks of the analytic rig's "
                         f"{h}x{w}: every block equal bitwise to the whole launch's rows, counts "
                         f"{counts.tolist()} add up to the whole's; bit-identical to the plain "
                         f"version so far: {identical}")
    bh = h // 4
    table = mapper.pose_table(obj.K, obj_xi, rel_xi, hist)
    fused = lambda: epipolar.epipolar_fused(
        obj.gray, obj.mask, depth[bh:2 * bh], sigma[bh:2 * bh], age[bh:2 * bh],
        reset[bh:2 * bh], table, *ring, hist.head, hist.count, cfg_m, y_offset=bh,
        full_shape=(h, w))
    ops, us = device_profile(fused, 20, True)
    entries["epipolar_fused"]["row_block"] = dict(
        shape=f"{bh}x{w}", y_offset=bh, device_us=us, device_launches=ops, ms=timed(fused),
        bit_identical=identical, checks=epi_rows)
    phase("sharded", f"epipolar fused entry row block {bh}x{w} at row {bh}: device {us:.2f} us "
                     f"in {ops:g} ops on {card_line}")
    return dict(gn=gn_rows, epipolar=epi_rows, epipolar_bit_identical=identical)


def check_gn_blocks(label, planes, K, T_inv, level, cfg, per_part=False):
    """``csrc/gn.cu`` on SHARD_TILES row blocks of one level (``planes``,
    whole): each block against its plain version (check_gn's tolerance),
    the blocks' sums against the whole-image launch (SHARD_GN_*, the count
    exact), and a second launch on the same inputs equal bit for bit, for
    the whole image and for every block.  With ``per_part`` the sums'
    SHARD_GN_RTOL is taken of each part's (H, g, the residual sum) largest
    entry rather than of each entry: at 212x256 an entry of H is a sum of
    ~5e4 terms that nearly cancel, and the blocks' float32 sums, added in
    another order, differ by more than 1e-5 of such an entry (by 8 on a
    4-block split, measured).  Returns a row per tile count."""
    from dvo_tpu_torch.ops.cuda import gn

    h, w = planes[2].shape
    args = (K, T_inv, level, cfg)
    whole = gn.gn_terms(*planes, *args)
    if not all(torch.equal(a, b) for a, b in zip(whole, gn.gn_terms(*planes, *args))):
        raise AssertionError(f"gn {label}: two launches on the same inputs differ")
    out = {}
    for tiles in SHARD_TILES:
        bh = h // tiles
        sums, worst = None, 0.0
        for t in range(tiles):
            rows = slice(t * bh, (t + 1) * bh)
            block = [p[rows] for p in planes[:4]] + list(planes[4:])
            kw = dict(y_offset=t * bh, full_shape=(h, w))
            got = gn.gn_terms(*block, *args, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, gn.gn_terms(*block, *args, **kw))):
                raise AssertionError(f"gn {label} block {t} of {tiles}: two launches differ")
            want = gn.gn_terms_plain(*block, *args, **kw)
            for a, b in zip(got[:3], want[:3]):
                worst = max(worst, (a - b).abs().max().item()
                            / max(b.abs().max().item(), 1e-12))
            if worst > GN_REL_TOL or abs(int(got[3]) - int(want[3])) > max(
                    2, GN_COUNT_TOL * bh * w):
                raise AssertionError(f"gn block {t} of {tiles} at {label}: relative error "
                                     f"{worst:.3g}, count {int(got[3])} vs {int(want[3])}")
            sums = got if sums is None else [x + y for x, y in zip(sums, got)]
        if int(sums[3]) != int(whole[3]):
            raise AssertionError(f"gn {tiles} blocks at {label}: count {int(sums[3])} vs "
                                 f"the whole launch's {int(whole[3])}")
        dsum, by_part = 0.0, {}
        for part, a, b in zip(("H", "g", "residual_sum"), sums[:3], whole[:3]):
            scale = b.abs().max() if per_part else b.abs()
            if not bool(((a - b).abs() <= SHARD_GN_ATOL + SHARD_GN_RTOL * scale).all()):
                raise AssertionError(f"gn {tiles} blocks at {label}: sums differ from the "
                                     f"whole launch's by {(a - b).abs().max().item():.3g}")
            dsum = max(dsum, (a - b).abs().max().item())
            by_part[part] = dict(max_abs_diff=(a - b).abs().max().item(),
                                 max_abs_entry=b.abs().max().item())
        out[f"{label} T={tiles}"] = dict(block_vs_plain_max_rel=worst,
                                         sums_vs_whole_max_abs=dsum, count=int(whole[3]),
                                         sums_vs_whole_by_part=by_part,
                                         limit_per_part=per_part, repeats_bitwise=True)
        parts = ", ".join(f"{k} {v['max_abs_diff']:.4g} of max |entry| {v['max_abs_entry']:.4g}"
                          for k, v in by_part.items())
        phase("sharded", f"gn {tiles} row blocks of {label} (offsets "
                         f"{[t * bh for t in range(tiles)]}): each block within {worst:.3g} of "
                         f"its plain version and equal bitwise to a second launch, the sums "
                         f"within {dsum:.3g} of the whole launch's ({parts}; limit "
                         f"{'per part' if per_part else 'per entry'}), count {int(sums[3])} "
                         f"equal")
    return out


def time_gn_block(card_line, planes, K, T_inv, level, cfg, tiles):
    """Block 1 of ``tiles`` of one level (the row block a rank launches
    at that tile count): one ``gn.cu`` launch (``terms_launcher``) and the
    ``gn_terms`` call (the launch, H's mirror and the count's cast) under
    the profiler and CUDA events, the plain version, the bound from
    ``work()`` and the launch floor.  Returns the row."""
    from dvo_tpu_torch.ops.cuda import _build, gn
    from dvo_tpu_torch.tools import framebuild_floor

    h, w = planes[2].shape
    bh = h // tiles
    block = tuple(p[bh:2 * bh] for p in planes[:4]) + tuple(planes[4:])
    kw = dict(y_offset=bh, full_shape=(h, w))
    launch = gn.terms_launcher(block, K, level, cfg, **kw)
    sums = torch.empty(gn.N_SUMS, device=K.device)
    call = lambda: gn.gn_terms(*block, K, T_inv, level, cfg, **kw)
    plain = lambda: gn.gn_terms_plain(*block, K, T_inv, level, cfg, **kw)
    count = int(plain()[3])
    ops, us = device_profile(lambda: launch(T_inv, sums), 20, True)
    call_ops, call_us = device_profile(call, 20, True)
    nbytes, flops = gn.work((bh, w), count)
    bound, by = _build.bound_us(nbytes, flops)
    fl = framebuild_floor.floor_us(nbytes, device_profile)
    row = dict(shape=f"{bh}x{w}", y_offset=bh, blocks=gn.num_blocks(bh * w), count=count,
               device_us=us, device_ops=ops, gn_terms_device_us=call_us,
               gn_terms_device_ops=call_ops, ms=timed(lambda: launch(T_inv, sums)),
               gn_terms_ms=timed(call), plain_ms=timed(plain), bytes=nbytes, flops=flops,
               bound_us=bound, bound_by=by, launch_floor_us=fl["empty_us"],
               copy_floor_us=fl["copy_us"])
    phase("sharded", f"gn.cu on the {bh}x{w} row block at row {bh} ({row['blocks']} thread "
                     f"blocks): device {us:.2f} us in {ops:g} op (gn_terms: {call_us:.2f} us in "
                     f"{call_ops:g} ops), call {row['ms']:.4f} ms, gn_terms {row['gn_terms_ms']:.4f}"
                     f" ms, plain {row['plain_ms']:.4f} ms; bound {bound:.3f} us ({by}), launch "
                     f"floor {fl['empty_us']:.2f} us on {card_line}")
    return row


def check_gn_step(card_line, planes, K, level, cfg):
    """``csrc/gn.cu``'s step kernel against ``step_plain`` (``gn_step_plain``
    on the same buffers) on the card, from the sums of one ``gn.cu`` launch
    at a small twist: the seed (the level's first state from xi0); step 0
    from it; step 1 from the state step 0 left;
    the same step with the state's done flag set (xi kept bit for bit, the
    statistics recorded and equal bitwise to the unfrozen step's); step 1 on
    zero sums (no valid pixel) and on sums whose H is -I (no Cholesky
    factor).  xi within GN_LEVEL_XI_TOL, statistics within
    GN_LEVEL_STAT_TOL of the plain maximum, counts and done flags equal.
    Returns the kernel's entry for the result line."""
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.ops.cuda import gn, gn_level
    from dvo_tpu_torch.tools import framebuild_floor

    dev, n = K.device, cfg.max_iterations
    xi0 = torch.tensor([0.003, -0.001, 0.002, 0.0005, -0.001, 0.0], device=dev)
    sums = torch.empty(gn.N_SUMS, device=dev)
    gn.terms_launcher(planes, K, level, cfg)(lie.se3_exp(-xi0), sums)
    eye = torch.eye(6, device=dev)
    zeros = torch.zeros(gn.N_SUMS, device=dev)
    not_pd = gn.pack_sums(-eye, torch.ones(6, device=dev), torch.tensor(2.0, device=dev),
                          torch.tensor(5, dtype=torch.int32, device=dev))

    def run(route, step_sums, it, state0):
        state = state0.clone()
        stats = torch.zeros(2 * n, device=dev)
        counts = torch.zeros(n, dtype=torch.int32, device=dev)
        if route == "kernel":
            gn_level.step_launcher(step_sums, xi0, state, stats[:n], stats[n:], counts, cfg)(it)
        else:
            gn_level.step_plain(step_sums, xi0, state, stats[:n], stats[n:], counts, it, cfg)
        return state, stats[[it, n + it]], counts[it]

    blank = torch.full((gn_level.STATE,), float("nan"), device=dev)
    seeded = run("kernel", sums, gn_level.SEED, blank)[0]
    after0 = run("kernel", sums, 0, seeded)[0]
    after0[18] = 0.0            # step 1 not frozen, whether or not step 0 converged
    frozen_in = after0.clone()
    frozen_in[18] = 1.0
    cases = dict(seed=(sums, gn_level.SEED, blank), step0=(sums, 0, seeded),
                 step1=(sums, 1, after0), frozen=(sums, 1, frozen_in),
                 zero_count=(zeros, 1, after0), not_pd=(not_pd, 1, after0))
    got_by, max_dxi, max_rel = {}, 0.0, 0.0
    for name, (step_sums, it, state0) in cases.items():
        got = run("kernel", step_sums, it, state0)
        want = run("plain", step_sums, it, state0)
        torch.cuda.synchronize()
        got_by[name] = got
        dxi = (got[0][:18] - want[0][:18]).abs().max().item()   # T_inv rows and xi
        fin = torch.isfinite(want[1])
        rel = ((got[1] - want[1]).abs()[fin].max()
               / want[1].abs()[fin].max().clamp(min=1e-12)).item() if bool(fin.any()) else 0.0
        nan_same = torch.equal(torch.isnan(got[1]), torch.isnan(want[1]))
        if not (dxi <= GN_LEVEL_XI_TOL and rel <= GN_LEVEL_STAT_TOL and nan_same
                and int(got[2]) == int(want[2]) and got[0][18].item() == want[0][18].item()):
            raise AssertionError(f"gn_step {name}: |d state| {dxi:.3g}, statistics "
                                 f"{got[1].tolist()}"
                                 f" vs {want[1].tolist()}, count {int(got[2])} vs "
                                 f"{int(want[2])}, done {got[0][18].item()} vs "
                                 f"{want[0][18].item()}")
        max_dxi, max_rel = max(max_dxi, dxi), max(max_rel, rel)
    frozen, step1 = got_by["frozen"], got_by["step1"]
    if not (torch.equal(frozen[0][12:18], frozen_in[12:18]) and frozen[0][18].item() == 1.0
            and torch.equal(frozen[1], step1[1]) and int(frozen[2]) == int(step1[2]) > 0):
        raise AssertionError(f"gn_step: the frozen step moved xi or masked its statistics: "
                             f"{frozen} vs {step1}")
    zc, npd = got_by["zero_count"], got_by["not_pd"]
    if not (zc[1][0].item() == -1.0 and zc[1][1].item() == 0.0 and int(zc[2]) == 0
            and zc[0][18].item() == 1.0 and bool(torch.isnan(npd[1][1]))
            and torch.equal(npd[0][12:18], after0[12:18]) and npd[0][18].item() == 0.0):
        raise AssertionError(f"gn_step: zero count {zc}, no factor {npd}")

    state = after0.clone()
    stats = torch.zeros(2 * n, device=dev)
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    step = gn_level.step_launcher(sums, xi0, state, stats[:n], stats[n:], counts, cfg)
    ops, us = device_profile(lambda: step(1), 20, True)
    ms = timed(lambda: step(1))
    plain_ms = timed(lambda: gn_level.step_plain(sums, xi0, state, stats[:n], stats[n:], counts,
                                                 1, cfg))
    nbytes, flops = gn_level.step_work()
    floor = framebuild_floor.floor_us(nbytes, device_profile)["empty_us"]
    phase("sharded", f"gn_step kernel vs step_plain: seed, step 0, step 1, frozen (xi kept "
                     f"bitwise, statistics recorded), zero count, no Cholesky factor: |d T_inv, "
                     f"xi| <= "
                     f"{max_dxi:.3g}, statistics within {max_rel:.3g}; device {us:.2f} us in "
                     f"{ops:g} op (launch floor {floor:.2f} us), call {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms on {card_line}")
    return with_bound(dict(
        name="gn_step", route="cuda", source="dvo_tpu_torch/csrc/gn.cu",
        replaces="dvo_tpu/ops/pallas/gn.py:45 (with the sharded scan body around it, "
                 "dvo_tpu/parallel/tracking.py:83-95)",
        no_library_call="a 6x6 Cholesky solve, an SE(3) exp/log composition and the scan's "
                        "freeze on 29 sums",
        max_abs_err=max_dxi, max_rel_err=max_rel, ms=ms, plain_ms=plain_ms, device_us=us,
        device_launches=ops, cases=list(cases)), nbytes, flops)


def eager_sharded_track_level(obj, ref, xi0, level_index, cfg, mesh, axis="tile"):
    """The eager yardstick of a sharded level (the loop before the step
    kernel): per step ``gn.gn_terms`` on the rank's block, its 44 sums
    all-reduced, then ``gn_iteration``'s solve and compose and the scan's
    freeze in PyTorch ops, ~250 ops a step.  Same contract as
    ``parallel.tracking.sharded_track_level``."""
    from dvo_tpu_torch.models.tracker import level_planes
    from dvo_tpu_torch.ops.cuda.gn_level import gn_iteration
    from dvo_tpu_torch.parallel import tracking

    planes = level_planes(obj, ref)
    terms = tracking._sharded_terms(mesh, axis)
    xi = xi0
    done = torch.zeros((), dtype=torch.bool, device=xi0.device)
    res, upd, cnt = [], [], []
    for _ in range(cfg.max_iterations):
        new_xi, mean_res, u, count, converged = gn_iteration(planes, ref.K, xi, level_index, cfg,
                                                            terms)
        xi = torch.where(done, xi, new_xi)
        done = done | converged
        res.append(mean_res)
        upd.append(u)
        cnt.append(count)
    return xi, (torch.stack(res), torch.stack(upd), torch.stack(cnt))


def sharded_launches_expected(frame, tiles, cfg):
    """The launches of a sharded track of ``frame`` at ``tiles`` row
    blocks: ``gn`` once per step of every sharded level, ``gn_step`` once
    per step and once per sharded level (the seed of its state),
    ``gn_level`` once per other level."""
    sharded = sum(1 for sc in frame.scenes if sc.shape[0] % tiles == 0
                  and sc.shape[0] >= 4 * tiles)
    steps = sharded * cfg.max_iterations
    return dict(gn=steps, gn_step=steps + sharded, gn_level=len(frame.scenes) - sharded)


def require_track_launches(label, launches, inp, tiles):
    for part, frame, cfg in (("tracking", inp["ref"], inp["cfg_t"]),
                             ("tracking_rgbd", inp["ref_r"], inp["cfg_tr"])):
        want = sharded_launches_expected(frame, tiles, cfg)
        got = {k: launches[part][k] for k in want}
        if got != want:
            raise AssertionError(f"sharded {label}: {part} launched {got}, expected {want}")


def sharded_phase(dev, card_line):
    """The sharded solvers.  (1) Without collectives: ``gn.cu`` on row
    blocks of the 120x160 level and the RGB-D 212x256 level
    (``check_gn_blocks``), timed at the 30x160 block (tile 4 of 120) and the
    106x256 block (tile 2 of 212) (``time_gn_block``), and the step kernel
    against its plain version (``check_gn_step``).  (2) On a one-rank NCCL
    group: the step, each part against the single-device port — both tracks
    within SHARD_XI_* of ``track`` (the level kernel) and of the stepwise
    track, and equal bitwise over two calls; mapping equal bitwise to
    ``depth_update``, BA to ``bundle_adjust`` — with no host sync in the
    tracking loop, ``gn`` and ``gn_step`` once per step, the device ops of
    a GN step counted; then the tracking part on the eager loop (the plain
    yardstick ``eager_sharded_track_level``) and on
    the card's route in turns (SHARD_TURNS).  (3) The step in SHARD_RANKS
    processes on this card in a gloo group on the (kf 2, tile 2) mesh, held
    against the single-device port; (4) with four cards, the same on NCCL
    through ``torchrun``.  Returns the phase's summary, the step's launches
    by path ((2)'s and (3)'s rank 0's, each summed over the step's parts)
    and the kernel rows ({"gn": the timed blocks, "gn_step": its entry})."""
    import torch.distributed as dist

    from dvo_tpu_torch import lie
    from dvo_tpu_torch.models.tracker import level_planes, track
    from dvo_tpu_torch.parallel import make_mesh, sharded_track, sharded_track_level
    from dvo_tpu_torch.parallel import tracking

    summary = {}
    inp = sharded_inputs(dev)
    # (1) the kernels on row blocks, at the poses the single-card track finds
    checks, timed_blocks = {}, {}
    for obj, ref, cfg, tiles in ((inp["obj"], inp["ref"], inp["cfg_t"], 4),
                                 (inp["obj_r"], inp["ref_r"], inp["cfg_tr"], 2)):
        fine = len(ref.scenes) - 1
        T_inv = lie.se3_exp(-track(obj, ref, cfg).xi)
        planes = level_planes(obj.scenes[fine], ref.scenes[fine])
        h, w = ref.scenes[fine].shape
        checks.update(check_gn_blocks(f"{h}x{w}", planes, ref.scenes[fine].K, T_inv, fine, cfg,
                                      per_part=h * w > SHARD_H * SHARD_W))
        row = time_gn_block(card_line, planes, ref.scenes[fine].K, T_inv, fine, cfg, tiles)
        timed_blocks[row["shape"]] = row
    fine = SHARD_LEVELS - 1
    step_entry = check_gn_step(card_line, level_planes(inp["obj"].scenes[fine],
                                                       inp["ref"].scenes[fine]),
                               inp["ref"].scenes[fine].K, fine, inp["cfg_t"])
    summary["gn_blocks"] = checks

    # (2) one rank, NCCL
    mesh = make_mesh((1, 1), ("kf", "tile"))   # a one-rank NCCL group of its own
    track_call = lambda: sharded_track(inp["obj"], inp["ref"], inp["cfg_t"], mesh)
    try:
        backend = dist.get_backend()
        first, _, _ = sharded_step(mesh, inp)
        out, ms, launches = sharded_step(mesh, inp)
        syncs = count_syncs(track_call)
        xi_zero = torch.zeros(6, device=dev)
        level_call = lambda: sharded_track_level(inp["obj"].scenes[fine], inp["ref"].scenes[fine],
                                                 xi_zero, fine, inp["cfg_t"], mesh)
        ops, busy_us = device_profile(level_call, 3, True)
        turns = {"eager": [], "card": []}
        for route in SHARD_TURNS:
            with (patched(tracking, "sharded_track_level", eager_sharded_track_level)
                  if route == "eager" else contextlib.nullcontext()):
                xi_t, secs, turn_launches = run_path(f"sharded_tracking_{route}", track_call)
            turns[route].append(1e3 * secs)
            track_within("sharded (one rank)", f"the {route} route's track", xi_t, out["xi"])
            if route == "eager" and (turn_launches["gn"] != launches["tracking"]["gn"]
                                     or turn_launches["gn_step"]):
                raise AssertionError(f"sharded: the eager loop launched {turn_launches}")
    finally:
        dist.destroy_process_group()
    steps_per_level = inp["cfg_t"].max_iterations
    ops_per_step = ops / steps_per_level   # the level's seed launch included
    require_track_launches("(one rank)", launches, inp, 1)
    if launches["mapping"]["epipolar"] == 0:
        raise AssertionError(f"sharded (one rank): epipolar never launched: {launches}")
    want, single_ms = sharded_references(inp, out)
    with stepwise_tracker():
        stepwise = track(inp["obj"], inp["ref"], inp["cfg_t"]).xi
        stepwise_r = track(inp["obj_r"], inp["ref_r"], inp["cfg_tr"]).xi
    dxi = dict(level_kernel=track_within("sharded (one rank)", "track", out["xi"], want["xi"]),
               stepwise=track_within("sharded (one rank)", "track vs stepwise", out["xi"],
                                     stepwise),
               rgbd_level_kernel=track_within("sharded (one rank)", "RGB-D track", out["xi_rgbd"],
                                              want["xi_rgbd"]),
               rgbd_stepwise=track_within("sharded (one rank)", "RGB-D track vs stepwise",
                                          out["xi_rgbd"], stepwise_r))
    repeats = torch.equal(first["xi"], out["xi"]) and torch.equal(first["xi_rgbd"],
                                                                  out["xi_rgbd"])
    bitwise = {k: torch.equal(out[k], want[k]) for k in (
        "depth", "sigma", "age", "stats", "ba_xi", "ba_depth", "ba_costs", "ba_counts")}
    if not all(bitwise.values()) or syncs or not repeats or ops_per_step > 3:
        raise AssertionError(f"sharded (one rank): bitwise {bitwise}, {syncs} host syncs in "
                             f"the tracking loop, tracks repeat bitwise: {repeats}, "
                             f"{ops_per_step:g} device ops a GN step")
    summary["one_rank"] = dict(backend=backend, ms=ms, launches=launches, syncs_tracking=syncs,
                               track_max_dxi=dxi, tracks_repeat_bitwise=repeats,
                               device_ops_per_gn_step=ops_per_step, device_ops_per_level=ops,
                               device_busy_us_per_gn_step=busy_us / steps_per_level,
                               tracking_ms_in_turns=turns)
    summary["single_device_ms"] = single_ms
    phase("sharded", f"one-rank {backend} group: sharded_track within {dxi['level_kernel']:.3g} "
                     f"of track (the level kernel) and {dxi['stepwise']:.3g} of the stepwise "
                     f"track, the RGB-D track within {dxi['rgbd_level_kernel']:.3g} and "
                     f"{dxi['rgbd_stepwise']:.3g}; both repeat bitwise; launches tracking "
                     f"{launches['tracking']}, tracking_rgbd {launches['tracking_rgbd']}; "
                     f"{syncs} host syncs; {ops_per_step:g} device ops and "
                     f"{busy_us / steps_per_level:.2f} device-busy us a GN step; "
                     f"sharded_depth_update equal to depth_update and bundle_adjust_sharded to "
                     f"bundle_adjust; ms {ms}, the single-device port's {single_ms}; tracking "
                     f"ms in turns (eager loop, card route): {turns} on {card_line}")

    # (3) four processes on this card, gloo; (4) four cards, NCCL
    runs = {"gloo": False} if torch.cuda.device_count() < SHARD_RANKS else {"gloo": False,
                                                                           "nccl": True}
    for name, nccl in runs.items():
        ranks = spawn_sharded(nccl)
        got = ranks[0]
        diffs = check_sharded_result(name, got["out"], sharded_references(inp, got["out"])[0])
        per_rank = [r["launches"] for r in ranks]
        summary[name] = dict(ranks=SHARD_RANKS, mesh=SHARD_MESH, backend=got["backend"],
                             devices=[r["device"] for r in ranks], ms=[r["ms"] for r in ranks],
                             launches=per_rank, **diffs)
        for r in per_rank:
            require_track_launches(name, r, inp, SHARD_MESH[1])
            if r["mapping"]["epipolar"] == 0:
                raise AssertionError(f"sharded {name}: epipolar never launched: {per_rank}")
        phase("sharded", f"{SHARD_RANKS} ranks, {got['backend']} on "
                         f"{sorted(set(r['device'] for r in ranks))}, mesh (kf, tile) "
                         f"{SHARD_MESH}: every rank equal; track within "
                         f"{diffs['track_max_dxi']:.3g} of the level kernel's, RGB-D track "
                         f"{diffs['track_rgbd_max_dxi']:.3g}, mapping bitwise "
                         f"(observed {diffs['observed'][0]}), BA xi within "
                         f"{diffs['ba_max_dxi']:.3g}, costs {diffs['ba_costs_max_rel']:.3g}; ms "
                         f"per part {[r['ms'] for r in ranks]}; launches of rank 0 "
                         f"{got['launches']} on {card_line}")
    if "nccl" not in runs:
        phase("sharded", f"four cards on NCCL: not measured ({torch.cuda.device_count()} card)")
    step = lambda parts: {k: sum(p[k] for p in parts.values()) for k in parts["tracking"]}
    return summary, {"sharded": step(launches),
                     "sharded_gloo_rank0": step(summary["gloo"]["launches"][0])}, dict(
        gn=timed_blocks, gn_step=step_entry)


def write_png(path, img) -> None:
    """``img`` as a PNG, written with the standard library's zlib (the card's
    machine may have no PIL): (H, W) uint8 or uint16 gray, or (H, W, 3)
    uint8 RGB; no interlace, filter 0 on every row."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    bits = 16 if img.dtype == np.uint16 else 8
    rows = img.astype(">u2" if bits == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    header = struct.pack(">IIBBBBB", w, h, bits, 2 if img.ndim == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_sequence(root, grays, counts=None, colors=None) -> str:
    """An info.txt sequence under ``root``: gray frames, or "gray depth"
    pairs with 16-bit depth counts; ``colors`` replaces the gray frames by
    RGB ones (the Kinect color camera)."""
    os.makedirs(root)
    frames = grays if colors is None else colors
    with open(os.path.join(root, "info.txt"), "w") as f:
        for i, img in enumerate(frames):
            write_png(os.path.join(root, f"c{i:04d}.png"), img)
            line = f"c{i:04d}.png"
            if counts is not None:
                write_png(os.path.join(root, f"d{i:04d}.png"), counts[i])
                line += f" d{i:04d}.png"
            f.write(line + "\n")
    return root


def write_calib(path, sections, extrinsic=None) -> str:
    """A calibration YAML: ``sections`` maps a name to (K, width, height);
    no distortion; ``extrinsic`` a 4x4 depth-to-color transform."""
    fmt = lambda a: ", ".join(repr(float(v)) for v in np.asarray(a, np.float32).ravel())
    with open(path, "w") as f:
        for name, (K, w, h) in sections.items():
            f.write(f"{name}:\n  K: [{fmt(K)}]\n  resolution: [{w}, {h}]\n")
        if extrinsic is not None:
            f.write(f"extrinsic:\n  invT: [{fmt(extrinsic)}]\n")
    return path


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def fixed_resets(planes):
    """The runner's monocular steps take their depth-filter reset planes
    from ``planes``, in step order, in place of drawing them from the
    state's generator: the same numbers on either device."""
    from dvo_tpu_torch.utils import runner

    used = 0

    def take(n, device):
        nonlocal used
        out = planes[used:used + n].to(device)
        used += n
        return out

    step, run = runner.monocular_step, runner.monocular_run
    with patched(runner, "monocular_step", lambda state, *a, **k: step(
            state, *a, reset_depth=take(1, state.ref.xi.device)[0], **k)), \
            patched(runner, "monocular_run", lambda state, grays, *a, **k: run(
                state, grays, *a, reset_depths=take(len(grays), state.ref.xi.device), **k)):
        yield


def cli_path(name, argv):
    """``dvo_tpu_torch.run.main(argv)`` in this process, as ``python -m
    dvo_tpu_torch.run`` runs it, with every launch count set to 0 just
    before.  The runner's frame stream is timed (decode, plus the remap when
    there is one).  Returns a dict: the JSON report, the runner's
    (timestamps, poses, secs), the state it checkpointed, launches, wall and
    decode seconds."""
    from dvo_tpu_torch import run
    from dvo_tpu_torch.utils import checkpoint, runner

    got = {"decode_s": 0.0}
    stream = runner._image_stream

    def timed_stream(*args, **kwargs):
        frames = stream(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            item = next(frames, None)
            got["decode_s"] += time.perf_counter() - t0
            if item is None:
                return
            yield item

    def capture(key, fn):
        def wrapper(*args, **kwargs):
            got[key] = fn(*args, **kwargs)
            return got[key]
        return wrapper

    def keep_state(path, state):
        got["state"] = state
        save(path, state)

    save = checkpoint.save_state
    out = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(runner, "_image_stream", timed_stream))
        stack.enter_context(patched(checkpoint, "save_state", keep_state))
        for fn in ("run_rgbd", "run_monocular", "run_kinect"):
            stack.enter_context(patched(runner, fn, capture("result", getattr(runner, fn))))
        stack.enter_context(contextlib.redirect_stdout(out))
        rc, got["wall_s"], got["launches"] = run_path(name, lambda: run.main(argv))
    if rc != 0:
        raise AssertionError(f"cli {name}: main returned {rc}")
    got["report"] = json.loads(out.getvalue().strip().splitlines()[-1])
    return got


def cli_phase(dev, card_line, grays, K, r_grays, r_counts, r_K, cfg, cfg_r, by_path, resets):
    """``python -m dvo_tpu_torch.run`` on the card: the RGB-D (chunks of
    24), mono (chunks of 24, with a checkpoint) and Kinect (both modes,
    chunks of 3) paths on PNG sequences written from the frames the earlier
    phases rendered.  Returns per-path numbers for the kernels line."""
    from dvo_tpu_torch.models.odometry import (
        _cull_chunk,
        monocular_step,
        raw_depth,
        rgbd_init,
        rgbd_run_raw,
    )
    from dvo_tpu_torch.ops.depth_filter import draw_reset_depth
    from dvo_tpu_torch.utils import runner
    from dvo_tpu_torch.utils.checkpoint import load_state

    route = runner.decode_route()
    phase("cli", f"decode route: {route}")
    r_grays, r_counts = r_grays.numpy(), r_counts.numpy()
    summary = {"decode_route": route}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        rgbd_dir = write_sequence(os.path.join(root, "rgbd"), r_grays, r_counts)
        mono_dir = write_sequence(os.path.join(root, "mono"), grays.cpu().numpy())
        # Kinect: the color camera sees the depth camera's view through a
        # focal length twice as long, at the centre of a 1920x1080 frame,
        # with an identity extrinsic; the registration at --kinect-gray-cull
        # 2 then lands on the depth view's own pixels.
        colors = np.zeros((KINECT_FRAMES, 1080, 1920, 3), np.uint8)
        view = np.repeat(np.repeat(r_grays[:KINECT_FRAMES], 2, axis=1), 2, axis=2)
        colors[:, 116:116 + 2 * RH, 448:448 + 2 * RW] = view[..., None]
        kin_dir = write_sequence(os.path.join(root, "kinect"), None, r_counts[:KINECT_FRAMES],
                                 colors)
        rK = r_K.numpy()
        cK = np.array([[2 * rK[0, 0], 0, 960], [0, 2 * rK[1, 1], 540], [0, 0, 1]], np.float32)
        rgbd_yaml = write_calib(os.path.join(root, "rgbd.yaml"), {"monocular": (rK, RW, RH)})
        mono_yaml = write_calib(os.path.join(root, "mono.yaml"),
                                {"monocular": (K.cpu().numpy(), W, H)})
        kin_yaml = write_calib(os.path.join(root, "kinect.yaml"),
                               {"rgb": (cK, 1920, 1080), "depth": (rK, RW, RH)}, np.eye(4))
        phase("cli", f"wrote the PNG sequences in {time.perf_counter() - t0:.2f} s")

        def run(name, data, calib, chunk, *extra):
            got = cli_path(name, ["--data", data, "--calib", calib, "--chunk", str(chunk),
                                  "--out", os.path.join(root, f"{name}.txt"), *extra])
            ts, poses, _ = got["result"]
            if not np.isfinite(poses).all():
                raise AssertionError(f"cli {name}: non-finite pose")
            require_launched(name, got["launches"],
                             MONO_KERNELS if "mono" in name else RGBD_KERNELS)
            if "mono" not in name and (got["launches"]["epipolar"]
                                       or got["launches"]["regularize"]
                                       or got["launches"]["regularize_cull"]):
                raise AssertionError(f"{name}: the mapper's kernels ran: {got['launches']}")
            if "mono" in name and got["launches"]["regularize"]:
                raise AssertionError(f"{name}: csrc/regularize.cu ran on the fused route: "
                                     f"{got['launches']}")
            by_path[name] = got["launches"]
            n = len(ts) - 1
            wall, decode = got["wall_s"], got["decode_s"]
            summary[name] = dict(frames=n, ms_per_frame=1e3 * wall / n, wall_s=wall,
                                 decode_s=decode, dispatch_drain_s=wall - decode,
                                 report_fps=got["report"]["fps"])
            phase("cli", f"{name}: {n} frames after the first, {1e3 * wall / n:.3f} ms/frame "
                         f"(wall {wall:.2f} s: decode {decode:.2f} s = "
                         f"{100 * decode / wall:.1f}%, dispatch/drain {wall - decode:.2f} s), "
                         f"report fps {got['report']['fps']}, launches {got['launches']} "
                         f"on {card_line}")
            return got

        # RGB-D, with every host sync recorded and placed by its call stack.
        stacks = []
        rgbd = sync_stacks(lambda: run("cli_rgbd", rgbd_dir, rgbd_yaml, CLI_CHUNK,
                                       "--mode", "rgbd"), stacks)
        where = lambda stack, fn: any("runner.py" in f and f", in {fn}\n" in f for f in stack)
        # (entering a graph capture synchronises once per run: counted apart)
        in_capture = [s for s in stacks if any("capture_graph" in f for f in s)]
        in_dispatch = [s for s in stacks if (where(s, "dispatch") or where(s, "upload"))
                       and s not in in_capture]
        in_chunks = [s for s in stacks if where(s, "_run_chunks")]
        for stack in in_dispatch:
            print("sync inside a chunk's dispatch:\n" + "".join(stack[-6:]), file=sys.stderr)
        n_chunks = RGBD_FRAMES // CLI_CHUNK
        summary["cli_rgbd"]["syncs"] = dict(in_dispatch=len(in_dispatch), in_capture=len(in_capture),
                                            in_chunk_loop=len(in_chunks), total=len(stacks),
                                            chunks=n_chunks)
        phase("cli", f"cli_rgbd host syncs: {len(in_dispatch)} inside the dispatch of "
                     f"{n_chunks} chunks besides {len(in_capture)} in its one capture, "
                     f"{len(in_chunks)} in the chunk loop outside it, "
                     f"{len(stacks)} in all (init, per-frame tail, result copies)")
        if in_dispatch:
            raise AssertionError("cli_rgbd: host sync inside a chunk's dispatch")

        # The API on the same frames as the CLI sees them (no undistortion:
        # an all-valid mask), one chunk.
        ones = torch.ones((RH, RW), dtype=torch.bool)
        d0, s0 = raw_depth(torch.from_numpy(r_counts[0]).to(dev), DEPTH_SCALE)
        api = rgbd_run_raw(rgbd_init(torch.from_numpy(r_grays[0]), ones, d0, s0, r_K, cfg_r,
                                     device=dev),
                           torch.from_numpy(r_grays[1:]), ones, torch.from_numpy(r_counts[1:]),
                           r_K, cfg_r, depth_scale=DEPTH_SCALE)[1]
        dT = np.abs(rgbd["result"][1][1:] - api.T_world.cpu().numpy()).max()
        phase("cli", f"cli_rgbd vs rgbd_init + rgbd_run_raw on the same frames: "
                     f"max |dT| {dT:.3g} (tol {POSE_TOL})")
        if not dT <= POSE_TOL:
            raise AssertionError("cli_rgbd: the CLI's poses differ from the API's")

        # Mono, with a checkpoint of the final state.
        ckpt = os.path.join(root, "state.npz")
        mono = run("cli_mono", mono_dir, mono_yaml, CLI_CHUNK, "--mode", "mono",
                   "--checkpoint", ckpt, "--metrics", os.path.join(root, "mono.jsonl"))
        live, loaded = mono["state"], load_state(ckpt, dev)
        cfg0, K0, (g, m) = _cull_chunk(cfg, K, grays[1], torch.ones((H, W), dtype=torch.bool,
                                                                    device=dev))
        step_live = monocular_step(live, g, m, K0, cfg0, resets[0].to(dev))[1]
        step_loaded = monocular_step(loaded, g, m, K0, cfg0, resets[0].to(dev))[1]
        dT = (step_live.T_world - step_loaded.T_world).abs().max().item()
        same_kf = bool(step_live.is_keyframe) == bool(step_loaded.is_keyframe)
        phase("cli", f"cli_mono checkpoint: {int(loaded.history.count)} keyframes in the ring, "
                     f"next step live vs reloaded max |dT| {dT:.3g} (tol {POSE_TOL}), "
                     f"keyframe flags equal: {same_kf}")
        if not same_kf or not dT <= POSE_TOL:
            raise AssertionError("cli_mono: the reloaded checkpoint steps differently")

        base = (RH >> cfg.pyramid.culls, RW >> cfg.pyramid.culls)
        for mode in ("rgbd", "mono"):
            got = run(f"cli_kinect_{mode}", kin_dir, kin_yaml, KINECT_CHUNK,
                      "--format", "kinect", "--mode", mode)
            if mode == "rgbd":
                dT = np.abs(got["result"][1] - rgbd["result"][1][:KINECT_FRAMES]).max()
                phase("cli", f"cli_kinect_rgbd vs cli_rgbd on the same frames (registered "
                             f"gray, holes masked): max |dT| {dT:.3g} (tol {KINECT_GAP_TOL})")
                if not dT <= KINECT_GAP_TOL:
                    raise AssertionError("cli_kinect_rgbd: strays from the RGB-D CLI's poses")
            # The same command on the card and on the CPU (plain versions,
            # unpinned staging) over the first frames, one chunk and a
            # one-frame tail, both fed the same reset planes: the batched
            # registration and the pinned 1080p staging against the CPU's.
            poses = {}
            for device in ("cuda", "cpu"):
                planes = draw_reset_depth((KINECT_CPU_FRAMES - 1,) + base,
                                          cfg.mapper.depth_filter,
                                          torch.Generator().manual_seed(SEED))
                with fixed_resets(planes):
                    poses[device] = cli_path(f"cli_kinect_{mode}_{device}", [
                        "--data", kin_dir, "--calib", kin_yaml, "--format", "kinect",
                        "--mode", mode, "--chunk", str(KINECT_CHUNK),
                        "--max-frames", str(KINECT_CPU_FRAMES), "--device", device,
                        "--out", os.path.join(root, f"kinect_{mode}_{device}.txt")])["result"][1]
            dT = np.abs(poses["cuda"] - poses["cpu"]).max()
            summary[f"cli_kinect_{mode}"]["cuda_vs_cpu_max_dT"] = float(dT)
            phase("cli", f"cli_kinect_{mode}: the first {KINECT_CPU_FRAMES} frames on the card "
                         f"vs on the CPU: max |dT| {dT:.3g} (tol {POSE_TOL})")
            if not dT <= POSE_TOL:
                raise AssertionError(f"cli_kinect_{mode}: CUDA and CPU runs disagree")
        # The PIL route's decode pool at 8, 4 and 2 threads against decoding
        # on the calling thread (PIL_THREADS = 1), in turns (8, 4, 2, 1, 1,
        # 2, 4, 8).
        summary["decode_turns"] = {}
        for name, data, calib, extra in (
                ("cli_rgbd", rgbd_dir, rgbd_yaml, ("--chunk", str(CLI_CHUNK), "--mode", "rgbd")),
                ("cli_mono", mono_dir, mono_yaml, ("--chunk", str(CLI_CHUNK), "--mode", "mono")),
                ("cli_kinect_rgbd", kin_dir, kin_yaml, ("--chunk", str(KINECT_CHUNK), "--format",
                                                        "kinect", "--mode", "rgbd"))):
            turns = {threads: [] for threads in DECODE_THREADS}
            for threads in DECODE_THREADS + DECODE_THREADS[::-1]:
                with patched(runner, "PIL_THREADS", threads), \
                        patched(runner, "PIL_AHEAD", 2 * threads):
                    got = cli_path(f"{name}_pil{threads}", [
                        "--data", data, "--calib", calib, *extra,
                        "--out", os.path.join(root, "turn.txt")])
                n = len(got["result"][0]) - 1
                turns[threads].append(dict(ms_per_frame=1e3 * got["wall_s"] / n,
                                           decode_share=got["decode_s"] / got["wall_s"]))
            summary["decode_turns"][name] = turns
            fmt = lambda rows: ", ".join(f"{r['ms_per_frame']:.2f} ms/frame (decode "
                                         f"{100 * r['decode_share']:.1f}%)" for r in rows)
            phase("cli", f"{name} PIL decode by threads (1: the calling thread; the default "
                         f"{runner.PIL_THREADS}), in turns: "
                         + "; ".join(f"{t}: {fmt(rows)}" for t, rows in turns.items())
                         + f" on {card_line}")
        summary["extras"] = cli_extras(root, mono_dir, mono_yaml, cfg)
    return summary


def pose_inputs(dev, g):
    """One draw of what the step hands the pose entries at the main path's
    shapes: twists as a run makes them (a world pose, a frame's motion, the
    previous one, a ring of 8 keyframe poses), K of the culled 160x120
    base, and a promotion flag."""
    def twist(scale_v, scale_w):
        x = torch.randn(6, generator=g)
        return torch.cat([x[:3] * scale_v, x[3:] * scale_w])
    world = twist(0.5, 0.3)
    hist = torch.stack([world + twist(0.05, 0.02) for _ in range(8)])
    K = torch.tensor([[150.0, 0.0, 80.0], [0.0, 150.0, 60.0], [0.0, 0.0, 1.0]])
    out = dict(ref_xi=world, rel_xi=twist(0.02, 0.005), prev_rel=twist(0.02, 0.005),
               vel=twist(0.02, 0.005), hist_xi=hist, K=K,
               need_kf=torch.tensor(bool(torch.rand((), generator=g) < 0.5)))
    out = {k: v.to(dev) for k, v in out.items()}
    out["gate"] = 2.0
    return out


def pose_calls(inp, frame_xi):
    """Each timed form of the pose entries: name -> (its work() arguments,
    its call on ``m``: ``ops/cuda/pose`` for the kernel, ``pose_plain()``
    for the plain versions)."""
    from dvo_tpu_torch import lie

    # The gate at twice or half the gated twist's norm: kept or zeroed.
    gate_rgbd = inp["gate"] * float(torch.linalg.vector_norm(inp["vel"]))
    gate_mono = inp["gate"] * float(torch.linalg.vector_norm(
        lie.compose(inp["prev_rel"], inp["vel"])))
    return {
        "warm_rgbd": (("warm", 8, False), lambda m: m.warm(inp["vel"], gate_rgbd)),
        "warm_mono": (("warm", 8, True),
                      lambda m: m.warm(inp["vel"], gate_mono, prev_rel=inp["prev_rel"])),
        "track_mono": (("track", 8, True),
                       lambda m: m.track(inp["ref_xi"], inp["rel_xi"], prev_rel=inp["prev_rel"])),
        "track_rgbd": (("track", 8, False),
                       lambda m: m.track(inp["ref_xi"], inp["rel_xi"], world=True)),
        "table": (("table", 8), lambda m: m.table(inp["K"], frame_xi, inp["rel_xi"],
                                                  inp["hist_xi"])),
        "emit": (("emit",), lambda m: m.emit(inp["need_kf"], inp["ref_xi"], frame_xi,
                                             inp["rel_xi"])),
    }


def pose_plain():
    """The plain versions of ``ops/cuda/pose``'s entries, under the entries'
    names."""
    from dvo_tpu_torch.ops.cuda import pose

    return SimpleNamespace(warm=pose.warm_plain, track=pose.track_plain,
                           table=pose.table_plain, emit=pose.emit_plain)


def pose_phase(dev, card_line):
    """``csrc/pose.cu`` against the plain versions (module docstring,
    ``pose``).  Returns the kernel rows."""
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.ops.cuda import _build, pose
    from dvo_tpu_torch.tools import framebuild_floor

    kernel, plain = pose, pose_plain()
    g = torch.Generator().manual_seed(SEED)
    gaps, bitwise = {}, {}
    for draw in range(POSE_DRAWS):
        inp = pose_inputs(dev, g)
        if draw % 2:   # the gate's other side, the other promotion branch
            inp["need_kf"], inp["gate"] = ~inp["need_kf"], 0.5
        calls = pose_calls(inp, lie.compose(inp["ref_xi"], inp["rel_xi"]))
        for name, (_, call) in calls.items():
            got, again, want = (_flat(call(m)) for m in (kernel, kernel, plain))
            torch.cuda.synchronize()
            bitwise[name] = bitwise.get(name, 0) + all(map(torch.equal, got, want))
            for k, a, w in zip(got, again, want):
                if not torch.equal(k, a):
                    raise AssertionError(f"pose {name}: two launches gave different bits")
                gap = float(((k - w).abs() / torch.clamp(w.abs(), min=1.0)).max())
                gaps[name] = max(gaps.get(name, 0.0), gap)
                if gap > ENTRY_TOL:
                    raise AssertionError(f"pose {name}: {gap:.3g} from the plain version "
                                         f"(tolerance {ENTRY_TOL:g}) in draw {draw}")
                if k.shape == (4, 4) and not torch.equal(
                        k[3].cpu(), torch.tensor([0.0, 0.0, 0.0, 1.0])):
                    raise AssertionError(f"pose {name}: last row {k[3].tolist()}")
                if k.shape == (10, 16) and (k[0, 9:].any() or k[1, 13:].any() or k[2:, 15].any()):
                    raise AssertionError(f"pose {name}: an unused column is not zero")
    if any(n != POSE_DRAWS for n in bitwise.values()):
        raise AssertionError(f"pose: draws bitwise the plain version's, of {POSE_DRAWS}: "
                             f"{bitwise}")
    inp = pose_inputs(dev, g)
    calls = pose_calls(inp, lie.compose(inp["ref_xi"], inp["rel_xi"]))
    rows = []
    for name, (work_args, call) in calls.items():
        _build.reset_launches()
        call(kernel)
        torch.cuda.synchronize()
        if _build.LAUNCHES["pose"] != 1:
            raise AssertionError(f"pose {name}: {_build.LAUNCHES['pose']} launches, expected 1")
        ops, us = device_profile(lambda: call(kernel), 20, True)
        plain_ops, plain_us = device_profile(lambda: call(plain), 5, True)
        ms, plain_ms = timed(lambda: call(kernel)), timed(lambda: call(plain))
        nbytes, flops = pose.work(*work_args)
        fl = framebuild_floor.floor_us(nbytes, device_profile)
        row = with_bound(dict(name=f"pose_{name}", route="cuda", counter="pose",
                              source="dvo_tpu_torch/csrc/pose.cu",
                              replaces="none: dvo_tpu/lie.py, left to XLA's fusion",
                              device_us=us, device_ops=ops, ms=ms, plain_ms=plain_ms,
                              plain_device_ops=plain_ops, plain_device_us=plain_us,
                              max_rel_gap=gaps[name], draws=POSE_DRAWS,
                              bitwise_draws=bitwise[name],
                              launch_floor_us=fl["empty_us"], copy_floor_us=fl["copy_us"],
                              copy_floor_bytes=fl["copy_bytes"]), nbytes, flops)
        rows.append(row)
        phase("pose", f"{name}: device {us:.2f} us in {ops:g} ops (plain {plain_ops:g} ops, "
                      f"{plain_us:.1f} us), call {ms:.4f} ms vs plain {plain_ms:.4f} ms, launch "
                      f"floor {fl['empty_us']:.2f} us, bound {row['bound_us']:.5f} us "
                      f"({row['bound_by']}), max gap {gaps[name]:.3g} over {POSE_DRAWS} draws "
                      f"(tolerance {ENTRY_TOL:g}), {bitwise[name]} of them bitwise the plain "
                      f"version's, repeats bitwise, on {card_line}")
    return rows


def run_path(name, fn):
    """Run one path with every launch count set to 0 just before; returns
    (its output, seconds, the counts read just after)."""
    from dvo_tpu_torch.ops.cuda import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(_build.LAUNCHES)


MONO_KERNELS = ("gn_level", "epipolar", "regularize_cull", "framebuild", "pose")
MONO_FIELDS_KERNELS = ("gn_level", "epipolar", "regularize", "framebuild", "pose")
RGBD_KERNELS = ("gn_level", "framebuild", "pose")
POSE_PER_FRAME = {"mono": 3, "rgbd": 2}   # track, table, emit; warm, track


def require_launched(path, launches, names, levels_per_frame=None, mono=None, pose=None):
    """Every kernel in ``names`` launched on the path; with
    ``levels_per_frame`` = (levels, frames), the level kernel exactly once
    per level and frame, and the stepwise kernels not at all; with ``mono`` =
    (route, frames, keyframes, first-frame builds), the mapper's launches of
    a monocular run on that route ("fused" or "fields"), exactly; with
    ``pose`` = (launches a frame, frames), the pose entries' launches,
    exactly."""
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the {path} path")
    if pose is not None and launches["pose"] != pose[0] * pose[1]:
        raise AssertionError(f"{path}: expected {pose[0]} pose launches a frame over "
                             f"{pose[1]} frames: {launches}")
    if levels_per_frame is not None:
        levels, frames = levels_per_frame
        if launches["gn_level"] != levels * frames or launches["gn"] or launches["gn_step"]:
            raise AssertionError(f"{path}: expected {levels} gn_level launches per frame over "
                                 f"{frames} frames and no gn or gn_step launch: {launches}")
    if mono is not None:
        # Both mapping branches are enqueued on every frame (the keyframe
        # decision is selected on the device): the depth update launches on
        # keyframes too.
        route, frames, keyframes, inits = mono
        want = dict(epipolar=frames)
        if route == "fused":    # the tracking frame; regularize and cull in one launch
            want.update(framebuild=frames + inits, regularize=0, regularize_cull=frames)
        else:                   # + the pair build and the one-plane build; the regulariser
            want.update(framebuild=3 * frames + inits, regularize=frames, regularize_cull=0)
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"{path}: the mapper's launches on the {route} route over "
                                 f"{frames} frames with {keyframes} promotions: {got}, "
                                 f"expected {want}")


@contextlib.contextmanager
def fields_route():
    """The monocular mapper on its fields route: the depth update prepares
    the 24 field planes in PyTorch ops and launches the kernel's fields
    entry, and the reference is rebuilt by three launches (the pair build,
    ``csrc/regularize.cu``, the one-plane build) in place of one."""
    from dvo_tpu_torch.models import frame, mapper, odometry

    with patched(odometry, "depth_update", mapper.depth_update_by_fields), \
            patched(odometry, "with_regularized_depth", frame.with_regularized_depth_plain):
        yield


def paired_routes(name, make_fn, frames, first):
    """After ``first`` (the path's run on the fused route: output, seconds,
    launches), the same path on the fields route twice and on the fused route
    again: A, B, B, A in one process.  ``make_fn()``, called inside each
    route's context, captures the path's graph and returns the run, which
    returns a list of chunk results.  Returns (ms/frame of the four runs by route, the fields
    route's launches, (max |dT| of a fields run against the fused run over
    all frames, over the first CPU_FRAMES), whether the keyframe decisions
    were equal)."""
    poses_of = lambda o: torch.cat([r.T_world for r in o])
    kf_of = lambda o: torch.cat([r.is_keyframe for r in o])
    ms = {"fused": [1e3 * first[1] / frames], "fields": []}
    T_fused, kf_fused = poses_of(first[0]), kf_of(first[0])
    dT, dT_first, same_kf = 0.0, 0.0, True
    for route in ("fields", "fields", "fused"):
        with fields_route() if route == "fields" else contextlib.nullcontext():
            out, elapsed, launches = run_path(f"{name}_{route}", make_fn())
        ms[route].append(1e3 * elapsed / frames)
        kf = kf_of(out)
        require_launched(f"{name}_{route}", launches,
                         MONO_FIELDS_KERNELS if route == "fields" else MONO_KERNELS,
                         mono=(route, frames, int(kf.sum()), 0))   # primed: init untimed
        diff = (poses_of(out) - T_fused).abs()
        if route == "fields":
            fields_launches = launches
            dT = max(dT, diff.max().item())
            dT_first = max(dT_first, diff[:CPU_FRAMES].max().item())
            same_kf = same_kf and bool((kf == kf_fused).all())
        elif not diff[:CPU_FRAMES].max() <= POSE_TOL:
            raise AssertionError(f"{name}: the fused route's second run gave other poses")
    if not dT_first <= POSE_TOL:
        raise AssertionError(f"{name}: the fields route's first {CPU_FRAMES} poses differ from "
                             f"the fused route's by {dT_first:.3g}")
    return ms, fields_launches, (dT, dT_first), same_kf


def paired_loops(name, make_fn, frames, poses_of, first, first_frames):
    """After ``first`` (the path's run with the level kernel over
    ``first_frames`` frames: output, seconds, launches), the first ``frames``
    frames of the same path (``make_fn()()``, the run made and captured
    inside each loop's context) with the stepwise loop twice and with the
    level kernel again: A, B, B, A in one process.  Returns (ms/frame of
    the four runs by loop, the stepwise launches, max |dT| of a stepwise run
    against the level kernel's over those frames and over the first
    CPU_FRAMES)."""
    ms = {"level": [1e3 * first[1] / first_frames], "stepwise": []}
    T_level = poses_of(first[0])[:frames]
    dT, dT_first = 0.0, 0.0
    for loop in ("stepwise", "stepwise", "level"):
        with stepwise_tracker() if loop == "stepwise" else contextlib.nullcontext():
            out, elapsed, launches = run_path(f"{name}_{loop}", make_fn())
        ms[loop].append(1e3 * elapsed / frames)
        if loop == "stepwise":
            require_launched(f"{name}_stepwise", launches, ("gn",))
            if launches["gn_level"] != 0:
                raise AssertionError(f"{name}_stepwise launched the level kernel: {launches}")
            step_launches = launches
            diff = (poses_of(out) - T_level).abs()
            dT = max(dT, diff.max().item())
            dT_first = max(dT_first, diff[:CPU_FRAMES].max().item())
        elif not (poses_of(out)[:CPU_FRAMES] - T_level[:CPU_FRAMES]).abs().max() <= POSE_TOL:
            raise AssertionError(f"{name}: the level kernel's second run gave other poses")
    if not dT_first <= POSE_TOL:
        raise AssertionError(f"{name}: the stepwise loop's first {CPU_FRAMES} poses differ "
                             f"from the level kernel's by {dT_first:.3g}")
    return ms, step_launches, (dT, dT_first)


def paired_drivers(name, graphed_fn, eager_fn, frames, poses_of, first):
    """After ``first`` (the path's graphed run: output, seconds, launches),
    the same path through the eager step loop twice and graphed again (the
    same captured run, ``graphed_fn``): A, B, B, A in one process.  Every
    run's poses must equal the first's bitwise.  Returns {"ms_per_frame":
    {driver: [ms/frame of each run]}}."""
    ms = {"graphed": [1e3 * first[1] / frames], "eager": []}
    T0 = poses_of(first[0])
    for which, fn in (("eager", eager_fn), ("eager", eager_fn), ("graphed", graphed_fn)):
        out, elapsed, _ = run_path(f"{name}_{which}", fn)
        ms[which].append(1e3 * elapsed / frames)
        if not torch.equal(poses_of(out), T0):
            raise AssertionError(f"{name}: the {which} run's poses differ from the first graphed "
                                 f"run's (max {(poses_of(out) - T0).abs().max().item():.3g})")
    return dict(ms_per_frame=ms)


def device_ops(path_loops, loops=("level", "stepwise")):
    """{loop: (device ops per frame, idle share)} for a phase's line."""
    return {d: (round(path_loops[d]["device_ops_per_frame"]),
                round(path_loops[d]["idle_share"], 3)) for d in loops}


def profiled_loops(make_fn, frames, ms_per_frame, other=("stepwise", stepwise_tracker)):
    """Device ops and device-busy us per frame of ``make_fn()()`` (``frames``
    frames; the run made inside the context, so that its graph is captured
    there) under ``torch.profiler``, as the code stands (the level kernel,
    the fused route) and inside the context ``other`` = (name, context
    manager); the idle share is read against the mean unprofiled ms/frame of
    the same loop (``ms_per_frame``, from this process)."""
    out = {}
    for loop in ms_per_frame:
        with other[1]() if loop == other[0] else contextlib.nullcontext():
            ops, us = device_profile(make_fn())
        wall_us = 1e3 * statistics.mean(ms_per_frame[loop])
        out[loop] = dict(device_ops_per_frame=ops / frames,
                           device_busy_us_per_frame=us / frames,
                           idle_share=1.0 - us / frames / wall_us)
    return out


def png_size(path):
    """(height, width) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(24)
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def cli_extras(root, mono_dir, mono_yaml, cfg):
    """``--trace`` and ``--gallery`` on a short mono run, and ``--stream``
    over a directory that holds the same frames: each once, on the card."""
    import shutil

    n = EXTRA_FRAMES
    trace_dir, gallery = os.path.join(root, "trace"), os.path.join(root, "gallery.png")
    got = cli_path("cli_mono_trace_gallery", [
        "--data", mono_dir, "--calib", mono_yaml, "--mode", "mono", "--chunk", "3",
        "--max-frames", str(n), "--trace", trace_dir, "--gallery", gallery,
        "--checkpoint", os.path.join(root, "extras.npz"),
        "--out", os.path.join(root, "extras.txt")])
    trace = os.path.join(trace_dir, "trace.json")
    if not os.path.isfile(trace) or os.path.getsize(trace) == 0:
        raise AssertionError("cli --trace wrote no trace.json")
    count = int(got["state"].history.count)
    h0, w0 = H >> cfg.pyramid.culls, W >> cfg.pyramid.culls
    want = (count * h0 + 2 * (count - 1), 3 * w0 + 4)
    if png_size(gallery) != want:
        raise AssertionError(f"cli --gallery: PNG of {png_size(gallery)}, expected {want} for "
                             f"{count} keyframes")
    live = os.path.join(root, "live")
    os.makedirs(live)
    for i in range(n):
        shutil.copy(os.path.join(mono_dir, f"c{i:04d}.png"), live)
    out = os.path.join(root, "stream.txt")
    streamed = cli_path("cli_mono_stream", ["--data", live, "--calib", mono_yaml, "--stream",
                                            "--stream-idle", "0.5", "--out", out])
    report = streamed["report"]
    with open(out) as f:
        lines = [line for line in f if line.strip() and not line.startswith("#")]
    if report.get("streamed") is not True or report["frames"] != n or len(lines) != n:
        raise AssertionError(f"cli --stream: report {report}, {len(lines)} trajectory lines")
    require_launched("cli_mono_stream", streamed["launches"], MONO_KERNELS,
                     (cfg.pyramid.levels, n - 1))
    phase("cli", f"--trace: {os.path.getsize(trace)} bytes of trace.json; --gallery: "
                 f"{want[1]}x{want[0]} PNG of {count} keyframes; --stream: {n} frames of a "
                 f"directory odometrised, launches {streamed['launches']}")
    return dict(trace_bytes=os.path.getsize(trace), gallery_size=list(want),
                stream_frames=report["frames"])


def ba_phase(dev, card_line, grays, masks, K, cfg, noise, resets, by_path, depth):
    """The mono path with windowed BA on every promotion whose window is
    full (phase 10 of the module docstring).  Returns its numbers."""
    from dvo_tpu_torch.models import ba
    from dvo_tpu_torch.models.odometry import (
        _cull_chunk,
        monocular_init,
        monocular_run,
        monocular_step,
    )
    from dvo_tpu_torch.ops.cuda import _build
    from dvo_tpu_torch.tools import step_gate

    cfg_ba = dataclasses.replace(cfg, ba=dataclasses.replace(
        cfg.ba, enabled=True, window=BA_WINDOW, iterations=BA_ITERS))

    def run(cfg_x, device, n, keep=None, stable=False):
        g, m = (grays, masks) if device == dev else (grays[:n + 1].cpu(), masks[:n + 1].cpu())
        if stable:
            state = stable_start(cfg_x, g, m, K.to(device), depth.to(device), device)
        else:
            state = monocular_init(g[0], m[0], K.to(device), cfg_x, device=device, noise=noise)
        outs = []
        for c in range(0, n, CHUNK):
            sl = slice(1 + c, 1 + min(c + CHUNK, n))
            state, res = monocular_run(state, g[sl], m[sl], K.to(device), cfg_x,
                                       resets[c:min(c + CHUNK, n)].to(device))
            outs.append(res)
            if keep is not None and not keep:
                keep.append(state)     # the state after the first chunk
        return outs

    cat = lambda outs, f: torch.cat([f(r) for r in outs])
    mids = []
    first = run_path("mono_ba", lambda: run(cfg_ba, dev, N_FRAMES, mids))
    outs, elapsed, launches = first
    by_path["mono_ba"] = launches
    T, kf = cat(outs, lambda r: r.T_world), cat(outs, lambda r: r.is_keyframe)
    cost, win_xi = cat(outs, lambda r: r.ba_cost), cat(outs, lambda r: r.ba_window_xi)
    n_kf = int(kf.sum())
    if not bool(torch.isfinite(T).all()):
        raise AssertionError("ba: non-finite pose")
    if tuple(win_xi.shape) != (N_FRAMES, BA_WINDOW, 6):
        raise AssertionError(f"ba: ba_window_xi of shape {tuple(win_xi.shape)}")
    # The ring holds one keyframe at the start, so the window is full from
    # promotion BA_WINDOW - 1 on, and BA runs on exactly those.
    ran = cost[kf] >= 0
    want = torch.arange(n_kf, device=dev) >= BA_WINDOW - 2
    if not bool((ran == want).all()) or not bool(torch.isfinite(cost).all()) \
            or not bool((cost[~kf] == -1.0).all()):
        raise AssertionError(f"ba: ba_cost per promotion {cost[kf].tolist()}")
    n_ba = int(ran.sum())
    require_launched("mono_ba", launches, MONO_KERNELS, (cfg.pyramid.levels, N_FRAMES),
                     mono=("fused", N_FRAMES, n_kf, 1))
    ms_ba = [1e3 * elapsed / N_FRAMES]
    ms_off = []
    for cfg_x, ms in ((cfg, ms_off), (cfg, ms_off), (cfg_ba, ms_ba)):
        out_x, elapsed_x, _ = run_path("mono_ba_turn", lambda: run(cfg_x, dev, N_FRAMES))
        ms.append(1e3 * elapsed_x / N_FRAMES)
        if cfg_x is cfg_ba and not (cat(out_x, lambda r: r.T_world)[:CPU_FRAMES]
                                    - T[:CPU_FRAMES]).abs().max() <= POSE_TOL:
            raise AssertionError("ba: the second run with BA gave other poses")
    per_promotion = (statistics.mean(ms_ba) - statistics.mean(ms_off)) * N_FRAMES / n_ba
    phase("ba", f"{N_FRAMES} frames with BA (window {BA_WINDOW}, {BA_ITERS} iterations): "
                f"{n_kf} promotions, {n_ba} with BA, final costs "
                f"{[round(c, 2) for c in cost[kf][ran].tolist()]}, launches {launches}; "
                f"ms/frame with BA {ms_ba}, without {ms_off} (A, B, B, A): "
                f"{per_promotion:.1f} ms of wall per promotion with BA on {card_line}")

    # The first frames on the CPU, same reset planes: the stable rig as one
    # trajectory (held), the noise-bootstrapped one (printed) ...
    n = BA_CPU_FRAMES

    def cuda_vs_cpu(outs, cpu):
        T_x, kf_x = cat(outs, lambda r: r.T_world)[:n].cpu(), cat(outs, lambda r: r.is_keyframe)
        cost_x = cat(outs, lambda r: r.ba_cost)[:n].cpu()
        T_cpu, kf_cpu = cat(cpu, lambda r: r.T_world), cat(cpu, lambda r: r.is_keyframe)
        cost_cpu = cat(cpu, lambda r: r.ba_cost)
        per_frame = (T_x - T_cpu).abs().flatten(1).max(dim=1).values
        ba_frames = torch.nonzero(cost_x >= 0).flatten().tolist()
        both = (cost_x >= 0) & (cost_cpu >= 0)
        d_cost = ((cost_x - cost_cpu).abs() / cost_cpu.abs().clamp(min=1e-6))[both]
        return dict(
            ba_frames=ba_frames, dT=per_frame.max().item(),
            dT_before=per_frame[:ba_frames[0]].max().item() if ba_frames else None,
            dT_first=per_frame[:ba_frames[1]].max().item() if len(ba_frames) > 1 else None,
            at_ba=[float(f"{per_frame[i]:.3g}") for i in ba_frames],
            keyframes_equal=bool(torch.equal(kf_x[:n].cpu(), kf_cpu)),
            ba_frames_equal=bool(torch.equal(cost_x >= 0, cost_cpu >= 0)),
            d_cost=d_cost.max().item() if len(d_cost) else None,
            decisions=(decisions(kf_x[:n]), decisions(kf_cpu)))

    def say(rig, r):
        return (f"{rig}, first {n} frames on the card and the CPU: max |T_cuda - T_cpu| "
                f"{r['dT_before']:.3g} before the first BA (frame {r['ba_frames'][0]}; tol "
                f"{POSE_TOL}), at the BA frames {r['ba_frames']}: {r['at_ba']}, "
                f"{r['dT_first']:.3g} before the second (tol {BA_FIRST_TOL}), {r['dT']:.3g} over "
                f"all {n} (tol {BA_POSE_TOL}); keyframes equal: {r['keyframes_equal']} "
                f"({r['decisions'][0]}, {r['decisions'][1]}), ba_cost within {r['d_cost']:.3g} "
                "relative")

    stable = cuda_vs_cpu(run(cfg_ba, dev, n, stable=True), run(cfg_ba, "cpu", n, stable=True))
    phase("ba", say(f"stable rig ({STABLE_RIG}, held)", stable))
    if len(stable["ba_frames"]) < 2 or not stable["keyframes_equal"] \
            or not stable["dT_before"] <= POSE_TOL or not stable["dT_first"] <= BA_FIRST_TOL \
            or not stable["dT"] <= BA_POSE_TOL or not stable["ba_frames_equal"]:
        raise AssertionError("ba: CUDA and CPU runs of the stable rig disagree")
    noisy = cuda_vs_cpu(outs, run(cfg_ba, "cpu", n))
    phase("ba", say("noise-bootstrapped rig (printed)", noisy))
    # ... and the noise-bootstrapped rig's steps that run a bundle_adjust,
    # each from the card's state before it (the eager step, which reads the
    # decision to the host) against the same step on the CPU, at
    # BA_SOLVE_TOL: poses, the decision, the window's poses and the cost
    # (BA's depth maps are printed: its depth solve moves thousands of pixels
    # on float noise); the eager steps' poses are bitwise the graphed run's.
    cfg_e, K_e, (g_e, m_e) = _cull_chunk(cfg_ba, K, grays[1:1 + n], masks[1:1 + n])
    r_e = resets[:n].to(dev)
    g_ec, m_ec, K_ec = g_e.cpu(), m_e.cpu(), K_e.cpu()
    _, gate_res, readings = step_gate.per_frame_gates(
        monocular_init(grays[0], masks[0], K, cfg_ba, device=dev, noise=noise), range(n),
        lambda st, i: monocular_step(st, g_e[i], m_e[i], K_e, cfg_e, r_e[i]),
        lambda st, i: monocular_step(st, g_ec[i], m_ec[i], K_ec, cfg_e, resets[i]),
        cfg.tracker.max_iterations, BA_SOLVE_TOL, MAP_VALUE_TOL, 0.0,
        gate=lambda i, res: float(res.ba_cost) >= 0)
    gates = {k: step_gate.summary(v) for k, v in readings.items()}
    same = bool(torch.equal(torch.stack([r.T_world for r in gate_res]), T[:n]))
    phase("ba", f"noise-bootstrapped rig, each step with BA from the card's state vs the CPU's "
                f"step: {gates} (tol {BA_SOLVE_TOL}); the eager steps' poses bitwise the graphed "
                f"run's: {same}")
    tracked = gates[step_gate.CHECKS[1]]
    if any(g["failed"] for g in gates.values()) or tracked["ba_frames"] != noisy["ba_frames"] \
            or not same:
        raise AssertionError("ba: a step with BA differs between the card and the CPU")

    # Host syncs with BA on, from the state after the first chunk (ring
    # full), inputs on the card; the frames must hold a promotion with BA.
    # None: the driver replays its captured step, whose BA is an IF node on
    # the device's decision.  Then the same frames under the profiler: per
    # frame one launch of the IF node's condition kernel (csrc/graph_if.cu)
    # and one BA region issued (LAUNCHES["ba"]), and on the card the ``ba``
    # stage's marker once a solve, on the frames that solve and no other.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    nxt = 1 + CHUNK
    window_in = (grays[nxt:nxt + BA_SYNC_FRAMES], masks[nxt:nxt + BA_SYNC_FRAMES], K, cfg_ba,
                 resets[CHUNK:CHUNK + BA_SYNC_FRAMES].to(dev))
    sync_out = []
    syncs = count_syncs(lambda: sync_out.append(monocular_run(mids[0], *window_in)[1]))
    ba_in_window = int((sync_out[0].ba_cost >= 0).sum())
    _build.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = monocular_run(mids[0], *window_in)[1]
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    conditions = sum("set_condition" in name for name in kernels)
    marks = sum(name == "dvo_stage_ba" for name in kernels)
    regions = _build.LAUNCHES["ba"]
    phase("ba", f"over {BA_SYNC_FRAMES} frames with {ba_in_window} BA promotions: host syncs "
                f"{syncs}; on the card {conditions} condition launches, {regions} BA regions "
                f"issued, {marks} ba stage markers; the profiled replay's costs equal: "
                f"{bool(torch.equal(again.ba_cost, sync_out[0].ba_cost))}")
    if syncs != 0 or ba_in_window == 0:
        raise AssertionError("ba: expected no host sync, BA promotions included")
    if (conditions, regions, marks) != (BA_SYNC_FRAMES, BA_SYNC_FRAMES, ba_in_window) \
            or not torch.equal(again.ba_cost, sync_out[0].ba_cost):
        raise AssertionError("ba: expected one IF node and one BA region a frame, and a ba "
                             "stage on each frame that solves")

    # One bundle_adjust on the full ring's newest window: device ops, device
    # busy and wall, targets batched and as the literal double loop, in turns.
    K0 = _cull_chunk(cfg, K)[1]
    window = ba.window_from_history(mids[0].history, K0, BA_WINDOW)
    solve = {}
    for name, batched in (("batched", True), ("loop", False), ("loop", False),
                          ("batched", True)):
        fn = lambda: ba.bundle_adjust(window, cfg_ba.ba, batch_targets=batched)
        row = solve.setdefault(name, dict(wall_ms=[]))
        row["wall_ms"].append(timed(fn, reps=3, warmup=1))
        if "device_ops" not in row:
            row["device_ops"], busy_us = device_profile(fn, 1, True)
            row["device_busy_ms"] = busy_us / 1e3
    a, b = (ba.bundle_adjust(window, cfg_ba.ba, batch_targets=x) for x in (True, False))
    on_cpu = ba.bundle_adjust(ba.BAWindow(**{f.name: getattr(window, f.name).cpu()
                                             for f in dataclasses.fields(window)}), cfg_ba.ba)
    moved = (a.xi - window.xi).abs().max().item()
    d_xi = (a.xi - b.xi).abs().max().item()
    d_cost = ((a.costs - b.costs).abs() / b.costs).max().item()
    d_xi_cpu = (a.xi.cpu() - on_cpu.xi).abs().max().item()
    d_cost_cpu = ((a.costs.cpu() - on_cpu.costs).abs() / on_cpu.costs).max().item()
    phase("ba", f"one bundle_adjust at {tuple(window.gray.shape)}: {solve}; the solve moves the "
                f"twists by {moved:.3g}; batched vs loop: max |d xi| {d_xi:.3g}, costs within "
                f"{d_cost:.3g} relative; card vs CPU on the same window: max |d xi| "
                f"{d_xi_cpu:.3g} (tol {BA_SOLVE_TOL}), costs "
                f"{[round(c, 2) for c in a.costs.tolist()]} within {d_cost_cpu:.3g} relative on "
                f"{card_line}")
    if not max(d_xi, d_xi_cpu) <= BA_SOLVE_TOL or not max(d_cost, d_cost_cpu) <= 5e-2:
        raise AssertionError("ba: one solve differs between card and CPU, or batched and loop")
    return dict(frames=N_FRAMES, promotions=n_kf, promotions_with_ba=n_ba,
                ms_per_frame=dict(ba=ms_ba, off=ms_off), ms_per_promotion_with_ba=per_promotion,
                cuda_vs_cpu_max_dT=noisy["dT"], cuda_vs_cpu_frames=n,
                cuda_vs_cpu_stable=stable, cuda_vs_cpu_noisy=noisy, step_gates=gates,
                syncs_per_frame=syncs / BA_SYNC_FRAMES,
                bundle_adjust=solve, batched_vs_loop_max_dxi=d_xi, card_vs_cpu_max_dxi=d_xi_cpu)


def circle_graph(n=12, noise=0.02):
    """A drifting circle with three exact closures (the rig of
    ``tests/test_posegraph.py``): (true twists, drifted twists, i, j, z, w)."""
    from dvo_tpu_torch.utils import oracle

    rng = np.random.default_rng(SEED)
    T = []
    for k in range(n):
        th = 2 * np.pi * k / n
        c, s_ = np.cos(th), np.sin(th)
        Tk = np.eye(4)
        Tk[:3, :3] = [[c, -s_, 0], [s_, c, 0], [0, 0, 1]]
        Tk[:2, 3] = [c, s_]
        T.append(Tk)
    rel = lambda a, b: oracle.se3_log(np.linalg.inv(T[a]) @ T[b])
    zs = [rel(k, k + 1) + rng.standard_normal(6) * noise for k in range(n - 1)]
    drift = [T[0]]
    for z in zs:
        drift.append(drift[-1] @ oracle.se3_exp(z))
    pairs = [(n - 1, 0), (n - 2, 0), (n - 1, 1)]
    i = np.array(list(range(n - 1)) + [a for a, _ in pairs])
    j = np.array(list(range(1, n)) + [b for _, b in pairs])
    z = np.stack(zs + [rel(a, b) for a, b in pairs]).astype(np.float32)
    w = np.array([1.0] * (n - 1) + [20.0] * len(pairs), np.float32)
    as_xi = lambda Ts: np.stack([oracle.se3_log(t) for t in Ts]).astype(np.float32)
    return as_xi(T), as_xi(drift), i, j, z, w


def posegraph_phase(dev, card_line, grays, K, cfg, by_path):
    """The pose-graph solve on the card against the CPU, then the CLI with
    ``--ba --pose-graph --pose-graph-every`` on both runner paths (phase 11
    of the module docstring).  Returns its numbers."""
    from dvo_tpu_torch.models import posegraph
    from dvo_tpu_torch.utils import oracle

    xi_true, xi0, i, j, z, w = circle_graph()
    solve = lambda device: posegraph.optimize_pose_graph_padded(xi0, i, j, list(z), w,
                                                                device=device)
    xi_card, costs_card = solve(dev)
    xi_cpu, costs_cpu = solve("cpu")
    ate = lambda xi: float(np.sqrt(np.mean(np.sum(
        (np.stack([oracle.se3_exp(x)[:3, 3] for x in xi]) - np.stack(
            [oracle.se3_exp(x)[:3, 3] for x in xi_true])) ** 2, axis=-1))))
    d_xi = float(np.abs(xi_card - xi_cpu).max())
    d_cost = float(abs(costs_card[-1] - costs_cpu[-1]) / costs_cpu[-1])
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        solve(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
    ops, busy_us = device_profile(lambda: solve(dev), 1, True)
    phase("posegraph", f"solve of {len(xi0)} nodes, {len(w)} edges, 10 steps on the card vs the "
                       f"CPU: max |d xi| {d_xi:.3g} (tol {PG_XI_TOL}), costs {costs_card[0]:.4g} "
                       f"-> {costs_card[-1]:.4g} (CPU {costs_cpu[-1]:.4g}, tol {PG_COST_TOL} "
                       f"relative), ATE {ate(xi0):.4f} "
                       f"-> {ate(xi_card):.4f}; {statistics.median(walls):.1f} ms a solve, "
                       f"{ops} device ops, device busy {busy_us / 1e3:.2f} ms on {card_line}")
    if not np.isfinite(xi_card).all() or not d_xi <= PG_XI_TOL or not d_cost <= PG_COST_TOL \
            or not costs_card[-1] < 0.01 * costs_card[0] or not ate(xi_card) < 0.75 * ate(xi0):
        raise AssertionError("posegraph: the solve on the card is wrong")
    summary = dict(solve=dict(nodes=len(xi0), edges=len(w), ms=statistics.median(walls),
                              device_ops=ops, device_busy_ms=busy_us / 1e3,
                              card_vs_cpu_max_dxi=d_xi))

    # The CLI on a sequence that goes out over the first half of the frames
    # and comes back over the same frames, so that keyframes revisit places.
    half = N_FRAMES // 2
    loop = torch.cat([grays[:half + 1], grays[:half].flip(0)]).cpu().numpy()
    harvesters = []

    class Capture(posegraph.PoseGraphHarvester):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            harvesters.append(self)

    poses = {}
    with tempfile.TemporaryDirectory() as root:
        seq = write_sequence(os.path.join(root, "loop"), loop)
        yaml = write_calib(os.path.join(root, "mono.yaml"), {"monocular": (K.cpu().numpy(), W, H)})
        for chunk in (CLI_CHUNK, 0):
            name = f"cli_mono_pg_chunk{chunk}"
            with patched(posegraph, "PoseGraphHarvester", Capture):
                got = cli_path(name, [
                    "--data", seq, "--calib", yaml, "--mode", "mono", "--ba", "--pose-graph",
                    "--pose-graph-every", str(PG_EVERY), "--chunk", str(chunk),
                    "--out", os.path.join(root, f"{name}.txt")])
            h = harvesters[-1]
            ts, poses[chunk], _ = got["result"]
            n = len(ts) - 1
            launches = got["launches"]
            by_path[name] = launches
            tried, kfs = len(h._tried_pairs), len(h.nodes)
            want = dict(framebuild=n + 1 + 2 * tried, gn_level=cfg.pyramid.levels * (n + tried),
                        regularize_cull=n, epipolar=n, regularize=0, gn=0)
            if not np.isfinite(poses[chunk]).all():
                raise AssertionError(f"{name}: non-finite pose")
            if {k: launches[k] for k in want} != want:
                raise AssertionError(f"{name}: launches {launches}, expected {want} with "
                                     f"{tried} closure re-tracks and {kfs} keyframes")
            if len(h.e_w) < kfs - 1 or not h.closures <= tried:
                raise AssertionError(f"{name}: {len(h.e_w)} edges over {kfs} nodes")
            summary[name] = dict(
                frames=n, ms_per_frame=1e3 * got["wall_s"] / n, nodes=kfs, edges=len(h.e_w),
                ba_edges=sum(x == h.W_BA for x in h.e_w), closures_tried=tried,
                closures_accepted=h.closures, live_refinements=h.live_refinements,
                stale_snaps=h.stale_snaps, max_rel_corr_t=h.max_rel_corr_t, launches=launches)
            phase("posegraph", f"{name}: {n} frames, {1e3 * got['wall_s'] / n:.2f} ms/frame, "
                               f"{kfs} nodes, {len(h.e_w)} edges "
                               f"({summary[name]['ba_edges']} from BA windows), closure "
                               f"candidates re-tracked {tried}, accepted {h.closures}, live "
                               f"refinements {h.live_refinements}, launches {launches} on "
                               f"{card_line}")
    dT = float(np.abs(poses[CLI_CHUNK] - poses[0]).max())
    dT_first = float(np.abs(poses[CLI_CHUNK][:CPU_FRAMES] - poses[0][:CPU_FRAMES]).max())
    summary["chunked_vs_per_frame_max_dT"] = dT
    summary["chunked_vs_per_frame_first_frames_max_dT"] = dT_first
    phase("posegraph", f"chunked vs per-frame refined trajectories: max |dT| {dT_first:.3g} "
                       f"over the first {CPU_FRAMES} frames (tol {PG_CLI_TOL}), {dT:.3g} over all "
                       f"(tol {PG_CLI_ALL_TOL})")
    if not dT_first <= PG_CLI_TOL or not dT <= PG_CLI_ALL_TOL:
        raise AssertionError("posegraph: the chunked and per-frame CLI runs disagree")
    return summary


def _eager_run(state, n: int, step):
    """The eager step loop, the yardstick of the graphed drivers: ``n``
    calls of ``step(state, i)`` -> (state', result); returns (state',
    results with a leading N axis)."""
    from dvo_tpu_torch.models.odometry import stack_states

    results = []
    for i in range(n):
        state, res = step(state, i)
        results.append(res)
    return state, stack_states(results)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.models.odometry import (
        _cull_chunk,
        monocular_init,
        monocular_init_with_depth,
        monocular_run,
        monocular_step,
        raw_depth,
        rgbd_init,
        rgbd_run_raw,
        rgbd_step,
    )
    from dvo_tpu_torch.ops.cuda import _build
    from dvo_tpu_torch.tools import epipolar_sweep, framebuild_floor, regularize_sweep, step_gate
    from dvo_tpu_torch.tools.step_gate import on_device

    # 1. device
    dev = torch.device("cuda", 0)
    card_line = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {card_line} | "
                    f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    phase("build", f"nvcc build + load {time.perf_counter() - t0:.2f} s -> "
                   f"{_build.library_path().name}")

    cfg = DVOConfig.monocular()
    grays, masks, K, depth = render_sequence(dev)
    gen = torch.Generator().manual_seed(SEED)  # CPU: the same numbers for both runs
    h0, w0 = H >> cfg.pyramid.culls, W >> cfg.pyramid.culls
    noise = torch.randn((h0, w0), generator=gen)
    resets = torch.clamp(0.5 + 1.5 * torch.rand((N_FRAMES, h0, w0), generator=gen), max=4.0)

    def init(device):
        return monocular_init(grays[0], masks[0], K, cfg, device=device, noise=noise)

    if "--back-end" in sys.argv[1:]:
        by_path = {}
        ba_phase(dev, card_line, grays, masks, K, cfg, noise, resets, by_path, depth)
        posegraph_phase(dev, card_line, grays, K, cfg, by_path)
        return
    if "--streams" in sys.argv[1:]:
        streams_phase(dev, card_line, cfg, DVOConfig.rgbd(), *render_rgbd(dev))
        return
    if "--sharded" in sys.argv[1:]:
        sharded_phase(dev, card_line)
        return
    if "--pose" in sys.argv[1:]:
        print(json.dumps(plain_json({"pose": pose_phase(dev, card_line), "card": card_line})))
        return
    pose_rows = pose_phase(dev, card_line)

    # 3. kernels, on the state a warm-up run leaves (ring filled by
    # promotions), a state the kernels under test did not make: the run is
    # the CPU's (the plain versions), moved to the card
    cfg_c, K_c, (g_c, m_c) = _cull_chunk(cfg, K.cpu(), grays[1:1 + CHUNK].cpu(),
                                         masks[1:1 + CHUNK].cpu())
    warm = init("cpu")
    for i in range(CHUNK):
        warm, _ = monocular_step(warm, g_c[i], m_c[i], K_c, cfg_c, resets[i])
        if i + 1 == EARLY_FRAMES:
            early = on_device(warm, dev)
    warm = on_device(warm, dev)
    nxt = 1 + CHUNK
    cfg0, K0, (gray_next, mask_next) = _cull_chunk(cfg, K, grays[nxt], masks[nxt])
    reg_sweep = []
    kernels, fb = kernel_phase(warm, gray_next, mask_next, K0, cfg0, sweeps=reg_sweep)
    # ... the depth update once more early in a run (the same CPU run,
    # EARLY_FRAMES frames in): the ring not full, and a block of pixels
    # given an age past the live keyframes (aged out) ...
    if not early.history.count < early.history.capacity:
        raise AssertionError(f"the early state's ring holds {int(early.history.count)} "
                             "keyframes")
    early_args, _ = depth_update_args(early, *_cull_chunk(cfg, K, grays[1 + EARLY_FRAMES],
                                                          masks[1 + EARLY_FRAMES])[2], K0, cfg0)
    old = early_args[5].clone()
    (x0, x1), (y0, y1) = cfg.mapper.crop_x, cfg.mapper.crop_y
    old[y0 + 4:y0 + 20, x0 + 8:x1 - 8] = early.history.count + 1
    early_args = early_args[:5] + (old,) + early_args[6:]
    _, early_fused = check_epipolar(
        f"early ({int(early.history.count)} of {early.history.capacity} keyframes)", early_args,
        timed_too=False)
    if early_fused["stats"][3] != 16 * (x1 - x0 - 16) or early_fused["stats"][0] == 0:
        raise AssertionError(f"early state: counts {early_fused['stats']}")
    # ... and the same kernel built with 4, 8, 16 and 32 lanes a pixel.
    lanes_rows = epipolar_sweep.sweep(
        depth_update_args(warm, gray_next, mask_next, K0, cfg0)[0],
        epipolar_sweep.VARIANTS[:len(epipolar_sweep.LANES)],
        say=lambda line: phase("kernels", "epipolar " + line))
    cfg_r = DVOConfig.rgbd()
    r_grays, r_masks, r_counts, r_K = render_rgbd(dev)
    entries = {k["name"]: k for k in kernels}
    rgbd_label, fb_device, fb_work = rgbd_kernel_phase(dev, r_grays, r_masks, r_counts, r_K,
                                                       cfg_r, entries, fb)
    kin_kernels, kin_fb = kinect_mono_kernel_phase(dev, r_grays, r_masks, r_counts, r_K, cfg,
                                                   reg_sweep)
    for entry, more in zip(kernels, kin_kernels):
        for key in ("max_abs_err", "max_rel_err"):
            if key in more:
                entry[key] = max(entry[key], more[key])
        for key in ("times_by_shape", "work_by_shape"):
            if key in more:
                entry[key].update(more[key])
        if "bit_identical" in more:
            entry["bit_identical"] = entry["bit_identical"] and more["bit_identical"]
            entry["kinect_mono"] = {k: v for k, v in more.items() if k not in (
                "name", "route", "source", "replaces", "counter", "entry", "no_library_call",
                "times_by_shape")}
    fb.update(kin_fb)
    # ... and on the analytic rig, after the gate census of the earlier one.
    old_census = gate_census(depth_update_args(warm, gray_next, mask_next, K0, cfg0)[0])
    planes, plane_args = plane_rig_phase(dev, card_line, cfg, resets, kernels, fb, old_census)
    sharded_rows = sharded_kernel_checks(card_line, warm, gray_next, mask_next, K0, cfg0,
                                         plane_args, kernels)
    # ... and the regulariser's launches at the two shapes no path gives it
    reg_sweep += regularize_sweep.sweep(
        {"x".join(map(str, sh)): regularize_sweep.maps(*sh, dev) for sh in REGULARIZE_SHAPES},
        cfg.mapper, sys.modules[__name__], say=lambda line: phase("kernels", line))

    # how far float noise steers the monocular rigs
    stable = stable_rig_phase(dev, card_line, cfg, grays, masks, K, depth, resets)

    # 4. main path: the graphed driver (one capture per run), then the eager
    # step loop in turns
    def mono_main(n=N_FRAMES, start=None):
        state, outs = init(dev) if start is None else start, []
        for c in range(0, n, CHUNK):
            sl = slice(1 + c, 1 + c + CHUNK)
            state, res = monocular_run(state, grays[sl], masks[sl], K, cfg,
                                       resets[c:c + CHUNK].to(dev))
            outs.append(res)
        return outs

    def mono_primed(n=N_FRAMES):
        """A run of ``n`` frames from a fresh first state whose driver an
        untimed chunk from that state has already captured: the run replays
        (the capture's one-time cost is timed apart, in ``capture_s``)."""
        start = init(dev)
        t0 = time.perf_counter()
        monocular_run(start, grays[1:1 + CHUNK], masks[1:1 + CHUNK], K, cfg,
                      resets[:CHUNK].to(dev))
        torch.cuda.synchronize()
        capture_s.append(time.perf_counter() - t0)
        return lambda: mono_main(n, start)

    def mono_eager(n=N_FRAMES):
        """The same run through the eager step loop."""
        state, outs = init(dev), []
        for c in range(0, n, CHUNK):
            sl = slice(1 + c, 1 + c + CHUNK)
            cfg_c, K_c, (g, m) = _cull_chunk(cfg, K, grays[sl], masks[sl])
            r = resets[c:c + CHUNK].to(dev)
            state, res = _eager_run(state, g.shape[0], lambda st, i: monocular_step(
                st, g[i], m[i], K_c, cfg_c, r[i]))
            outs.append(res)
        return outs

    capture_s = []
    mono_graphed = mono_primed()
    first = run_path("mono", mono_graphed)
    outs, elapsed, launches = first
    T = torch.cat([r.T_world for r in outs])
    kf = torch.cat([r.is_keyframe for r in outs])
    accepted = torch.cat([r.mapping.accepted for r in outs])
    if not bool(torch.isfinite(T).all()):
        raise AssertionError("non-finite pose")
    if not bool(kf.any()):
        raise AssertionError("no keyframe promotion")
    if not bool((accepted[~kf] > 0).any()):
        raise AssertionError("no depth update accepted an observation")
    require_launched("mono", launches, MONO_KERNELS, (cfg.pyramid.levels, N_FRAMES),
                     mono=("fused", N_FRAMES, int(kf.sum()), 0),   # primed: init untimed
                     pose=(POSE_PER_FRAME["mono"], N_FRAMES))
    ms_frame = 1e3 * elapsed / N_FRAMES
    by_path = {"mono": launches}
    phase("main", f"{N_FRAMES} frames 640x480 -> 160x120, {int(kf.sum())} promotions, "
                  f"accepted per update {accepted[~kf].tolist()}, launches {launches}, "
                  f"graphed {ms_frame:.3f} ms/frame = {1e3 / ms_frame:.2f} fps (capture and its "
                  f"chunk {capture_s[0]:.3f} s) on {card_line}")
    level_frames = {}
    level_frames["mono"] = gn_level_on_path("main", mono_graphed, outs, (h0, w0),
                                            cfg.pyramid.levels, cfg.tracker.max_iterations)
    drivers = dict(mono=paired_drivers("mono", mono_primed(), mono_eager, N_FRAMES,
                                       lambda o: torch.cat([r.T_world for r in o]), first))
    drivers["mono"]["capture_and_chunk_s"] = capture_s[:]
    phase("main", f"graphed driver vs eager step loop (A, B, B, A): ms/frame "
                  f"{drivers['mono']['ms_per_frame']}, every run's poses bitwise equal to the "
                  f"first graphed run's on {card_line}")
    # The mapper's fused route (as above) against its fields route, in turns.
    profile_sl = slice(nxt, nxt + PROFILE_FRAMES)
    # (each profiled run from its own copy of the warm state: its graph is
    # captured under the route's or loop's context)
    profile_run = lambda: (lambda start=dataclasses.replace(warm): monocular_run(
        start, grays[profile_sl], masks[profile_sl], K, cfg, resets[:PROFILE_FRAMES].to(dev)))
    ms_routes, by_path["mono_fields"], dT_routes, same_kf = paired_routes(
        "mono", mono_primed, N_FRAMES, first)
    routes = dict(ms_per_frame=ms_routes, fields_vs_fused_max_dT=dT_routes[0],
                  fields_vs_fused_first_frames_max_dT=dT_routes[1], keyframes_equal=same_kf,
                  **profiled_loops(profile_run, PROFILE_FRAMES, ms_routes,
                                   ("fields", fields_route)))
    # One frame that is no keyframe, profiled alone on both routes, and one
    # that is (the first such frames after the warm-up: promotions come every
    # few frames).
    before, kf_args = warm, None
    for i in range(nxt, nxt + PROFILE_FRAMES):
        gray_i, mask_i = _cull_chunk(cfg, K, grays[i], masks[i])[2]
        step_args = (before, gray_i, mask_i, K0, cfg0, resets[i - 1].to(dev))
        before, res = monocular_step(*step_args)
        if not bool(res.is_keyframe):
            break
        kf_args = kf_args or step_args
    else:
        raise AssertionError(f"{PROFILE_FRAMES} keyframes in a row after the warm-up")
    if kf_args is not None:
        routes["keyframe_step_device_ops"] = device_profile(
            lambda: monocular_step(*kf_args))[0]
    routes["non_keyframe_step_device_ops"] = {}
    for route in ("fused", "fields"):
        with fields_route() if route == "fields" else contextlib.nullcontext():
            routes["non_keyframe_step_device_ops"][route] = device_profile(
                lambda: monocular_step(*step_args))[0]
    # What the frame's Lie algebra costs in device ops: each is a chain of
    # small PyTorch ops on (6,), (3, 3) and (4, 4) tensors.
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.models.mapper import pose_table
    xi_a, xi_b = step_args[0].ref.xi, res.relative_xi
    routes["lie_device_ops"] = {
        "compose": device_profile(lambda: lie.compose(xi_a, xi_b), 5, True)[0],
        "se3_exp": device_profile(lambda: lie.se3_exp(xi_a), 5, True)[0],
        "pose_table": device_profile(lambda: pose_table(K0, xi_a, xi_b, warm.history), 5,
                                     True)[0],
    }
    phase("main", f"device ops of one call: {routes['lie_device_ops']} (a mono frame calls "
                  f"compose twice, se3_exp once and, when it is no keyframe, pose_table)")
    phase("main", f"mapper routes, fused vs fields (A, B, B, A): ms/frame {ms_routes}, fields "
                  f"poses within {dT_routes[1]:.3g} of the fused route's over the first "
                  f"{CPU_FRAMES} frames (tol {POSE_TOL}) and {dT_routes[0]:.3g} over all "
                  f"{N_FRAMES}, keyframe decisions equal: {same_kf}; device ops per frame and "
                  f"idle share over {PROFILE_FRAMES} frames after the warm-up: "
                  f"{device_ops(routes, ('fused', 'fields'))}; device ops of one frame that is "
                  f"no keyframe: {routes['non_keyframe_step_device_ops']}, of one keyframe (fused): "
                  f"{routes.get('keyframe_step_device_ops')}; fields launches "
                  f"{by_path['mono_fields']} on {card_line}")
    gn_loops = {}
    ms_pair, by_path["mono_stepwise"], dT_step = paired_loops(
        "mono", lambda: mono_primed(STEPWISE_FRAMES), STEPWISE_FRAMES,
        lambda o: torch.cat([r.T_world for r in o]), first, N_FRAMES)
    gn_loops["mono"] = dict(ms_per_frame=ms_pair, stepwise_vs_level_max_dT=dT_step[0],
                           stepwise_vs_level_first_frames_max_dT=dT_step[1],
                           **profiled_loops(profile_run, PROFILE_FRAMES, ms_pair))
    phase("main", f"level kernel vs stepwise loop (A, B, B, A): ms/frame {ms_pair}, "
                  f"stepwise poses within {dT_step[1]:.3g} of the level kernel's over the first "
                  f"{CPU_FRAMES} frames (tol {POSE_TOL}) and {dT_step[0]:.3g} over all "
                  f"{STEPWISE_FRAMES} (the noise-bootstrapped depth map amplifies float noise); device ops per "
                  f"frame and idle share over {PROFILE_FRAMES} frames after the warm-up: "
                  f"{device_ops(gn_loops['mono'])}, "
                  f"stepwise launches {by_path['mono_stepwise']} on {card_line}")

    # 5. the CPU with the plain versions against the card: the stable rig's
    # first CPU_FRAMES frames as one trajectory (its first STABLE_FRAMES
    # printed) ...
    n = STABLE_FRAMES
    st_card = monocular_run(stable_start(cfg, grays, masks, K, depth, dev), grays[1:1 + n],
                            masks[1:1 + n], K, cfg, resets[:n].to(dev))[1]
    st_cpu = monocular_run(stable_start(cfg, grays, masks, K, depth, "cpu"), grays[1:1 + n].cpu(),
                           masks[1:1 + n].cpu(), K.cpu(), cfg, resets[:n])[1]
    dT_frames = (st_card.T_world.cpu() - st_cpu.T_world).abs().flatten(1).max(dim=1).values
    dT_stable = dT_frames[:CPU_FRAMES].max().item()
    same_kf = bool(torch.equal(st_card.is_keyframe.cpu(), st_cpu.is_keyframe))
    phase("cpu", f"stable rig ({STABLE_RIG}): max |T_cuda - T_cpu| {dT_stable:.3g} over the "
                 f"first {CPU_FRAMES} frames (tol {POSE_TOL}); per frame over {n}: "
                 f"{[float(f'{v:.3g}') for v in dT_frames.tolist()]}; keyframes cuda "
                 f"{decisions(st_card.is_keyframe)} cpu {decisions(st_cpu.is_keyframe)}")
    if not same_kf or not dT_stable <= POSE_TOL:
        raise AssertionError("stable rig: CUDA and CPU runs disagree")
    # ... and the noise-bootstrapped rig (the main path) frame by frame: the
    # card's state before each frame (the eager step loop, bitwise the
    # graphed driver's) copied to the CPU, the step there on the same frame
    # and reset plane, with the card's tracking and, where the card's
    # tracker converged, with its own (tools/step_gate); its whole
    # trajectory against the CPU's is printed.
    cpu_res = monocular_run(init("cpu"), grays[1:1 + CPU_FRAMES].cpu(),
                            masks[1:1 + CPU_FRAMES].cpu(), K.cpu(), cfg, resets[:CPU_FRAMES])[1]
    dT = (T[:CPU_FRAMES].cpu() - cpu_res.T_world).abs().max().item()
    cfg_e, K_e, (g_e, m_e) = _cull_chunk(cfg, K, grays[1:1 + N_FRAMES], masks[1:1 + N_FRAMES])
    r_e = resets[:N_FRAMES].to(dev)
    g_ec, m_ec, K_ec = g_e.cpu(), m_e.cpu(), K_e.cpu()
    _, gate_res, readings = step_gate.per_frame_gates(
        init(dev), range(N_FRAMES),
        lambda st, i: monocular_step(st, g_e[i], m_e[i], K_e, cfg_e, r_e[i]),
        lambda st, i: monocular_step(st, g_ec[i], m_ec[i], K_ec, cfg_e, resets[i]),
        cfg.tracker.max_iterations, POSE_TOL, MAP_VALUE_TOL, MAP_SHARE)
    step_gates = {"mono": {k: step_gate.summary(v) for k, v in readings.items()}}
    eager_T = torch.stack([r.T_world for r in gate_res])
    for check, got in step_gates["mono"].items():
        phase("cpu", f"noise-bootstrapped rig, per frame from the card's state, the CPU step "
                     f"with {check}: {len(got['frames'])} of {N_FRAMES} frames: {got} (tol "
                     f"{POSE_TOL}, maps {MAP_VALUE_TOL} on {MAP_SHARE})")
    phase("cpu", f"noise-bootstrapped rig, whole trajectory (printed): first {CPU_FRAMES} frames "
                 f"max |T_cuda - T_cpu| {dT:.3g}, keyframes cuda {decisions(kf[:CPU_FRAMES])} "
                 f"cpu {decisions(cpu_res.is_keyframe)}; the eager loop's poses bitwise the "
                 f"graphed run's: {bool(torch.equal(eager_T, T))}")
    if any(got["failed"] for got in step_gates["mono"].values()) or not torch.equal(eager_T, T):
        raise AssertionError("per-frame gates: a card step and its CPU step disagree, or the "
                             "eager loop left the graphed run")

    # 6. RGB-D: frame 0 converted as rgbd_run_raw converts, then one chunk
    def rgbd_start(device):
        d0, s0 = raw_depth(r_counts[0].to(device), DEPTH_SCALE)
        return rgbd_init(r_grays[0], r_masks[0], d0, s0, r_K, cfg_r, device=device)

    def rgbd_main(device, n, start=None):
        return rgbd_run_raw(rgbd_start(device) if start is None else start, r_grays[1:1 + n],
                            r_masks[1:1 + n], r_counts[1:1 + n], r_K, cfg_r,
                            depth_scale=DEPTH_SCALE)[1]

    def rgbd_primed(n=RGBD_FRAMES):
        """As ``mono_primed``: the driver captured by an untimed short chunk."""
        start = rgbd_start(dev)
        t0 = time.perf_counter()
        rgbd_main(dev, SYNC_FRAMES, start)
        torch.cuda.synchronize()
        capture_s.append(time.perf_counter() - t0)
        return lambda: rgbd_main(dev, n, start)

    def rgbd_eager(n=RGBD_FRAMES):
        cfg_c, K_c, (g, m, c) = _cull_chunk(cfg_r, r_K.to(dev), *(
            x[1:1 + n].to(dev) for x in (r_grays, r_masks, r_counts)))
        d, s = raw_depth(c, DEPTH_SCALE)
        return _eager_run(rgbd_start(dev), n, lambda st, i: rgbd_step(
            st, g[i], m[i], d[i], s[i], K_c, cfg_c))[1]

    capture_s = []
    rgbd_graphed = rgbd_primed()
    first = run_path("rgbd", rgbd_graphed)
    res_r, elapsed, launches = first
    by_path["rgbd"] = launches
    if not bool(torch.isfinite(res_r.T_world).all()):
        raise AssertionError("rgbd: non-finite pose")
    step = torch.tensor(RGBD_STEP, device=dev)
    step_err = torch.linalg.vector_norm(res_r.relative_xi - step, dim=1)
    require_launched("rgbd", launches, RGBD_KERNELS, (cfg_r.pyramid.levels, RGBD_FRAMES),
                     pose=(POSE_PER_FRAME["rgbd"], RGBD_FRAMES))
    if launches["epipolar"] or launches["regularize"] or launches["regularize_cull"]:
        raise AssertionError(f"rgbd: the mapper's kernels ran: {launches}")
    ms_rgbd = 1e3 * elapsed / RGBD_FRAMES
    phase("rgbd", f"{RGBD_FRAMES} frames {RW}x{RH} -> {RW >> 1}x{RH >> 1} x {cfg_r.pyramid.levels} "
                  f"levels (uint8 gray, uint16 depth), twist error vs step: max "
                  f"{step_err.max().item():.3g} median {step_err.median().item():.3g} "
                  f"(tol {STEP_TOL}), GN iterations per frame "
                  f"{res_r.tracking.iterations.sum(1).float().mean().item():.1f}, "
                  f"launches {launches}, {ms_rgbd:.3f} ms/frame = {1e3 / ms_rgbd:.2f} fps "
                  f"on {card_line}")
    if not step_err.max().item() <= STEP_TOL:
        raise AssertionError("rgbd: a frame-to-frame twist missed the step")
    level_frames["rgbd"] = gn_level_on_path("rgbd", rgbd_graphed, [res_r],
                                            (RH >> cfg_r.pyramid.culls, RW >> cfg_r.pyramid.culls),
                                            cfg_r.pyramid.levels, cfg_r.tracker.max_iterations)
    drivers["rgbd"] = paired_drivers("rgbd", rgbd_primed(), rgbd_eager, RGBD_FRAMES,
                                     lambda o: o.T_world, first)
    drivers["rgbd"]["capture_and_chunk_s"] = capture_s[:]
    phase("rgbd", f"graphed driver vs eager step loop (A, B, B, A): ms/frame "
                  f"{drivers['rgbd']['ms_per_frame']}, every run's poses bitwise equal to the "
                  f"first graphed run's (capture and a {SYNC_FRAMES}-frame chunk "
                  f"{capture_s[0]:.3f} s) on {card_line}")
    cpu_r = rgbd_main("cpu", CPU_FRAMES)
    dT_r = (res_r.T_world[:CPU_FRAMES].cpu() - cpu_r.T_world).abs().max().item()
    same_iters = bool((res_r.tracking.iterations[:CPU_FRAMES].cpu()
                       == cpu_r.tracking.iterations).all())
    phase("rgbd", f"first {CPU_FRAMES} frames on the CPU: max |T_cuda - T_cpu| {dT_r:.3g} "
                  f"(tol {POSE_TOL}), GN iterations equal: {same_iters}")
    if not dT_r <= POSE_TOL:
        raise AssertionError("rgbd: CUDA and CPU runs disagree")
    ms_pair, by_path["rgbd_stepwise"], dT_step = paired_loops(
        "rgbd", lambda: rgbd_primed(STEPWISE_FRAMES), STEPWISE_FRAMES, lambda o: o.T_world,
        first, RGBD_FRAMES)
    gn_loops["rgbd"] = dict(ms_per_frame=ms_pair, stepwise_vs_level_max_dT=dT_step[0],
                           **profiled_loops(lambda: (lambda start=rgbd_start(dev): rgbd_main(
                                               dev, PROFILE_FRAMES, start)),
                                              PROFILE_FRAMES, ms_pair))
    phase("rgbd", f"level kernel vs stepwise loop (A, B, B, A): ms/frame {ms_pair}, "
                  f"stepwise poses within {dT_step[0]:.3g} of the level kernel's (tol "
                  f"{POSE_TOL}); device ops per frame and idle share over {PROFILE_FRAMES} frames: "
                  f"{device_ops(gn_loops['rgbd'])}, "
                  f"stepwise launches {by_path['rgbd_stepwise']} on {card_line}")
    if not dT_step[0] <= POSE_TOL:
        raise AssertionError("rgbd: the stepwise loop's poses differ from the level kernel's")

    # 7. the monocular pipeline seeded with measured depth
    def mono_depth_main():
        sigma0 = torch.full_like(depth, 0.1)
        state = monocular_init_with_depth(grays[0], masks[0], depth, sigma0, K, cfg)
        n = MONO_DEPTH_FRAMES
        return monocular_run(state, grays[1:1 + n], masks[1:1 + n], K, cfg,
                             resets[:n].to(dev))[1]

    res_d, elapsed, launches = run_path("monodepth", mono_depth_main)
    by_path["monodepth"] = launches
    if not bool(torch.isfinite(res_d.T_world).all()):
        raise AssertionError("monodepth: non-finite pose")
    require_launched("monodepth", launches, MONO_KERNELS,
                     (cfg.pyramid.levels, MONO_DEPTH_FRAMES),
                     mono=("fused", MONO_DEPTH_FRAMES, int(res_d.is_keyframe.sum()), 1))
    phase("monodepth", f"{MONO_DEPTH_FRAMES} frames 640x480, "
                       f"{int(res_d.is_keyframe.sum())} promotions, launches {launches}, "
                       f"{1e3 * elapsed / MONO_DEPTH_FRAMES:.3f} ms/frame")

    # 8. host syncs per frame after capture, inputs already on the card (a
    # copy from pageable host memory syncs, so nothing is shipped inside).
    # Each path runs two chunks: the first captures its graph (entering a
    # capture synchronises once: counted apart), the second only replays.
    n = SYNC_FRAMES
    d_grays, d_masks, d_counts = (x[1:1 + 2 * n].to(dev) for x in (r_grays, r_masks, r_counts))
    d_K = r_K.to(dev)
    _build.reset_launches()
    chunk_r = lambda st, sl: rgbd_run_raw(st, d_grays[sl], d_masks[sl], d_counts[sl], d_K, cfg_r,
                                          depth_scale=DEPTH_SCALE)
    mid = []
    syncs_capture = dict(rgbd=count_syncs(lambda: mid.append(
        chunk_r(rgbd_start(dev), slice(0, n))[0])))
    syncs_rgbd = count_syncs(lambda: chunk_r(mid[0], slice(n, 2 * n)))
    captures = dict(rgbd=_build.CAPTURES)
    # The 48-frame mono run (17 promotions) in two chunks: the keyframe
    # decision stays on the device.  With BA too (an IF node of the graph):
    # the ba phase counts those.
    _build.reset_launches()
    d_grays_m, d_masks_m = grays[1:1 + N_FRAMES], masks[1:1 + N_FRAMES]
    d_resets = resets[:N_FRAMES].to(dev)
    chunk_m = lambda st, sl: monocular_run(st, d_grays_m[sl], d_masks_m[sl], K, cfg,
                                           d_resets[sl])
    mono_out = []
    syncs_capture["mono"] = count_syncs(lambda: mono_out.append(
        chunk_m(init(dev), slice(0, CHUNK))))
    syncs_mono = count_syncs(lambda: mono_out.append(
        chunk_m(mono_out[0][0], slice(CHUNK, N_FRAMES))))
    captures["mono"] = _build.CAPTURES
    kf_sync = int(sum(int(r[1].is_keyframe.sum()) for r in mono_out))
    n_mono = N_FRAMES - CHUNK
    phase("syncs", f"per frame after capture: rgbd {syncs_rgbd / n:g} over {n} frames, mono "
                   f"{syncs_mono / n_mono:g} over {n_mono} frames ({kf_sync} promotions in both "
                   f"chunks); captures per run {captures}; host syncs of the first chunk with "
                   f"the init (its host-to-device copies) and the capture {syncs_capture}")
    if syncs_rgbd != 0 or syncs_mono != 0 or kf_sync == 0:
        raise AssertionError("host syncs: expected none on rgbd and none on mono")
    if captures != dict(rgbd=1, mono=1):
        raise AssertionError(f"expected one capture per run: {captures}")

    # 8b. one step of each path captured in a CUDA graph and replayed; the
    # mono step on the stable rig, from the state after its first promotion
    # past CHUNK frames (its promotions alternate with frames that are none)
    cfg_m, K_m, (g_m, m_m) = _cull_chunk(cfg, K, grays[1:], masks[1:])
    r_m = resets.to(dev)
    after = monocular_run(stable_start(cfg, grays, masks, K, depth, dev), grays[1:1 + CHUNK],
                          masks[1:1 + CHUNK], K, cfg, resets[:CHUNK].to(dev))[0]
    j = CHUNK
    while True:
        after, first_step = monocular_step(after, g_m[j], m_m[j], K_m, cfg_m, r_m[j])
        if bool(first_step.is_keyframe):
            break
        j += 1
        if j + 1 + GRAPH_REPLAYS > N_FRAMES:
            raise AssertionError(f"graphs: no promotion on the stable rig in frames "
                                 f"{CHUNK}-{j}")
    g_m, m_m, r_m = (x[j + 1:j + 1 + GRAPH_REPLAYS] for x in (g_m, m_m, r_m))
    mono_in = (g_m[0].clone(), m_m[0].clone(), r_m[0].clone())
    cfg_rc, K_r, (g_r, m_r, c_r) = _cull_chunk(
        cfg_r, r_K.to(dev), *(x[1:1 + GRAPH_REPLAYS].to(dev) for x in (r_grays, r_masks, r_counts)))
    d_r, s_r = raw_depth(c_r, DEPTH_SCALE)
    rgbd_in = (g_r[0].clone(), m_r[0].clone(), d_r[0].clone(), s_r[0].clone())
    state_g = rgbd_start(dev)
    graphs = {
        "mono": graph_phase(card_line, "mono", lambda: monocular_step(after, *mono_in[:2], K_m,
                                                                      cfg_m, mono_in[2]),
                            mono_in, list(zip(g_m, m_m, r_m)), MONO_KERNELS, cfg.pyramid.levels),
        "rgbd": graph_phase(card_line, "rgbd", lambda: rgbd_step(state_g, *rgbd_in, K_r, cfg_rc),
                            rgbd_in, list(zip(g_r, m_r, d_r, s_r)), RGBD_KERNELS,
                            cfg_r.pyramid.levels),
    }
    if len(set(graphs["mono"]["keyframes"])) != 2:
        raise AssertionError(f"graphs: mono replays of one kind only: {graphs['mono']}")
    graphs["mono"]["eager_ms_per_frame_main"] = ms_frame
    graphs["rgbd"]["eager_ms_per_frame_main"] = ms_rgbd

    # 8c. B streams on one card; 8d. the stream drivers on a process group
    streams = streams_phase(dev, card_line, cfg, cfg_r, r_grays, r_masks, r_counts, r_K)
    by_path.update(streams_mono=streams["mono"]["launches"],
                   streams_rgbd=streams["rgbd"]["launches"])
    parallel = parallel_phase(dev, card_line, cfg, cfg_r, streams.pop("inputs"),
                              (r_grays, r_masks, r_counts, r_K))
    # 8e. the sharded solvers' step (dvo_tpu_torch.parallel.{tracking,mapping,ba})
    sharded, sharded_launches, sharded_kernels = sharded_phase(dev, card_line)
    sharded["kernels"] = sharded_rows
    by_path.update(sharded_launches)
    entries["gn"]["sharded_row_blocks"] = sharded_kernels["gn"]
    kernels.append(sharded_kernels["gn_step"])
    for name in ("gn", "gn_step"):
        next(k for k in kernels if k["name"] == name)["launches_per_sharded_track"] = {
            "one_rank": sharded["one_rank"]["launches"]["tracking"][name],
            "gloo_rank0": sharded["gloo"]["launches"][0]["tracking"][name]}

    # 9. the CLI, python -m dvo_tpu_torch.run, on PNG sequences
    cli = cli_phase(dev, card_line, grays, K, r_grays, r_counts, r_K, cfg, cfg_r, by_path,
                    resets)

    # 10, 11. the back end
    back_end = dict(
        ba=ba_phase(dev, card_line, grays, masks, K, cfg, noise, resets, by_path, depth),
        posegraph=posegraph_phase(dev, card_line, grays, K, cfg, by_path))

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    _, ms, plain_ms = fb[rgbd_label]
    kernels.append(with_bound(
        dict(name="framebuild", route="cuda", source="dvo_tpu_torch/csrc/framebuild.cu",
             replaces="dvo_tpu/ops/pallas/framebuild.py:103",
             max_abs_err=max(v[0] for v in fb.values()), ms=ms, plain_ms=plain_ms, **fb_device,
             ms_by_shape={k: v[1] for k, v in fb.items()},
             plain_ms_by_shape={k: v[2] for k, v in fb.items()}), *fb_work))
    # Each row's launch floor on this card: an empty launch, and a copy of its
    # bytes (csrc/floor.cu), through the same ctypes route.
    for k in kernels:
        fl = framebuild_floor.floor_us(k["bytes"], device_profile)
        k.update(launch_floor_us=fl["empty_us"], copy_floor_us=fl["copy_us"],
                 copy_floor_bytes=fl["copy_bytes"])
        phase("kernels", f"{k['name']}: device {k['device_us']:.2f} us, launch floor "
                         f"{fl['empty_us']:.2f} us, a copy of its {fl['copy_bytes']} B "
                         f"{fl['copy_us']:.2f} us, bound {k['bound_us']:.3f} us on {card_line}")
    kernels.extend(pose_rows)     # their floors taken in the pose phase
    frames_by_path = {"mono": N_FRAMES, "rgbd": RGBD_FRAMES, "mono_stepwise": STEPWISE_FRAMES,
                      "rgbd_stepwise": STEPWISE_FRAMES, "mono_fields": N_FRAMES,
                      "mono_ba": N_FRAMES, "streams_mono": STREAMS * STREAM_FRAMES,
                      "streams_rgbd": STREAMS * STREAM_FRAMES,
                      "sharded": 1, "sharded_gloo_rank0": 1}     # per step
    for k in kernels:
        if "times_by_shape" in k:
            times = k.pop("times_by_shape")
            k["ms_by_shape"] = {s: v[0] for s, v in times.items()}
            k["plain_ms_by_shape"] = {s: v[1] for s, v in times.items()}
            if k["name"] == "gn_level":
                k["stepwise_ms_by_shape"] = {s: v[2] for s, v in times.items()}
                k["launch_shape_by_shape"] = {s: v[3] for s, v in times.items()}
        if "work_by_shape" in k:
            k["bound_us_by_shape"] = {s: _build.bound_us(*w)[0]
                                      for s, w in k["work_by_shape"].items()}
        # Both epipolar entries launch one kernel and share its count: the
        # fields entry's launches are those of the fields route, the fused
        # entry's those of every other path.
        counter = k.get("counter", k["name"])
        on_path = {"epipolar": lambda path: path == "mono_fields",
                   "epipolar_fused": lambda path: path != "mono_fields"}.get(k["name"],
                                                                             lambda path: True)
        k["launches_by_path"] = {path: p[counter] for path, p in by_path.items()
                                 if on_path(path)}
        k["launches"] = sum(k["launches_by_path"].values())
        k["launches_per_frame"] = {path: by_path[path][counter] / n
                                   for path, n in frames_by_path.items() if on_path(path)}
    next(k for k in kernels if k["name"] == "gn_level")["per_frame_by_path"] = level_frames
    print(json.dumps(plain_json({"kernels": kernels, "gn_loops": gn_loops, "mapper_routes": routes,
                      "epipolar_lanes": lanes_rows, "planes": planes, "graphs": graphs,
                      "ms_per_frame": ms_frame, "rgbd_ms_per_frame": ms_rgbd,
                      "syncs_per_frame": {"mono": syncs_mono / n_mono, "rgbd": syncs_rgbd / n},
                      "syncs_in_capture_chunk": syncs_capture, "captures_per_run": captures,
                      "drivers": drivers, "streams": streams, "parallel": parallel,
                      "sharded": sharded, "regularize_sweep": reg_sweep,
                      "stable_rig": dict(readings=stable, cpu_max_dT=dT_stable),
                      "step_gates": dict(step_gates, ba=back_end["ba"]["step_gates"]),
                      "cli": cli, "back_end": back_end, "card": card_line})))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if "--sharded-rank" in sys.argv[1:]:
        sharded_rank(sys.argv[sys.argv.index("--sharded-rank") + 1], "--nccl" in sys.argv[1:])
    else:
        main()
