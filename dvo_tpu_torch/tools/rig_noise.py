"""How far float noise steers a monocular rig, rehearsed on the CPU.

Run from the repository root (no card needed; the plain versions):

    python -m dvo_tpu_torch.tools.rig_noise [--rig RIG] [--frames N] [--draws 11,12] [--ba]

runs ``chip_smoke.py``'s monocular path on a rig (``render+depth``: its
``render`` frames with the first keyframe at frame 0's true depth, sigma
``chip_smoke.STABLE_SIGMA``; ``planes``: ``render_planes`` with its true
first depth; ``noise``: ``render`` with the noise bootstrap) once as it is
and once per draw with every GN level's xi moved by ``REL`` relative (and
``ABS`` absolute) noise from a generator seeded with the draw: the size of
the difference between two launch shapes of ``csrc/gn_level.cu``, or
between the card and the CPU.  Prints per draw the largest pose difference,
the first frame past ``chip_smoke.POSE_TOL`` and whether the keyframe
decisions stayed equal; with ``--ba`` the BA configuration of
``chip_smoke.py``'s ba phase, and the readings of its gates (before the
first BA, before the second, over all frames).

    python -m dvo_tpu_torch.tools.rig_noise --per-frame [--rig noise] [--ba]

holds each step of the unperturbed run against the same step from the same
state with the noise in (``tools/step_gate``, the card's per-frame gate),
and prints the worst readings.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

REL, ABS = 2e-7, 1e-9


def perturbed(gn_level, seed: int):
    """``gn_level`` with its xi moved by noise from a generator seeded
    ``seed`` on every call."""
    gen = torch.Generator().manual_seed(seed)

    def level(planes, K, xi0, level_index, cfg):
        xi, *rest = gn_level(planes, K, xi0, level_index, cfg)
        noise = REL * torch.randn(6, generator=gen), ABS * torch.randn(6, generator=gen)
        return (xi * (1 + noise[0]) + noise[1], *rest)

    return level


def rig(cs, name: str, cfg):
    """(first state, culled frames, masks, K, reset planes, culled cfg) of
    a rig on the CPU."""
    from dvo_tpu_torch.models.odometry import (
        _cull_chunk,
        monocular_init,
        monocular_init_with_depth,
    )

    gen = torch.Generator().manual_seed(cs.SEED)
    h0, w0 = cs.H >> cfg.pyramid.culls, cs.W >> cfg.pyramid.culls
    noise = torch.randn((h0, w0), generator=gen)
    resets = torch.clamp(0.5 + 1.5 * torch.rand((cs.N_FRAMES, h0, w0), generator=gen), max=4.0)
    if name == "planes":
        grays, masks, K, depth = cs.render_planes("cpu", cs.N_FRAMES)
        start = monocular_init_with_depth(grays[0], masks[0], depth,
                                          torch.full_like(depth, cs.PLANE_SIGMA), K, cfg,
                                          device="cpu")
    else:
        grays, masks, K, depth = cs.render_sequence("cpu")
        start = (cs.stable_start(cfg, grays, masks, K, depth, "cpu") if name == "render+depth"
                 else monocular_init(grays[0], masks[0], K, cfg, device="cpu", noise=noise))
    cfg0, K0, (g, m) = _cull_chunk(cfg, K, grays[1:], masks[1:])
    return start, g, m, K0, resets, cfg0


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rig", default="render+depth", choices=("render+depth", "planes",
                                                                  "noise"))
    parser.add_argument("--frames", type=int, default=32)
    parser.add_argument("--draws", default="11,12,13,14,15,16")
    parser.add_argument("--ba", action="store_true")
    parser.add_argument("--per-frame", action="store_true")
    opts = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.models import tracker
    from dvo_tpu_torch.models.odometry import monocular_step
    from dvo_tpu_torch.tools import step_gate

    cfg = DVOConfig.monocular()
    if opts.ba:
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
            cfg.ba, enabled=True, window=cs.BA_WINDOW, iterations=cs.BA_ITERS))
    start, g, m, K, resets, cfg0 = rig(cs, opts.rig, cfg)
    real = tracker.gn_level
    step = lambda st, i: monocular_step(st, g[i], m[i], K, cfg0, resets[i])

    def with_noise(seed):
        level = perturbed(real, seed)

        def noisy_step(st, i):
            tracker.gn_level = level
            try:
                return step(st, i)
            finally:
                tracker.gn_level = real
        return noisy_step

    n = min(opts.frames, g.shape[0])
    if opts.per_frame:
        for seed in (int(s) for s in opts.draws.split(",")):
            _, _, readings = step_gate.per_frame_gates(
                start, range(n), with_noise(seed), step, cfg.tracker.max_iterations,
                cs.BA_SOLVE_TOL if opts.ba else cs.POSE_TOL, cs.MAP_VALUE_TOL,
                0.0 if opts.ba else cs.MAP_SHARE,
                gate=(lambda i, r: float(r.ba_cost) >= 0) if opts.ba else (lambda i, r: True))
            for check, got in readings.items():
                print(json.dumps(dict(rig=opts.rig, draw=seed, ba=opts.ba, check=check,
                                      **step_gate.summary(got))), flush=True)
        return

    def run(fn):
        st, T, kf, ba = start, [], [], []
        for i in range(n):
            st, r = fn(st, i)
            T.append(r.T_world)
            kf.append(bool(r.is_keyframe))
            ba.append(float(r.ba_cost) >= 0)
        return torch.stack(T), kf, ba

    T0, kf0, ba0 = run(step)
    ba_frames = [i for i, b in enumerate(ba0) if b]
    print(json.dumps(dict(rig=opts.rig, frames=n, ba=opts.ba, ba_frames=ba_frames,
                          decisions="".join("K" if k else "." for k in kf0))), flush=True)
    for seed in (int(s) for s in opts.draws.split(",")):
        T1, kf1, _ = run(with_noise(seed))
        d = (T0 - T1).abs().flatten(1).max(dim=1).values
        past = [i for i, v in enumerate(d.tolist()) if v > cs.POSE_TOL]
        row = dict(draw=seed, max_dT=d.max().item(), first_frame_past_pose_tol=(
            past[0] if past else None), keyframes_equal=kf0 == kf1)
        if opts.ba and len(ba_frames) > 1:
            row.update(before_first_ba=d[:ba_frames[0]].max().item(),
                       before_second_ba=d[:ba_frames[1]].max().item())
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
