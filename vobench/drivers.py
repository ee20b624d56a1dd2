"""What every traffic loop (``vobench/loops/<loop>.py``) shares: the
cell's inputs made from the seed, the record of a run that the judge and
the metric readers read, and the seeded sample of judged chunks.

Everything is made from the seed at set-up: rigs, the first keyframe's
bootstrap noise, the depth filter's reset planes (handed to the program
as inputs, so that the reference is given the same).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vobench import rigs


@dataclasses.dataclass
class Inputs:
    """A cell's inputs, made from the seed: per stream the rig's frames
    (``gray`` (B, M, H, W) uint8, ``counts`` uint16 or None) in host memory
    (the loop lays them out for its upload),
    the mask and K on the device, the bootstrap noise (B, h, w) and the
    reset planes (B, M, h, w) on the device."""
    gray: torch.Tensor
    counts: object
    mask: torch.Tensor
    K: torch.Tensor
    noise: object
    resets: object


def stream_seed(seed: int, b: int) -> int:
    return int(np.random.SeedSequence(seed, spawn_key=(b,)).generate_state(1, np.uint64)[0])


def make_inputs(config: dict, traffic: dict, seed: int, device, shape=None) -> Inputs:
    """The rigs of ``traffic['streams']`` cameras, stream b on scene b
    (``shape`` overrides the configuration's input size: the CPU tests'
    small frames)."""
    inp, rig, mode = config["input"], config["rig"], config["mode"]
    h, w = shape or (inp["height"], inp["width"])
    K = config["K"] if shape is None else _scaled_K(config["K"], inp, shape)
    B, M = traffic["streams"], traffic["period"]
    grays, counts = [], []
    for b in range(B):
        g, c = rigs.render((h, w), K, M, rig["step_m"], b, stream_seed(seed, b), device,
                           depth_scale=rig["depth_scale"], noise=rig["gray_noise"],
                           holes=rig["holes"])
        grays.append(g)
        counts.append(c)
    gray = torch.stack(grays).cpu()
    count = torch.stack(counts).cpu() if mode == "rgbd" else None
    dev = torch.device(device)
    mask = torch.ones((h, w), dtype=torch.bool, device=dev)
    Kt = torch.tensor(K, dtype=torch.float32, device=dev)
    noise = resets = None
    if mode == "mono":
        culls = config["dvo"]["pyramid"]["culls"]
        hc, wc = -(-h // 2 ** culls), -(-w // 2 ** culls)
        gen = torch.Generator(device=dev).manual_seed(stream_seed(seed, 1 << 20))
        noise = torch.randn((B, hc, wc), generator=gen, device=dev)
        fc = config["dvo"]["mapper"]["depth_filter"]
        lo, hi = fc["reset_depth_range"]
        u = torch.rand((B, M, hc, wc), generator=gen, device=dev)
        resets = torch.clamp(lo + (hi - lo) * u, max=fc["reset_depth_cap"])
    return Inputs(gray, count, mask, Kt, noise, resets)


def _scaled_K(K, inp, shape):
    sx, sy = shape[1] / inp["width"], shape[0] / inp["height"]
    return [[K[0][0] * sx, 0.0, K[0][2] * sx], [0.0, K[1][1] * sy, K[1][2] * sy], [0.0, 0.0, 1.0]]


@dataclasses.dataclass
class Sample:
    """A judged chunk: its rig index, the program's state before it and
    after it, and its outputs (``program.fields``, on the device)."""
    chunk: int
    before: object
    after: object
    outputs: dict


@dataclasses.dataclass
class Run:
    """What a run hands the judge and the metric readers."""
    frames: int                  # frames whose results reached the host in the window
    window_s: float              # the window's wall, untraced in every run
    setup_s: float = 0.0
    capture_s: float = None      # first window-sized call less a steady one
    host: dict = None            # drained outputs of the traced part and the window
    samples: list = None         # judged chunks
    first: object = None         # the program's first state (the start the judge checks)
    trace: object = None         # profiling.Trace of the traced part
    memory_peak_bytes: int = 0
    inputs: object = None        # the cell's Inputs, which the judge hands the reference
    readings: dict = None        # the host's, for standard error only (``host.report``)


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn from ``rng`` (reservoir sampling)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, make):
        """Offer the next item; ``make()`` builds it only when it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = make()


