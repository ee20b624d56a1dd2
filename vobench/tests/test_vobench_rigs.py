"""The rigs: the same seed gives the same frames, another seed another scene
of the same size, large seeds are taken, the path closes, and nothing is
written to disk."""

import os

import torch

from vobench import rigs
from vobench.drivers import Reservoir, stream_seed

K = [[150.0, 0.0, 80.0], [0.0, 150.0, 60.0], [0.0, 0.0, 1.0]]


def test_same_seed_same_frames_another_seed_the_same_set():
    a, _ = rigs.render((60, 80), K, 8, 0.012, 0, 2**31 + 17, "cpu")
    b, _ = rigs.render((60, 80), K, 8, 0.012, 0, 2**31 + 17, "cpu")
    c, _ = rigs.render((60, 80), K, 8, 0.012, 0, 2**40 + 3, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (8, 60, 80)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the same views in another order: the seed moves the cycle's start
    assert any(torch.equal(torch.roll(c, r, 0), a) for r in range(8))
    other, _ = rigs.render((60, 80), K, 8, 0.012, 1, 2**31 + 17, "cpu")
    assert not any(torch.equal(torch.roll(other, r, 0), a) for r in range(8))
    assert a.float().std() > 20


def test_rgbd_counts_noise_and_holes():
    g, c = rigs.render((60, 80), K, 4, 0.006, 0, 9, "cpu", depth_scale=5000.0, noise=0.06,
                       holes=0.03)
    assert c.dtype == torch.uint16 and c.shape == g.shape
    share = (c.to(torch.int32) == 0).float().mean()
    assert 0.01 < share < 0.06
    depth = c.to(torch.float32)[c.to(torch.int32) > 0] / 5000.0
    assert 0.3 < depth.min() and depth.max() < 10.0


def test_path_closes():
    k = torch.tensor([0.0, 120.0, 1.0, 121.0], dtype=torch.float64)
    c, yaw = rigs._path(k, 120, 0.012)
    assert torch.allclose(c[0], c[1]) and torch.allclose(c[2], c[3])
    assert torch.allclose(yaw[0], yaw[1])
    step = (c[2] - c[0]).norm()
    assert 0.008 < step < 0.016


def test_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rigs.render((30, 40), K, 2, 0.012, 0, 1, "cpu", depth_scale=5000.0, noise=0.06, holes=0.03)
    assert os.listdir(tmp_path) == []


def test_stream_seeds_differ_and_reservoir_keeps_k():
    import numpy as np

    assert len({stream_seed(3, b) for b in range(8)}) == 8
    r = Reservoir(3, np.random.default_rng(0))
    for i in range(100):
        r.offer(lambda i=i: i)
    assert len(r.items) == 3 and r.seen == 100 and len(set(r.items)) == 3

