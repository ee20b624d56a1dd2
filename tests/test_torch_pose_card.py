"""``csrc/pose.cu`` on the card, against the plain versions of
``ops/cuda/pose`` on the same CUDA tensors.  Every test here is marked
``card`` and skips without one; run them on the card with

    python -m pytest --noconftest -o addopts= -m card tests/test_torch_pose_card.py

(``--noconftest``: ``tests/conftest.py`` configures JAX, which that machine
does not have; nothing here imports it).  ``tests/test_torch_pose.py``
shares the cases below and runs the same checks on the CPU through an
emulation of the kernel.

* Each entry within ``4e-6 * max(1, |plain|)`` of its plain version (2e-5
  near pi, where the logarithm amplifies the order of the 3x3 sums), the
  0/1 entries of its 4x4s and the table's unused columns exact, the same
  bits on a second run.
* A graphed monocular frame adds 3 to ``LAUNCHES["pose"]`` and an RGB-D
  frame 2, every other counter as with the pose entries on their plain
  versions.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import DVOConfig
from dvo_tpu_torch.ops.cuda import _build, pose

AXIS = np.array([1.0, 2.0, -2.0], np.float32) / 3.0
# name: (ref_xi or the mono warm start's prev_rel, rel_xi or vel, prev_rel),
# each [v; w].
CASES = {
    "zero": ([0.0] * 6, [0.0] * 6, [0.0] * 6),
    "below_1e-6": ([0.1, 0, 0, 4e-7, 0, 0], [0, 0.02, 0, 0, -3e-7, 1e-7],
                   [0.01, 0, -0.01, 1e-8, 0, 0]),
    "near_pi": ([0.3, -0.2, 0.5, *(3.1 * AXIS)], [0.05, 0.01, 0.0, 0.01, 0.02, -0.01],
                [0.02, 0.0, 0.0, 0.0, 0.0, 3.1]),
    "metres": ([3.5, -2.0, 6.0, 0.1, -0.3, 0.2], [1.2, 0.4, -2.5, 0.05, 0.0, 0.1],
               [-4.0, 1.0, 2.0, 0.0, 0.2, 0.0]),
    "generic": ([0.12, -0.05, 0.3, 0.04, -0.11, 0.07], [0.01, 0.02, -0.015, 0.003, -0.002, 0.006],
                [-0.02, 0.01, 0.005, -0.004, 0.001, 0.002]),
}
# (entry, flag): the warm start's gate kept (True) or zeroed, need_kf for emit.
ENTRIES = [("warm_mono", True), ("warm_mono", False), ("warm_rgbd", True),
           ("warm_rgbd", False), ("track_mono", None), ("track_rgbd", None),
           ("emit", True), ("emit", False)]
CARD_TOL = 4e-6
NEAR_PI_TOL = 2e-5
PLAIN = SimpleNamespace(warm=pose.warm_plain, track=pose.track_plain, emit=pose.emit_plain)

pytestmark = pytest.mark.card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest -o addopts= -m card "
                    "tests/test_torch_pose_card.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def tol_of(case):
    return NEAR_PI_TOL if case == "near_pi" else CARD_TOL


def twists(case, device="cpu"):
    return [torch.tensor(x, dtype=torch.float32, device=device) for x in CASES[case]]


def max_norm(x, keep):
    """A gate the twist ``x`` passes (``keep``) or fails."""
    n = float(torch.linalg.vector_norm(x))
    return 2.0 * n + 1e-3 if keep else 0.5 * n


def call(entry, flag, case, module, device="cpu"):
    """(the entry's outputs through ``module``, the ``lie`` sequence the
    step made before): ``module`` is ``pose`` (the wrappers) or ``PLAIN``."""
    a, b, p = twists(case, device)
    if entry == "warm_mono":
        old_x = lie.compose(a, b)
        gate = max_norm(old_x, flag)
        old = torch.where(torch.linalg.vector_norm(old_x) < gate, old_x, 0.0)
        return [module.warm(b, gate, prev_rel=a)], [old]
    if entry == "warm_rgbd":
        gate = max_norm(b, flag)
        return [module.warm(b, gate)], [torch.where(torch.linalg.vector_norm(b) < gate, b, 0.0)]
    if entry == "track_mono":
        xi, vel, T = module.track(a, b, prev_rel=p)
        assert T is None
        return [xi, vel], [lie.compose(a, b), lie.compose(-p, b)]
    if entry == "track_rgbd":
        xi, vel, T = module.track(a, b, world=True)
        assert vel is None
        frame_xi = lie.compose(a, b)
        return [xi, T], [frame_xi, lie.se3_exp(frame_xi)]
    need_kf = torch.tensor(flag, device=device)
    frame_xi = lie.compose(a, b)
    T, prev_rel = module.emit(need_kf, p, frame_xi, b)
    return [T, prev_rel], [lie.se3_exp(torch.where(need_kf, p, frame_xi)),
                           torch.where(need_kf, 0.0, b)]


def table_inputs(case, capacity, device="cpu"):
    """K, the object frame's world twist, the relative twist and a ring of
    ``capacity`` twists (``.xi``, ``.capacity``): the case's three first,
    then generic ones."""
    a, b, p = twists(case)
    rng = np.random.default_rng(capacity)
    extra = torch.from_numpy((rng.standard_normal((max(capacity - 3, 0), 6)) * 0.2)
                             .astype(np.float32))
    hist = torch.cat([torch.stack([p, a, b]), extra])[:capacity].contiguous()
    K = torch.tensor([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]])
    return (K.to(device), a.to(device), b.to(device),
            SimpleNamespace(xi=hist.to(device), capacity=capacity))


def within(got, want, tol=CARD_TOL):
    """Elementwise ``|got - want| <= tol * max(1, |want|)``."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        bound = tol * torch.clamp(w.abs(), min=1.0)
        assert torch.all((g - w).abs() <= bound), (g - w).abs().max()


def last_row_exact(T):
    """A 4x4's last row exactly (0, 0, 0, 1)."""
    assert torch.equal(T[3].cpu(), torch.tensor([0.0, 0.0, 0.0, 1.0]))


def table_zeros_exact(table):
    c = table.shape[0] - 2
    assert torch.equal(table[0, 9:].cpu(), torch.zeros(7))
    assert torch.equal(table[1, 13:].cpu(), torch.zeros(3))
    assert torch.equal(table[2:, 15].cpu(), torch.zeros(c))


# ------------------------------------------------------------- the entries

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("entry,flag", ENTRIES)
def test_kernel_entry_matches_its_plain_version(entry, flag, case, cuda):
    _build.reset_launches()
    got, _ = call(entry, flag, case, pose, cuda)
    again, _ = call(entry, flag, case, pose, cuda)
    want, _ = call(entry, flag, case, PLAIN, cuda)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pose"] == 2
    within(got, want, tol_of(case))
    for g, h in zip(got, again):
        assert torch.equal(g, h)
        if g.shape == (4, 4):
            last_row_exact(g)
    if entry == "emit" and flag:
        assert torch.equal(got[1].cpu(), torch.zeros(6))


@pytest.mark.parametrize("capacity", [1, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_table_matches_its_plain_version(case, capacity, cuda):
    K, obj, rel, hist = table_inputs(case, capacity, cuda)
    got = pose.table(K, obj, rel, hist.xi)
    again = pose.table(K, obj, rel, hist.xi)
    want = pose.table_plain(K, obj, rel, hist.xi)
    torch.cuda.synchronize()
    within([got], [want], tol_of(case))
    assert torch.equal(got, again)
    table_zeros_exact(got)


# ---------------------------------------------------------- graphed frames

H, W, N = 48, 64, 6


def frames(device):
    """N frames of a smooth texture sliding right a pixel a frame, an
    all-valid mask, K, and a depth map 1.5-1.9 m with sigma 0.1."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:H, 0:W + N].astype(np.float32)
    tex = sum(np.sin(fx * x + fy * y + ph) for fx, fy, ph in rng.uniform(0.05, 0.4, (8, 3)))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    grays = np.stack([tex[:, N - k:N - k + W] for k in range(N)]).astype(np.float32)
    masks = np.ones((N, H, W), bool)
    depth = (1.5 + 0.4 * tex[:, :W]).astype(np.float32)
    K = np.array([[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]], np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(grays), t(masks), t(np.repeat(depth[None], N, 0)), t(np.full((N, H, W), 0.1,
                                                                          np.float32)), t(K))


def _configs():
    mono = DVOConfig.monocular()
    mono = dataclasses.replace(
        mono, pyramid=dataclasses.replace(mono.pyramid, levels=2, culls=0),
        mapper=dataclasses.replace(mono.mapper, crop_x=(4, W - 5), crop_y=(4, H - 5),
                                   max_forward=2))
    rgbd = DVOConfig.rgbd()
    rgbd = dataclasses.replace(rgbd, pyramid=dataclasses.replace(rgbd.pyramid, levels=2,
                                                                 culls=0))
    return mono, rgbd


def run_chunk(path, device):
    """One graphed chunk of N - 1 frames from a fresh first state: (the
    launch counters after it, its StepResult)."""
    from dvo_tpu_torch.models import odometry

    g, m, d, s, K = frames(device)
    mono, rgbd = _configs()
    torch.cuda.synchronize()
    if path == "mono":
        state = odometry.monocular_init(g[0], m[0], K, mono, device=device,
                                        noise=torch.zeros(H, W, device=device))
        run = lambda: odometry.monocular_run(state, g[1:], m[1:], K, mono,
                                             reset_depths=torch.ones(N - 1, H, W, device=device))
    else:
        state = odometry.rgbd_init(g[0], m[0], d[0], s[0], K, rgbd, device=device)
        run = lambda: odometry.rgbd_run(state, g[1:], m[1:], d[1:], s[1:], K, rgbd)
    _build.reset_launches()
    _, res = run()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert _build.CAPTURES == 1
    return launches, res


@pytest.mark.parametrize("path,per_frame", [("mono", 3), ("rgbd", 2)])
def test_graphed_frame_launches_the_pose_entries(path, per_frame, cuda, monkeypatch):
    launches, res = run_chunk(path, cuda)
    with monkeypatch.context() as patch:
        for name in ("warm", "track", "table", "emit"):
            patch.setattr(pose, name, getattr(pose, name + "_plain"))
        plain_launches, plain_res = run_chunk(path, cuda)
    assert launches["pose"] == per_frame * (N - 1) and plain_launches["pose"] == 0
    assert {k: v for k, v in launches.items() if k != "pose"} == {
        k: v for k, v in plain_launches.items() if k != "pose"}
    for T in res.T_world:
        last_row_exact(T)
    # The first frame tracks from the same state on both: its pose differs
    # by the pose algebra's ulps alone.
    within([res.T_world[0]], [plain_res.T_world[0]], CARD_TOL)
