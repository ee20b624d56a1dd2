"""The sharded solvers of ``dvo_tpu_torch.parallel`` (``tracking``,
``mapping``, ``ba``) against ``dvo_tpu.parallel``'s on the 8-device virtual
mesh, mirroring ``tests/test_parallel.py`` and ``tests/test_ba.py``'s
sharded tests; and the row offset of the kernels' plain versions and of the
epipolar kernel's NumPy transcription.

Each sharded module runs in its own gloo group of four processes (each
joined with a timeout, so a hang fails instead of eating the suite's
limit), on a 4-tile mesh and on the (kf 2, tile 2) mesh of
``__graft_entry__.dryrun_multichip``; ``dvo_tpu``'s functions run jitted in
this process (eagerly, a shard_map compiles per primitive: minutes).
Inputs are made by numpy from a seed.  Tolerances:
  * GN: ``test_parallel.py``'s (H, g rtol 1e-5 and atol 1e-4, the residual
    sum rtol 1e-5, the count exact); sharded track: rtol 1e-4, atol 2e-5
    (``test_parallel.py:59``);
  * mapping: against the port's single-device update on the same reset
    plane bitwise (every pixel is independent, the counts are integer
    sums); against ``dvo_tpu``'s, fed the reset blocks its tiles draw, the
    counts exact and the maps within 1e-5;
  * BA: ``test_ba.py:183-187``'s (first cost rtol 1e-5, costs rtol 5e-3,
    xi atol 1e-3, 95% of depths within 0.05).
Every rank must return the same result."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu.config import BAConfig as JBAConfig
from dvo_tpu.config import MapperConfig as JMapperConfig
from dvo_tpu.config import TrackerConfig as JTrackerConfig
from dvo_tpu.models import mapper as jmapper
from dvo_tpu.models import tracker as jtracker
from dvo_tpu.models.history import KeyframeHistory, push
from dvo_tpu.parallel.ba import bundle_adjust_sharded as j_bundle_adjust_sharded
from dvo_tpu.parallel.mapping import sharded_depth_update as j_sharded_depth_update
from dvo_tpu.parallel.mesh import make_mesh as j_make_mesh
from dvo_tpu.parallel.tracking import sharded_gn_normal_equations as j_sharded_gn
from dvo_tpu.parallel.tracking import sharded_track as j_sharded_track
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.models import ba as tba
from dvo_tpu_torch.models import mapper as tmapper
from dvo_tpu_torch.models import tracker as ttracker
from dvo_tpu_torch.models.odometry import frame_from_reference
from dvo_tpu_torch.ops.cuda import _build, epipolar, gn

import test_torch_epipolar_fused as transcription
from test_ba import _make_window
from test_mapper import _single_kf_setup, smooth_image
from test_parallel import _frames
from test_torch_mapper import _port_history
from test_torch_tracker import _assert_terms_close

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
RANKS = 4
JOIN_S = 120
XI = np.asarray([0.01, -0.005, 0.002, 0.001, 0.0, -0.001], np.float32)

WORKER = r"""
import os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from dvo_tpu_torch.parallel import (bundle_adjust_sharded, initialize, make_mesh,
                                    sharded_depth_update, sharded_gn_normal_equations,
                                    sharded_track)

folder, part = sys.argv[1:3]
initialize(device="cpu")
meshes = {4: make_mesh((4,), ("tile",), device="cpu"),
          2: make_mesh((2, 2), ("kf", "tile"), device="cpu")}
with open(os.path.join(folder, "in.pkl"), "rb") as f:
    cases = pickle.load(f)
out = {}
for name, case in cases.items():
    if part == "tracking" and name.startswith("gn"):
        obj, ref, xi, level, cfg, tiles = case
        H, g, r, c = sharded_gn_normal_equations(obj.scenes[level], ref.scenes[level], xi,
                                                 level, cfg, meshes[tiles])
        out[name] = np.concatenate([H.reshape(-1).numpy(), g.numpy(), r[None].numpy()])
        out[name + "_count"] = np.asarray(int(c))
    elif part == "tracking":
        obj, ref, cfg = case
        out[name] = sharded_track(obj, ref, cfg, meshes[4]).numpy()
    elif part == "mapping":
        d, s, a, st = sharded_depth_update(*case, meshes[4])
        out[name + "_maps"] = np.stack([d.numpy(), s.numpy(), a.numpy().astype(np.float32)])
        out[name + "_stats"] = np.asarray([int(st.observed), int(st.accepted),
                                           int(st.rejected), int(st.aged_out)])
    else:
        window, cfg = case
        res = bundle_adjust_sharded(window, cfg, meshes[2], axis="kf")
        for k in ("xi", "depth", "costs", "counts"):
            out[f"{name}_{k}"] = getattr(res, k).numpy()
np.savez(os.path.join(folder, f"out{os.environ['RANK']}.npz"), **out)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _four_ranks(folder: Path, part: str, cases: dict) -> list:
    """``cases`` through the port's sharded ``part`` in a gloo group of four
    processes; each rank's outputs."""
    with open(folder / "in.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(RANKS), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(folder), part], cwd=REPO,
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(RANKS)]
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{part}: rank {r} did not finish in {JOIN_S} s")
        if p.returncode != 0:
            errors.append(f"rank {r}: {err[-3000:]}")
    assert not errors, "\n".join(errors)
    ranks = [dict(np.load(folder / f"out{r}.npz")) for r in range(RANKS)]
    for r, got in enumerate(ranks[1:], 1):
        assert got.keys() == ranks[0].keys()
        for k in got:
            np.testing.assert_array_equal(got[k], ranks[0][k], err_msg=f"rank {r}: {k}")
    return ranks


def _port(frame):
    return frame_from_reference(jax.tree.map(np.asarray, frame), "cpu")


# ------------------------------------------------------------------ tracking

CROP = JTrackerConfig(crop_level=1, crop_x=(8, 86), crop_y=(5, 57))
GN_CASES = {f"gn_t{t}_{c}": (t, cfg) for t in (2, 4)
            for c, cfg in (("default", JTrackerConfig()), ("crop", CROP))}
TRACK_CASES = {"track_64x96": (64, 96), "track_60x80": (60, 80)}


@pytest.fixture(scope="module")
def tracking(tmp_path_factory):
    """GN at T = 2 (the (kf 2, tile 2) mesh's tile axis) and T = 4 on the
    finer level of 64x96 frames, with and without the crop there; the track
    on 64x96 frames (both levels sharded) and on 60x80 (the 30-row level
    runs replicated: 30 % 4 != 0)."""
    rng = np.random.default_rng(0)
    obj, ref, _ = _frames(rng, 64, 96, levels=2)
    cases, jax_out = {}, {}
    for name, (t, cfg) in GN_CASES.items():
        cases[name] = (_port(obj), _port(ref), torch.from_numpy(XI), 1,
                       config_from_reference(cfg), t)
        mesh = j_make_mesh((t,), ("tile",))
        jax_out[name] = jax.jit(lambda o, r, x, cfg=cfg, mesh=mesh: j_sharded_gn(
            o, r, x, 1, cfg, mesh))(obj.scenes[1], ref.scenes[1], jnp.asarray(XI))
    cfg = JTrackerConfig(min_residual=0.0)
    truth = {}
    for name, (h, w) in TRACK_CASES.items():
        o, r, truth[name] = _frames(rng, h, w, levels=2)
        cases[name] = (_port(o), _port(r), config_from_reference(cfg))
        mesh = j_make_mesh((4,), ("tile",))
        jax_out[name] = jax.jit(lambda a, b: j_sharded_track(a, b, cfg, mesh))(o, r)
    ranks = _four_ranks(tmp_path_factory.mktemp("tracking"), "tracking", cases)
    return dict(got=ranks[0], cases=cases, jax=jax_out, truth=truth)


@pytest.mark.parametrize("name", list(GN_CASES))
def test_sharded_gn_normal_equations_matches(tracking, name):
    """The 44 sums of the four ranks' blocks against ``dvo_tpu``'s sharded
    linearisation and against the port's single-device ``gn_terms``."""
    obj, ref, xi, level, cfg, _ = tracking["cases"][name]
    got = tracking["got"][name]
    count = int(tracking["got"][name + "_count"])
    single = ttracker.gn_terms(*ttracker.level_planes(obj.scenes[level], ref.scenes[level]),
                               ref.scenes[level].K, xi, level, cfg)
    jH, jg, jr, jc = (np.asarray(v) for v in tracking["jax"][name])
    for want, want_count in ((np.concatenate([jH.ravel(), jg, [jr]]), int(jc)),
                             (np.concatenate([v.reshape(-1).numpy() for v in single[:3]]),
                              int(single[3]))):
        assert count == want_count > 500
        np.testing.assert_allclose(got[:42], want[:42], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got[42], want[42], rtol=1e-5)


@pytest.mark.parametrize("name", list(TRACK_CASES))
def test_sharded_track_matches(tracking, name):
    obj, ref, cfg = tracking["cases"][name]
    got = tracking["got"][name]
    np.testing.assert_allclose(got, np.asarray(tracking["jax"][name]), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got, ttracker.track(obj, ref, cfg).xi.numpy(), rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got, tracking["truth"][name], atol=1e-3)


# ------------------------------------------------------------------- mapping

H_MAP, W_MAP, TILES = 64, 80, 4
MAP_CFG = JMapperConfig(crop_x=(6, 74), crop_y=(6, 58), luminance_sigma=0.25,
                        epipolar_sigma=0.25)


def _mapping_inputs(rng):
    """``test_parallel.py``'s sharded depth update: one keyframe 10 cm off,
    a smooth prior, every pixel age 0.  Returns (the object frame, xi,
    prior, sigma, the ring)."""
    h, w = H_MAP, W_MAP
    ref_img, true_depth, K, xi, obj_img, obj_mask, mk = _single_kf_setup(rng, h, w)
    ref_frame = mk(ref_img, np.ones((h, w), bool), true_depth,
                   np.full((h, w), 0.5, np.float32), 0)
    history = push(KeyframeHistory.create(4, h, w), ref_frame)
    prior = (1.6 + 0.2 * smooth_image(rng, h, w)).astype(np.float32)
    sigma0 = np.full((h, w), 0.4, np.float32)
    return mk(obj_img, obj_mask, true_depth, sigma0, 1), xi, prior, sigma0, history


def _tile_resets(key, cfg):
    """The reset plane ``dvo_tpu``'s sharded update draws: tile t's rows
    from ``fold_in(key, t)`` (``ops/depth_filter.py:75``)."""
    lo, hi = cfg.depth_filter.reset_depth_range
    bh = H_MAP // TILES
    return np.concatenate([np.minimum(np.asarray(jax.random.uniform(
        jax.random.fold_in(key, t), (bh, W_MAP), minval=lo, maxval=hi)),
        cfg.depth_filter.reset_depth_cap) for t in range(TILES)])


def _port_update_args(obj_frame, xi, prior, sigma0, age0, history, reset, cfg):
    t = torch.from_numpy
    return (_port(obj_frame).scenes[0], t(xi), t(xi), t(prior), t(sigma0), t(age0),
            _port_history(history), t(reset), config_from_reference(cfg))


@pytest.fixture(scope="module")
def mapping(tmp_path_factory):
    rng = np.random.default_rng(0)
    obj_frame, xi, prior, sigma0, history = _mapping_inputs(rng)
    key = jax.random.PRNGKey(3)
    age0 = np.zeros((H_MAP, W_MAP), np.int32)
    mesh = j_make_mesh((TILES,), ("tile",))
    want = jax.jit(lambda o, d, s, a, hist, k: j_sharded_depth_update(
        o, jnp.asarray(xi), jnp.asarray(xi), d, s, a, hist, k, MAP_CFG, mesh))(
        obj_frame.scenes[0], jnp.asarray(prior), jnp.asarray(sigma0), jnp.asarray(age0),
        history, key)
    args = _port_update_args(obj_frame, xi, prior, sigma0, age0, history,
                             _tile_resets(key, MAP_CFG), MAP_CFG)
    ranks = _four_ranks(tmp_path_factory.mktemp("mapping"), "mapping", {"update": args})
    return dict(got=ranks[0], args=args, jax=want)


def _stats(st):
    return [int(getattr(st, k)) for k in ("observed", "accepted", "rejected", "aged_out")]


def test_sharded_depth_update_equals_the_single_device_update(mapping):
    """The four ranks' row blocks, gathered, equal the port's single-device
    update on the same reset plane bit for bit, and so do the counts."""
    got = mapping["got"]
    d, s, a, st = tmapper.depth_update(*mapping["args"])
    np.testing.assert_array_equal(got["update_maps"][0], d.numpy())
    np.testing.assert_array_equal(got["update_maps"][1], s.numpy())
    np.testing.assert_array_equal(got["update_maps"][2], a.numpy())
    assert got["update_stats"].tolist() == _stats(st)
    assert _stats(st)[0] > 200 and _stats(st)[2] > 0, _stats(st)   # resets happen


def test_sharded_depth_update_matches_dvo_tpu(mapping):
    """Against ``dvo_tpu``'s sharded update fed the reset blocks its tiles
    draw: the counts exact, the maps within 1e-5 and the ages equal."""
    got = mapping["got"]
    jd, js, ja, jst = mapping["jax"]
    assert got["update_stats"].tolist() == _stats(jst)
    np.testing.assert_allclose(got["update_maps"][0], np.asarray(jd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["update_maps"][1], np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["update_maps"][2], np.asarray(ja))


# ------------------------------------------------------------------------ BA

BA_CFG = JBAConfig(iterations=2)
BA_CASES = {"window3": 3, "window4": 4}   # 3 on kf = 2: one inert dummy keyframe


@pytest.fixture(scope="module")
def ba(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases, jax_out = {}, {}
    mesh = j_make_mesh((2,), ("kf",))
    for name, m in BA_CASES.items():
        window, _ = _make_window(rng, m=m, h=32, w=48, pose_noise=0.003)
        cases[name] = (tba.window_from_reference(jax.tree.map(np.asarray, window), "cpu"),
                       config_from_reference(BA_CFG))
        jax_out[name] = jax.jit(lambda w: j_bundle_adjust_sharded(w, BA_CFG, mesh))(window)
    ranks = _four_ranks(tmp_path_factory.mktemp("ba"), "ba", cases)
    return dict(got=ranks[0], cases=cases, jax=jax_out)


@pytest.mark.parametrize("name", list(BA_CASES))
def test_bundle_adjust_sharded_matches(ba, name):
    """Against ``dvo_tpu``'s sharded BA and the port's single-device BA at
    ``test_ba.py:183-187``'s tolerances; the padding is sliced off."""
    window, cfg = ba["cases"][name]
    got = {k: ba["got"][f"{name}_{k}"] for k in ("xi", "depth", "costs", "counts")}
    m = BA_CASES[name]
    assert got["xi"].shape == (m, 6) and got["depth"].shape == (m, 32, 48)
    single = tba.bundle_adjust(window, cfg)
    for want in (ba["jax"][name], single):
        costs = np.asarray(want.costs)
        np.testing.assert_allclose(got["costs"][0], costs[0], rtol=1e-5)
        np.testing.assert_allclose(got["costs"], costs, rtol=5e-3)
        np.testing.assert_allclose(got["xi"], np.asarray(want.xi), atol=1e-3)
        ddiff = np.abs(got["depth"] - np.asarray(want.depth))
        assert np.quantile(ddiff, 0.95) < 0.05, np.quantile(ddiff, 0.95)
    np.testing.assert_array_equal(got["counts"], single.counts.numpy())


def test_padded_keyframes_are_inert():
    """``_pad_window``: the dummy keyframes' masks are all False, the rest
    repeats the last keyframe (``dvo_tpu``'s rule)."""
    from dvo_tpu_torch.parallel.ba import _pad_window

    window, _ = _make_window(np.random.default_rng(1), m=3, h=16, w=24)
    tw = tba.window_from_reference(jax.tree.map(np.asarray, window), "cpu")
    padded = _pad_window(tw, 2)
    assert padded.size == 5 and not padded.mask[3:].any() and not padded.gmask[3:].any()
    for k in ("gray", "gx", "gy", "depth", "sigma", "xi"):
        assert torch.equal(getattr(padded, k)[:3], getattr(tw, k))
        assert torch.equal(getattr(padded, k)[4], getattr(tw, k)[2])


# ------------------------------------------- the row offset of the plain versions

@pytest.mark.parametrize("tiles", [2, 4])
@pytest.mark.parametrize("crop", [False, True])
def test_plain_gn_terms_with_an_offset_match_dvo_tpu(tiles, crop):
    """``gn_terms`` (the plain version) on each row block with its offset
    against ``dvo_tpu``'s ``gn_terms`` with ``y_offset``/``full_shape``, at a
    motion that carries pixels across the blocks' boundaries, with
    ``test_torch_tracker.py``'s twin-vs-twin tolerance (the count exact, the
    sums within 1e-4 of each term's largest entry: the two einsums sum in
    different orders); the blocks' sums add up to the whole image's."""
    obj, ref, _ = _frames(np.random.default_rng(0), 64, 96, levels=2)
    cfg = CROP if crop else JTrackerConfig()
    jo, jr = obj.scenes[1], ref.scenes[1]
    to, tr = _port(obj).scenes[1], _port(ref).scenes[1]
    tcfg = config_from_reference(cfg)
    bh = 64 // tiles
    planes = ttracker.level_planes(to, tr)
    total = [0.0, 0.0, 0.0, 0]
    for t in range(tiles):
        rows = slice(t * bh, (t + 1) * bh)
        j = jtracker.gn_terms(jo.gray[rows], jo.mask[rows], jr.depth[rows], jr.sigma[rows],
                              jr.gray, jr.mask, jr.gx, jr.gy, jr.gmask, jr.K, jnp.asarray(XI),
                              1, cfg, y_offset=t * bh, full_shape=(64, 96))
        got = ttracker.gn_terms(*(p[rows] for p in planes[:4]), *planes[4:], tr.K,
                                torch.from_numpy(XI), 1, tcfg, y_offset=t * bh,
                                full_shape=(64, 96))
        _assert_terms_close(got, j)
        total = [x + y for x, y in zip(total, got)]
    # The blocks' sums in another order than the whole image's: within 1e-4
    # of each term's largest entry (test_torch_tracker.py's tolerance).
    whole = ttracker.gn_terms(*planes, tr.K, torch.from_numpy(XI), 1, tcfg)
    assert int(total[3]) == int(whole[3]) > 500
    for a, b in zip(total[:3], whole[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * b.abs().max().item())


def test_plain_depth_update_with_an_offset_matches_dvo_tpu():
    """``epipolar_fields`` + ``epipolar_update_plain`` (``depth_update``'s
    CPU route) on each row block with its offset against ``dvo_tpu``'s
    ``depth_update`` with ``y_offset``/``full_shape`` fed the same reset
    block; the blocks equal the port's whole-image update's rows bitwise."""
    obj_frame, xi, prior, sigma0, history = _mapping_inputs(np.random.default_rng(0))
    key = jax.random.PRNGKey(3)
    age0 = np.zeros((H_MAP, W_MAP), np.int32)
    reset = _tile_resets(key, MAP_CFG)
    args = _port_update_args(obj_frame, xi, prior, sigma0, age0, history, reset, MAP_CFG)
    whole = tmapper.depth_update(*args)
    bh = H_MAP // TILES
    counts = np.zeros(4, int)
    for t in range(TILES):
        rows = slice(t * bh, (t + 1) * bh)
        j = jmapper.depth_update(obj_frame.scenes[0], jnp.asarray(xi), jnp.asarray(xi),
                                 jnp.asarray(prior[rows]), jnp.asarray(sigma0[rows]),
                                 jnp.asarray(age0[rows]), history, jax.random.fold_in(key, t),
                                 MAP_CFG, y_offset=t * bh, full_shape=(H_MAP, W_MAP))
        got = tmapper.depth_update(*args[:3], *(a[rows] for a in args[3:6]), args[6],
                                   args[7][rows], args[8], y_offset=t * bh,
                                   full_shape=(H_MAP, W_MAP))
        assert _stats(got[3]) == _stats(j[3])
        for g, w, b in zip(got[:3], j[:3], whole[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
            assert torch.equal(g, b[rows])
        counts += _stats(got[3])
    assert counts.tolist() == _stats(whole[3]) and counts[0] > 200


# ------------------------------- the epipolar kernel's transcription, with an offset

@pytest.mark.parametrize("tiles", [2, 3])
@pytest.mark.parametrize("entry", ["fused", "fields"])
def test_transcribed_kernel_on_row_blocks_equals_the_whole_image(tiles, entry, rng,
                                                                  monkeypatch):
    """Both C entries' argument lists on row blocks (the block's rows, its
    offset, the full image's shape), through the NumPy transcription of
    ``epipolar_pixel.cuh``: each block equals the plain whole-image update's
    rows bit for bit, and the blocks' counts add up to the whole's."""
    h, w = 24, 32
    args = transcription._state(rng, h, w, 4, 3, 5)
    cfg = transcription.CFG
    if entry == "fused":
        want = tmapper.depth_update_by_fields(*args, cfg)
        want = (*want[:3], _stats(want[3]))
    else:
        fields, _ = tmapper.epipolar_fields(*args, cfg)
        hist = args[6]
        ring = (hist.gray, hist.gx, hist.gy, hist.gmask)
        want = epipolar.epipolar_update_plain(fields, *ring, cfg)
        want = (*want[:3], want[3].tolist() + [0])
    monkeypatch.setattr(epipolar, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(tmapper, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", lambda: transcription.EmulatedLibrary(8))
    monkeypatch.setattr(_build, "stream_handle", lambda _: 0)
    _build.reset_launches()
    bh = h // tiles
    counts = np.zeros(4, int)
    for t in range(tiles):
        rows = slice(t * bh, (t + 1) * bh)
        if entry == "fused":
            got = tmapper.depth_update(*args[:3], *(a[rows] for a in args[3:6]), args[6],
                                       args[7][rows], cfg, y_offset=t * bh, full_shape=(h, w))
            got = (*got[:3], _stats(got[3]))
        else:
            got = epipolar.epipolar_update(fields[:, rows].contiguous(), *ring, cfg,
                                           full_shape=(h, w))
            got = (*got[:3], got[3].tolist() + [0])
        for g, wnt in zip(got[:3], want[:3]):
            assert g.dtype == wnt.dtype and torch.equal(g, wnt[rows])
        counts += got[3]
    assert counts.tolist() == list(want[3]) and counts[0] > 20
    assert _build.LAUNCHES["epipolar"] == tiles
    _build.reset_launches()


@pytest.mark.parametrize("call,match", [
    (lambda a, f, ring, cfg: tmapper.depth_update(*a[:3], *(x[4:] for x in a[3:6]), a[6],
                                                  a[7][4:], cfg, y_offset=5, full_shape=(24, 32)),
     "row block at row 5 does not lie"),
    (lambda a, f, ring, cfg: tmapper.depth_update(*a[:3], *(x[:8] for x in a[3:6]), a[6],
                                                  a[7][:8], cfg, y_offset=0, full_shape=(24, 33)),
     r"a \(24, 33\) image"),
    (lambda a, f, ring, cfg: epipolar.epipolar_update(f[:, :8].contiguous(), *ring, cfg,
                                                      full_shape=(8, 32)),
     "born_gray: shape"),
    (lambda a, f, ring, cfg: gn.gn_terms(*(torch.zeros(4, 32) for _ in range(4)),
                                         *(torch.zeros(24, 32) for _ in range(5)),
                                         torch.eye(3), torch.eye(4), 0,
                                         ttracker.TrackerConfig(), y_offset=21,
                                         full_shape=(24, 32)),
     "row block at row 21"),
])
def test_kernel_wrappers_refuse_a_block_outside_the_image(call, match, rng, monkeypatch):
    """On the launch route the block and the full shape are checked before
    the library is touched."""
    def no_library():
        raise AssertionError("reached the library with a bad block")

    args = transcription._state(rng, 24, 32, 4, 3, 5)
    fields, _ = tmapper.epipolar_fields(*args, transcription.CFG)
    hist = args[6]
    for mod in (epipolar, tmapper, gn):
        monkeypatch.setattr(mod, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", no_library)
    with pytest.raises(ValueError, match=match):
        call(args, fields, (hist.gray, hist.gx, hist.gy, hist.gmask), transcription.CFG)
