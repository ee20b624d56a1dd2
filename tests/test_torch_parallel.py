"""``dvo_tpu_torch.parallel`` (meshes, bring-up and the stream-sharded
drivers on ``torch.distributed``) against ``dvo_tpu.parallel``, mirroring
``tests/test_parallel.py``: ``test_vo_mesh_shapes``,
``test_pod_mesh_and_initialize``, ``test_stream_sharded_matches_batched`` and
``test_rgbd_stream_sharded_matches_single``.

The stream drivers run in one gloo group of four processes here (each
joined with a timeout, so a hang fails instead of eating the suite's
limit), on the fixtures of ``test_parallel.py``, against ``dvo_tpu``'s on
the 4-device virtual mesh.  Tolerances: every rank holds the same gathered
results, equal bitwise to the port's batched driver on the same streams;
against ``dvo_tpu``'s stream-sharded run world poses within 1e-4: its
width-1 vmapped program is not its single-stream one, and
``test_parallel.py`` bounds their gap by 1e-4 (RGB-D) and 1e-3 (mono);
measured here 1.6e-5."""

import dataclasses as dc
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dvo_tpu.config import DVOConfig
from dvo_tpu.models.odometry import monocular_init_with_depth, rgbd_init
from dvo_tpu.ops.warp import warp_image
from dvo_tpu.parallel import distributed as jdist
from dvo_tpu.parallel import mesh as jmesh
from dvo_tpu.parallel.streams import monocular_run_streams, rgbd_run_streams, stream_mesh
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.models import odometry as todo
from dvo_tpu_torch.models.graphed import leaves
from dvo_tpu_torch.parallel import distributed as tdist
from dvo_tpu_torch.parallel import mesh as tmesh
from dvo_tpu_torch.parallel import streams as tstreams

from test_image_ops import smooth_image

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
RANKS, B, N, H, W = 4, 4, 3, 48, 64
JOIN_S = 120


@pytest.mark.parametrize("n", range(1, 17))
def test_vo_mesh_shapes_match_dvo_tpu(n, monkeypatch):
    """The (kf, tile) factoring of n devices, for n beyond the virtual
    mesh's 8 too: dvo_tpu's ``vo_mesh`` with its mesh constructor replaced by
    one that reports the shape."""
    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, names, devices: dict(zip(names, shape)))
    assert dict(zip(("kf", "tile"), tmesh.vo_mesh_shape(n))) == jmesh.vo_mesh(n)


@pytest.mark.parametrize("n,kf,tile,local", [
    (8, None, None, None), (8, 2, 4, None), (8, 4, None, None), (8, None, 2, None),
    (16, None, None, 8), (16, 4, None, 8), (4, None, None, 2), (1, None, None, None),
    (12, None, None, 4), (6, 3, None, None),
])
def test_pod_mesh_shapes_match_dvo_tpu(n, kf, tile, local, monkeypatch):
    """``pod_mesh``'s layout rule: dvo_tpu's ``pod_mesh`` over n stand-in
    devices (``local`` devices per host when multi-process)."""
    monkeypatch.setattr(jdist, "Mesh", lambda arr, names: dict(zip(names, arr.shape)))
    if local is not None:
        monkeypatch.setattr(jax, "process_count", lambda: n // local)
        monkeypatch.setattr(jax, "local_device_count", lambda: local)
    want = jdist.pod_mesh(kf, tile, devices=list(range(n)))
    assert dict(zip(("kf", "tile"), tdist.pod_mesh_shape(n, kf, tile, local))) == want


def test_pod_mesh_refuses_a_layout_that_does_not_cover():
    with pytest.raises(ValueError, match="does not cover"):
        tdist.pod_mesh_shape(8, 3, None)


def test_initialize_and_meshes_in_one_process():
    """One process: ``initialize`` joins nothing; a mesh makes a one-rank
    gloo group of its own, and every mesh has dvo_tpu's axis names."""
    assert not dist.is_initialized()
    tdist.initialize(device="cpu")
    assert not dist.is_initialized()
    try:
        m = tstreams.stream_mesh(device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert m.mesh_dim_names == ("stream",) and m.size() == 1
        vo = tmesh.vo_mesh(device="cpu")
        assert dict(zip(vo.mesh_dim_names, vo.shape)) == {"kf": 1, "tile": 1}
        assert tdist.pod_mesh(device="cpu").mesh_dim_names == ("kf", "tile")
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            tmesh.make_mesh((2,), ("stream",), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("call", [
    lambda: tmesh.make_mesh((1,), ("tile",)), lambda: tmesh.vo_mesh(),
    lambda: tstreams.stream_mesh(), lambda: tdist.pod_mesh(), lambda: tdist.initialize(),
    lambda: tdist.initialize(num_processes=2, process_id=0),
    lambda: tmesh.ensure_group(),
], ids=["make_mesh", "vo_mesh", "stream_mesh", "pod_mesh", "initialize",
        "initialize_two_processes", "ensure_group"])
def test_parallel_entry_points_need_a_card_unless_asked_for_the_cpu(call, monkeypatch):
    """Without a card every mesh and ``initialize`` raise with the reason
    unless ``device="cpu"`` is given: nothing falls back to gloo on the CPU
    by itself, and no group is joined."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        call()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="expected 'cuda' or 'cpu'"):
        tmesh.make_mesh((1,), ("tile",), device="gpu")


class _Mesh:
    def __init__(self, size):
        self._size = size

    def size(self):
        return self._size


def test_streams_refuse_a_batch_the_mesh_does_not_divide():
    """Three streams on two devices: dvo_tpu's shard_map refuses, and so
    does the port, in dvo_tpu's words."""
    phrase = "not evenly divisible by the corresponding mesh axis sizes"
    cfg = dc.replace(DVOConfig.rgbd(), pyramid=dc.replace(DVOConfig.rgbd().pyramid, levels=2,
                                                          culls=0))
    K = jnp.asarray(np.array([[20, 0, 8], [0, 20, 8], [0, 0, 1]], np.float32))
    st = rgbd_init(jnp.ones((16, 16)), jnp.ones((16, 16), bool), jnp.ones((16, 16)),
                   jnp.ones((16, 16)), K, cfg)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[st] * 3)
    x = jnp.ones((3, 1, 16, 16))
    with pytest.raises(ValueError, match=phrase):
        rgbd_run_streams(stream_mesh(2), stacked, x, x.astype(bool), x, x, K, cfg)
    with pytest.raises(ValueError, match=f"{phrase}.*2.*does not evenly divide 3"):
        tstreams._rows(_Mesh(2), 3)


# ---------------------------------------------------------------- four ranks

WORKER = r"""
import os, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from dvo_tpu_torch.models import odometry as o
from dvo_tpu_torch.models.graphed import leaves
from dvo_tpu_torch.parallel import initialize, monocular_run_streams, rgbd_run_streams, stream_mesh

folder = sys.argv[1]
initialize(device="cpu")
mesh = stream_mesh(device="cpu")
with open(os.path.join(folder, "cfg.pkl"), "rb") as f:
    cfg_m, cfg_r = pickle.load(f)
d = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(folder, "in.npz")).items()}
b = d["seq"].shape[0]
sigma0 = torch.full(d["base"].shape[1:], 0.1)
gens = o.stream_generators("cpu", b)
states = o.stack_states([o.monocular_init_with_depth(
    d["base"][s], d["masks"][s, 0], d["depth"][s], sigma0, d["K"], cfg_m, device="cpu",
    generator=gens[s]) for s in range(b)])
st_m, res_m = monocular_run_streams(mesh, states, d["seq"], d["masks"], d["K"], cfg_m)
states_r = o.stack_states([o.rgbd_init(d["base"][s], d["masks"][s, 0], d["depth"][s],
                                       d["sig"][s, 0], d["K"], cfg_r, device="cpu")
                           for s in range(b)])
st_r, res_r = rgbd_run_streams(mesh, states_r, d["seq"], d["masks"], d["depths"], d["sig"],
                               d["K"], cfg_r)
out = {}
for name, tree in (("st_m", st_m), ("res_m", res_m), ("st_r", st_r), ("res_r", res_r)):
    for i, t in enumerate(leaves(tree)):
        out[f"{name}_{i}"] = t.numpy()
for s, g in enumerate(st_m.generator):
    out[f"gen_{s}"] = g.get_state().numpy()
np.savez(os.path.join(folder, f"out{os.environ['RANK']}.npz"), **out)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fixtures(rng):
    """test_parallel.py's streams: one image at per-stream depth scales and
    speeds, n frames each."""
    K = np.array([[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]], np.float32)
    img = smooth_image(rng, H, W)
    base = np.stack([img] * B).astype(np.float32)
    scale = [1.2 ** s for s in range(B)]
    depth = np.stack([np.full((H, W), 1.8 * scale[s], np.float32) for s in range(B)])
    xis = [np.asarray([0.008 * scale[s], 0.004 * scale[s], 0, 0, 0, 0], np.float32)
           for s in range(B)]
    seq = np.stack([np.stack([
        np.asarray(warp_image(jnp.asarray(xis[s] * (k + 1)), jnp.asarray(base[s]),
                              jnp.ones((H, W), bool), jnp.asarray(depth[s]), jnp.asarray(K))[0])
        for k in range(N)]) for s in range(B)]).astype(np.float32)
    return dict(K=K, base=base, depth=depth, seq=seq, masks=np.ones((B, N, H, W), bool),
                depths=np.stack([np.stack([depth[s]] * N) for s in range(B)]),
                sig=np.full((B, N, H, W), 0.1, np.float32))


def _configs():
    """test_parallel.py's: a fixed-length GN loop and a promotion on every
    frame (the deterministic data path); the pyramid and the mapper's crop
    fitted to these 48x64 frames (DVOConfig.monocular()'s two culls leave a
    3x4 coarsest level, where the twins' border handling, not the motion,
    sets the pose)."""
    mono = DVOConfig.monocular()
    mono = dc.replace(mono, pyramid=dc.replace(mono.pyramid, levels=2, culls=0),
                      tracker=dc.replace(mono.tracker, early_exit=False),
                      mapper=dc.replace(mono.mapper, max_forward=1, min_movement=0.0,
                                        crop_x=(6, W - 8), crop_y=(5, H - 6)))
    rgbd = DVOConfig.rgbd()
    rgbd = dc.replace(rgbd, pyramid=dc.replace(rgbd.pyramid, levels=2, culls=0),
                      tracker=dc.replace(rgbd.tracker, early_exit=False))
    return mono, rgbd


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The port's stream drivers in a gloo group of four processes; and, in
    this process, the port's batched drivers and dvo_tpu's stream drivers on
    the 4-device virtual mesh, on the same streams."""
    folder = tmp_path_factory.mktemp("ranks")
    d = _fixtures(np.random.default_rng(0))
    cfg_m, cfg_r = _configs()
    tcfg = (config_from_reference(cfg_m), config_from_reference(cfg_r))
    np.savez(folder / "in.npz", **d)
    with open(folder / "cfg.pkl", "wb") as f:
        pickle.dump(tcfg, f)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(RANKS), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(folder)], cwd=REPO,
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(RANKS)]
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} did not finish in {JOIN_S} s")
        if p.returncode != 0:
            errors.append(f"rank {r}: {err[-3000:]}")
    assert not errors, "\n".join(errors)
    ranks = [dict(np.load(folder / f"out{r}.npz")) for r in range(RANKS)]

    # the port's batched drivers on the same streams, in this process
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    gens = todo.stream_generators("cpu", B)
    sigma0 = torch.full((H, W), 0.1)
    states = todo.stack_states([todo.monocular_init_with_depth(
        t["base"][s], t["masks"][s, 0], t["depth"][s], sigma0, t["K"], tcfg[0], device="cpu",
        generator=gens[s]) for s in range(B)])
    batched_m = todo.monocular_run_batched(states, t["seq"], t["masks"], t["K"], tcfg[0])
    states_r = todo.stack_states([todo.rgbd_init(t["base"][s], t["masks"][s, 0], t["depth"][s],
                                                 t["sig"][s, 0], t["K"], tcfg[1], device="cpu")
                                  for s in range(B)])
    batched_r = todo.rgbd_run_batched(states_r, t["seq"], t["masks"], t["depths"], t["sig"],
                                      t["K"], tcfg[1])

    # dvo_tpu's stream drivers on its 4-device virtual mesh
    K = jnp.asarray(d["K"])
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    masks = jnp.asarray(d["masks"])
    jstates = jax.vmap(lambda g, m, dd, k: monocular_init_with_depth(
        g, m, dd, jnp.full((H, W), 0.1, jnp.float32), K, k, cfg_m))(
        jnp.asarray(d["base"]), masks[:, 0], jnp.asarray(d["depth"]), keys)
    _, jres_m = monocular_run_streams(stream_mesh(4), jstates, jnp.asarray(d["seq"]), masks, K,
                                      cfg_m)
    jst_r = [rgbd_init(jnp.asarray(d["base"][s]), masks[s, 0], jnp.asarray(d["depth"][s]),
                       jnp.asarray(d["sig"][s, 0]), K, cfg_r) for s in range(B)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jst_r)
    _, jres_r = rgbd_run_streams(stream_mesh(4), stacked, jnp.asarray(d["seq"]), masks,
                                 jnp.asarray(d["depths"]), jnp.asarray(d["sig"]), K, cfg_r)
    return dict(ranks=ranks, batched={"m": batched_m, "r": batched_r},
                gens=[g.get_state().numpy() for g in batched_m[0].generator],
                jres={"m": jres_m, "r": jres_r})


@pytest.mark.parametrize("path", ["m", "r"])
def test_stream_drivers_on_four_ranks_equal_the_batched_driver(four_ranks, path):
    """Every rank holds all B streams' results and states, equal bitwise to
    the batched driver's: the sharding and the gather change nothing."""
    st, res = four_ranks["batched"][path]
    for r, got in enumerate(four_ranks["ranks"]):
        for name, tree in ((f"st_{path}", st), (f"res_{path}", res)):
            want = leaves(tree)
            assert sum(k.startswith(name + "_") for k in got) == len(want)
            for i, t in enumerate(want):
                np.testing.assert_array_equal(got[f"{name}_{i}"], t.numpy(), err_msg=f"rank {r}")
        if path == "m":
            for s, g in enumerate(four_ranks["gens"]):
                np.testing.assert_array_equal(got[f"gen_{s}"], g)


@pytest.mark.parametrize("path", ["m", "r"])
def test_stream_drivers_on_four_ranks_match_dvo_tpu(four_ranks, path):
    """The gathered world poses against dvo_tpu's stream-sharded run on its
    4-device mesh; streams stay apart (no stream is closer to another's
    trajectory than to its own)."""
    res = four_ranks["batched"][path][1]
    want = np.asarray(four_ranks["jres"][path].T_world)
    got = four_ranks["ranks"][0][f"res_{path}_0"]
    np.testing.assert_array_equal(got, res.T_world.numpy())
    assert got.shape == (B, N, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for s in range(B):
        same = np.abs(got[s] - want[s]).max()
        cross = min(np.abs(got[s] - want[t]).max() for t in range(B) if t != s)
        assert cross > 10 * max(same, 1e-4), (s, same, cross)
