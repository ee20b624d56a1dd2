"""The port's monocular runner with the back end on (``--ba``,
``--pose-graph``, ``--pose-graph-every``) against ``dvo_tpu.utils.runner``
on the same PNG sequence, and its chunked path against its per-frame one.

The rig is test_torch_runner's monocular one, 22 frames long with a keyframe
every second frame (``max_forward=2``): ten nodes, so that BA windows fill,
closure candidates exist and live refinements fire.  ``dvo_tpu`` runs per
frame (its chunked scan with BA compiles for minutes); both packages get the
same bootstrap noise and reset planes (``Planes``).

Tolerances.  With BA on, twin-vs-twin float noise goes through BA's damped
solves on depths that grew from the noise bootstrap, and every promotion
about doubles it (measured: 1e-5 at the first BA, 9e-5 at frame 11, 2.1e-3
at frame 21; a plumbing fault would show as 1e-2 or more at the first BA).
So the first twelve poses are held within 3e-4 and all within 1e-2 (half of
the 2e-2 that ``tests/test_runner.py`` gives ``dvo_tpu``'s chunked runner
with BA against its per-frame one), ``ba_cost`` within 5%.  With the pose
graph, the refined trajectory within 1e-2 as well; the port's chunked path
against its own per-frame path within 5e-3, the tolerance
``tests/test_runner.py`` uses for the same pair; node, edge and closure
counts equal."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from dvo_tpu.models import posegraph as jpg
from dvo_tpu.utils import runner as jrun
from dvo_tpu.utils.metrics import MetricsLogger as JMetrics
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.models import posegraph as tpg
from dvo_tpu_torch.utils import oracle as nplie
from dvo_tpu_torch.utils import runner as trun
from dvo_tpu_torch.utils.metrics import MetricsLogger

from test_torch_runner import H, MONO_CFG, W, Planes, _seq, jax_planes, write_mono

torch.set_num_threads(1)

N = 22                      # 21 steps = five 4-chunks + a 1-frame tail
CHUNK = 4
BA_CFG = dataclasses.replace(
    MONO_CFG, mapper=dataclasses.replace(MONO_CFG.mapper, max_forward=2),
    ba=dataclasses.replace(MONO_CFG.ba, enabled=True, window=3, iterations=2))
BA_TCFG = config_from_reference(BA_CFG)
BA_POSE_TOL = 1e-2
BA_EARLY_TOL = 3e-4          # the first twelve poses
PG_POSE_TOL = 5e-3           # the port's chunked path against its per-frame path


def _capture(monkeypatch, module, created):
    orig = module.PoseGraphHarvester

    class Capture(orig):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            created.append(self)

    monkeypatch.setattr(module, "PoseGraphHarvester", Capture)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("backend") / "mono")
    return root, write_mono(root, n=N)


@pytest.fixture(scope="module")
def reference(sequence):
    """``dvo_tpu``'s per-frame runs: BA only; BA + pose graph; BA + pose
    graph refined every 2 promotions; and the last one on its chunked path
    too, where a live refinement reaches the state two chunks late.  Each
    with its metrics records and, for the pose graph, its harvester."""
    path, calib = sequence
    out = {}
    for name, kw in [("ba", {}), ("pg", dict(pose_graph=True)),
                     ("live", dict(pose_graph=True, pose_graph_every=2)),
                     ("live_chunked", dict(pose_graph=True, pose_graph_every=2, chunk=CHUNK))]:
        log = os.path.join(os.path.dirname(path), f"jax_{name}.jsonl")
        metrics, created = JMetrics(log), []
        with pytest.MonkeyPatch.context() as mp:
            _capture(mp, jpg, created)
            ts, poses, _ = jrun.run_monocular(_seq(path), calib, BA_CFG, seed=3, metrics=metrics,
                                              **kw)
        metrics.close()
        with open(log) as f:
            out[name] = (ts, poses, [json.loads(line) for line in f],
                         created[0] if created else None)
    return out


def _port_run(sequence, monkeypatch, chunk, tmp_path=None, **kw):
    path, calib = sequence
    Planes(monkeypatch, *jax_planes(jax.random.PRNGKey(3), N - 1, H >> 1, W >> 1, BA_CFG, True))
    created = []
    _capture(monkeypatch, tpg, created)
    metrics = MetricsLogger(str(tmp_path / "port.jsonl") if tmp_path else None)
    ts, poses, secs = trun.run_monocular(_seq(path), calib, BA_TCFG, seed=3, chunk=chunk,
                                         metrics=metrics, device="cpu", **kw)
    metrics.close()
    records = []
    if tmp_path:
        with open(tmp_path / "port.jsonl") as f:
            records = [json.loads(line) for line in f]
    return ts, poses, records, created[0] if created else None


def _rigid(poses):
    RtR = np.einsum("nij,nik->njk", poses[:, :3, :3], poses[:, :3, :3])
    np.testing.assert_allclose(RtR, np.broadcast_to(np.eye(3), RtR.shape), atol=1e-4)


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["per_frame", "chunked"])
def test_runner_with_ba_matches_dvo_tpu(chunk, sequence, reference, monkeypatch, tmp_path):
    ts_j, poses_j, records_j, _ = reference["ba"]
    ts, poses, records, _ = _port_run(sequence, monkeypatch, chunk, tmp_path)
    np.testing.assert_array_equal(ts, ts_j)
    assert poses.shape == poses_j.shape == (N, 4, 4)
    np.testing.assert_allclose(poses, poses_j, rtol=0, atol=BA_POSE_TOL)
    np.testing.assert_allclose(poses[:12], poses_j[:12], rtol=0, atol=BA_EARLY_TOL)
    assert [r["keyframe"] for r in records] == [r["keyframe"] for r in records_j]
    costs, costs_j = ([r["ba_cost"] for r in rs] for rs in (records, records_j))
    assert [c is None for c in costs] == [c is None for c in costs_j]
    ran = [c for c in costs if c is not None]
    assert len(ran) >= 6 and all(np.isfinite(c) and c >= 0 for c in ran)
    np.testing.assert_allclose(ran, [c for c in costs_j if c is not None], rtol=5e-2)


@pytest.mark.parametrize("every", [0, 2], ids=["final_only", "every_2"])
@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["per_frame", "chunked"])
def test_runner_with_pose_graph_matches_dvo_tpu(chunk, every, sequence, reference, monkeypatch):
    """The harvester end to end on both paths: the same nodes, edges and
    closures as ``dvo_tpu``'s run, and its refined trajectory.  The chunked
    path applies a live refinement two chunks late, so with ``every`` it is
    held against ``dvo_tpu``'s chunked run, else against the per-frame
    one."""
    ts_j, poses_j, _, hj = reference[("live_chunked" if chunk else "live") if every else "pg"]
    ts, poses, _, ht = _port_run(sequence, monkeypatch, chunk, pose_graph=True,
                                 pose_graph_every=every)
    np.testing.assert_array_equal(ts, ts_j)
    assert poses.shape == (N, 4, 4) and np.all(np.isfinite(poses))
    _rigid(poses)
    assert [nd.frame_idx for nd in ht.nodes] == [nd.frame_idx for nd in hj.nodes]
    assert len(ht.nodes) == 10 and all(nd.depth is not None for nd in ht.nodes)
    tracked = lambda h: sorted((i, j, w) for i, j, w in zip(h.e_i, h.e_j, h.e_w)
                               if w != h.W_CLOSURE)
    assert tracked(ht) == tracked(hj)
    # Closures: a candidate whose distance or re-tracked residual sits at its
    # threshold may fall on either side (the poses differ by BA's amplified
    # float noise), so the two sets may differ by one pair.
    assert len(ht._closure_pairs ^ hj._closure_pairs) <= 1 and ht.stale_snaps == 0
    assert ht.closures == len(ht._closure_pairs) == sum(w == ht.W_CLOSURE for w in ht.e_w)
    assert sum(w == ht.W_BA for w in ht.e_w) > 0 and sum(w == ht.W_ODOM for w in ht.e_w) == 9
    if every:
        assert ht.live_refinements >= 1 and hj.live_refinements >= 1
    np.testing.assert_allclose(poses, poses_j, rtol=0, atol=BA_POSE_TOL)


def test_pose_graph_chunked_matches_per_frame(sequence, monkeypatch):
    """Refined at the end only, both paths harvest the same constraints (with
    live refinements they rightly differ: the chunked path applies one two
    chunks after its trigger)."""
    _, poses_a, _, ha = _port_run(sequence, monkeypatch, 0, pose_graph=True)
    monkeypatch.undo()
    _, poses_b, _, hb = _port_run(sequence, monkeypatch, CHUNK, pose_graph=True)
    assert len(ha.nodes) == len(hb.nodes) and len(ha.e_w) == len(hb.e_w)
    np.testing.assert_allclose(poses_a, poses_b, rtol=0, atol=PG_POSE_TOL)


def test_pose_graph_changes_only_what_it_should(sequence, reference, monkeypatch):
    """Without ``pose_graph`` no harvester exists, whatever
    ``pose_graph_every`` says (as in ``dvo_tpu``); with it the emitted poses
    differ from the BA-only run's."""
    _, poses_ba, _, h = _port_run(sequence, monkeypatch, CHUNK, pose_graph_every=2)
    assert h is None
    np.testing.assert_allclose(poses_ba, reference["ba"][1], rtol=0, atol=BA_POSE_TOL)
    monkeypatch.undo()
    _, poses_pg, _, _ = _port_run(sequence, monkeypatch, CHUNK, pose_graph=True)
    assert np.abs(poses_pg - poses_ba).max() > 1e-6


def _injecting(orig, created, nplie_mod):
    """``orig`` (a PoseGraphHarvester class of either package) that injects
    one perturbing closure edge, 3 cm off and of closure weight, when its
    fifth node arrives, and logs every chunked live refinement."""

    class Injecting(orig):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            created.append(self)
            self._injected = False
            self.refine_log = []   # (trigger node index, its refined T_emit)

        def refine_live_chunked(self):
            out = super().refine_live_chunked()
            if out is not None:
                self.refine_log.append((len(self.nodes) - 1, self.nodes[-1].T_emit.copy()))
            return out

        def on_chunk_row(self, frame_idx, row, gray, mask, T_emit=None):
            due = super().on_chunk_row(frame_idx, row, gray, mask, T_emit=T_emit)
            if not self._injected and len(self.nodes) == 5:
                z = nplie_mod.se3_log(np.linalg.inv(self.nodes[0].T_emit)
                                      @ self.nodes[-1].T_emit).astype(np.float32)
                z[0] += 0.03
                self.e_i.append(0)
                self.e_j.append(len(self.nodes) - 1)
                self.e_z.append(z)
                self.e_w.append(self.W_CLOSURE)
                self._injected = True
            return due

    return Injecting


def _snooped(module, monkeypatch, captured):
    orig_apply = module.apply_refinement

    def snoop(times, poses_in, kf_idx, kf_xi):
        captured["poses"] = np.asarray(poses_in).copy()
        captured["kf"] = list(kf_idx)
        return orig_apply(times, poses_in, kf_idx, kf_xi)

    monkeypatch.setattr(module, "apply_refinement", snoop)


def test_chunked_live_refinement_keeps_the_emitted_chain_consistent(sequence, monkeypatch):
    """``tests/test_runner.py``'s chain invariant on the port's chunked
    path, BA off.  One injected closure edge forces corrections large enough
    to see (``_injecting``).  Before the final pass:

      * the keyframe that triggered a live refinement must have been
        re-emitted exactly on its refined pose (what finalize's corr =
        T_final @ inv(poses[kf]) relies on);
      * the emitted chain must agree with the tracked odometry edge between
        consecutive keyframes up to the non-rigid part of the live
        corrections, on every edge that does not end in a trigger keyframe
        (that one joins a row emitted before the correction to one emitted
        after it, and carries the correction itself, in ``dvo_tpu`` too);
      * the whole emitted chain, the harvested edges and the bound equal
        those of ``dvo_tpu``'s chunked runner under the same injection, to
        1e-3 (2.4e-4 measured)."""
    from dvo_tpu.utils import oracle as joracle

    path, calib = sequence
    cfg = dataclasses.replace(BA_CFG, ba=dataclasses.replace(BA_CFG.ba, enabled=False))
    kw = dict(seed=3, chunk=CHUNK, pose_graph=True, pose_graph_every=2)
    cj, capj = [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpg, "PoseGraphHarvester", _injecting(jpg.PoseGraphHarvester, cj, joracle))
        _snooped(jpg, mp, capj)
        jrun.run_monocular(_seq(path), calib, cfg, **kw)
    ct, capt = [], {}
    Planes(monkeypatch, *jax_planes(jax.random.PRNGKey(3), N - 1, H >> 1, W >> 1, cfg, True))
    monkeypatch.setattr(tpg, "PoseGraphHarvester", _injecting(tpg.PoseGraphHarvester, ct, nplie))
    _snooped(tpg, monkeypatch, capt)
    _, poses, _ = trun.run_monocular(_seq(path), calib, config_from_reference(cfg), device="cpu",
                                     **kw)
    assert poses.shape == (N, 4, 4) and np.all(np.isfinite(poses))
    _rigid(poses)
    h, hj = ct[0], cj[0]
    assert h.live_refinements == hj.live_refinements >= 3
    raw, kf = capt["poses"], capt["kf"]
    assert h.max_rel_corr_t > 1e-3              # the injected edge did bend the chain
    np.testing.assert_allclose(h.max_rel_corr_t, hj.max_rel_corr_t, rtol=1e-2)
    assert kf == capj["kf"]
    np.testing.assert_allclose(raw, capj["poses"], rtol=0, atol=1e-3)
    for (k, T_ref), (kj, T_ref_j) in zip(h.refine_log, hj.refine_log):
        assert k == kj
        np.testing.assert_allclose(T_ref, T_ref_j, rtol=0, atol=1e-3)
    # Re-emitted on the refined pose: exact for a refinement that reached the
    # state alone.  The last two are written together after the last chunk
    # (the second was computed on rows that the first had not yet reached),
    # so the last trigger's row carries the first's correction once more, in
    # ``dvo_tpu`` as here; finalize's per-keyframe correction absorbs it.
    for k, T_ref in h.refine_log[:-2]:
        np.testing.assert_allclose(raw[kf[k]], T_ref, atol=2e-6)
    k_last, T_ref = h.refine_log[-1]
    np.testing.assert_allclose(raw[kf[k_last]] - T_ref,
                               capj["poses"][kf[k_last]] - hj.refine_log[-1][1], atol=1e-3)
    triggers = {k for k, _ in h.refine_log}
    bound_t = h.max_rel_corr_t * 1.5 + 1e-3
    kinks = 0
    for i, j, z, w in zip(h.e_i, h.e_j, h.e_z, h.e_w):
        if w == h.W_ODOM and j == i + 1:
            rel = np.linalg.inv(raw[kf[i]]) @ raw[kf[j]]
            delta = np.linalg.norm(nplie.se3_log(np.linalg.inv(nplie.se3_exp(z)) @ rel)[:3])
            if j in triggers:
                kinks += delta > bound_t
            else:
                assert delta < 1e-4, (i, j, delta)
    assert kinks == 1                           # the refinement that met the injected edge
