"""Global pose-graph refinement over the keyframe trajectory —
``dvo_tpu.models.posegraph`` ported (no reference counterpart: the reference
never refines a pose after emitting it).

Gauss-Newton over the stacked world twists of all keyframes, constrained by
relative-pose measurements from three sources (harvested by
``utils.runner``):

  * odometry: the tracked relative pose between consecutive keyframes;
  * BA windows: refined relative poses between keyframes that shared a
    windowed-BA solve (``models/ba``), weight 3;
  * loop closures: re-tracked relative poses between non-adjacent keyframes
    that ended up spatially close, weight 10.

Residual convention: edge e = (i, j, z) with z = log(T_i^-1 T_j) measured;
r_e(d) = log(exp(z)^-1 (T_i exp(d_i))^-1 (T_j exp(d_j))), so a consistent
graph has r = 0, and the gauge is fixed by pinning node 0.

The problem is tiny (6N unknowns, N up to a few hundred), so the solve is
dense and runs on the run's device as plain PyTorch:

  * Jacobians are exact, by forward-mode differentiation through the Lie
    chain as in ``dvo_tpu`` (``jax.jacfwd``): one ``torch.func.jvp`` of the
    edge residual evaluated on a direction-batched input (E, 12, 6), whose
    tangents are the twelve unit increments of (d_i, d_j).  No ``vmap``, so
    ``lie.se3_exp``'s in-place assembly differentiates as it stands.
  * The normal matrix is J^T W J of the dense (6E, 6N) Jacobian: one
    product, where ``dvo_tpu`` adds 6x6 blocks by index.  An index-add with
    repeated indices uses atomics on CUDA and its sum order changes from run
    to run; the product's does not.  The sums differ from ``dvo_tpu``'s in
    order only (tests hold one step's twists at 1e-4, ten steps' at 1e-3).
  * ``optimize_pose_graph_padded`` keeps ``dvo_tpu``'s padding rule (inert
    identity nodes, weight-0 self-loops on the pinned node) but by default
    pads to nothing: eager PyTorch has no compiled program whose shapes a
    growing graph would change.

Precision: importing this module turns TF32 matmuls off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).

The harvester's per-node and per-edge bookkeeping is host NumPy float64
(``utils/oracle``): as device operations these tiny exp/log/compose calls
would cost one launch and one fetch each.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.models.frame import build_frame_with_depth
from dvo_tpu_torch.models.history import host_ints
from dvo_tpu_torch.models.tracker import track
from dvo_tpu_torch.utils import oracle as _nplie
from dvo_tpu_torch.utils.metrics import fetch, to_numpy

torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class PoseGraphEdges:
    """E relative-pose constraints between node i and node j."""

    i: torch.Tensor        # (E,) int64 source node
    j: torch.Tensor        # (E,) int64 target node
    z: torch.Tensor        # (E, 6) measured twist log(T_i^-1 T_j)
    weight: torch.Tensor   # (E,) scalar information weight

    @property
    def size(self) -> int:
        return self.i.shape[0]


def edges_from_arrays(i, j, z, weight, device) -> PoseGraphEdges:
    """``PoseGraphEdges`` on ``device`` from array-likes (numpy, or a
    ``dvo_tpu`` PoseGraphEdges' leaves)."""
    return PoseGraphEdges(
        i=torch.tensor(np.asarray(i), dtype=torch.int64, device=device),
        j=torch.tensor(np.asarray(j), dtype=torch.int64, device=device),
        z=torch.tensor(np.asarray(z), dtype=torch.float32, device=device),
        weight=torch.tensor(np.asarray(weight), dtype=torch.float32, device=device),
    )


# Shared by the absolute diagonal floor and the Jacobi clamp in
# pose_graph_step: see the comment there before changing either.
_DIAG_FLOOR = 1e-8


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    iterations: int = 10
    # Levenberg lambda, relative to diag(H): pose-graph normal matrices mix
    # translation and rotation scales and are near-singular along weakly
    # constrained directions, so an absolute ridge is either crushing or
    # useless in float32.  x0.25 on accepted steps, x4 on rejected ones.
    damping: float = 1e-4


def _edge_residual(xi_i, xi_j, z, d_i, d_j):
    """r = log(exp(z)^-1 (exp(xi_i) exp(d_i))^-1 (exp(xi_j) exp(d_j))), on
    (..., 6) twists."""
    T_i = lie.se3_exp(xi_i) @ lie.se3_exp(d_i)
    T_j = lie.se3_exp(xi_j) @ lie.se3_exp(d_j)
    M = lie.invert_T(lie.se3_exp(z)) @ lie.invert_T(T_i) @ T_j
    return lie.se3_log(M)


def _edge_terms(xi, edges: PoseGraphEdges):
    """Residuals and exact Jacobians with respect to the right increments
    at d = 0 for every edge.  Returns (r (E, 6), Ji (E, 6, 6), Jj (E, 6, 6))
    with J[e, a, b] = d r_a / d d_b."""
    xi_i, xi_j, z = xi[edges.i][:, None], xi[edges.j][:, None], edges.z[:, None]
    n_e = edges.size
    # Row t of the (12, 12) input is the increment (d_i, d_j); its tangent is
    # the t-th unit vector, so the output tangent's row t is column t of
    # [Ji | Jj].
    primal = torch.zeros((n_e, 12, 12), dtype=xi.dtype, device=xi.device)
    tangent = torch.eye(12, dtype=xi.dtype, device=xi.device).expand(n_e, 12, 12)
    r, cols = torch.func.jvp(
        lambda d: _edge_residual(xi_i, xi_j, z, d[..., :6], d[..., 6:]), (primal,), (tangent,))
    J = cols.transpose(1, 2)
    return r[:, 0], J[..., :6], J[..., 6:]


def _graph_cost(xi, edges: PoseGraphEdges):
    zero = torch.zeros((edges.size, 6), dtype=xi.dtype, device=xi.device)
    r = _edge_residual(xi[edges.i], xi[edges.j], edges.z, zero, zero)
    return torch.sum(edges.weight * torch.sum(r * r, dim=-1))


def pose_graph_step(xi, lam, edges: PoseGraphEdges, cfg: PoseGraphConfig, n_real=None):
    """One Levenberg step with Jacobi preconditioning and accept/reject, all
    on the device (a failed factorisation or a worse candidate is a
    ``where``, not a host branch).  Returns (new_xi, new_lam, cost_at_xi).
    ``n_real``: the number of live nodes when the graph is padded; padded
    nodes get an identity diagonal block (no edge touches them, so their raw
    block is zero and would sink the Cholesky) and solve to a zero update."""
    n = xi.shape[0]
    n_e = edges.size
    r, Ji, Jj = _edge_terms(xi, edges)
    w = edges.weight
    # Gauge: node 0 is pinned, so its Jacobian columns are zero.
    Ji = Ji * (edges.i != 0).to(xi.dtype)[:, None, None]
    Jj = Jj * (edges.j != 0).to(xi.dtype)[:, None, None]

    # Dense Jacobian, rows (edge, component), columns (node, component).  An
    # edge writes two blocks of its own rows, so no two writes meet except a
    # self-loop's, which the second, additive, write handles.
    e = torch.arange(n_e, device=xi.device)
    Jd = torch.zeros((n_e, n, 6, 6), dtype=xi.dtype, device=xi.device)
    Jd[e, edges.i] = Ji
    Jd[e, edges.j] += Jj
    Jd = Jd.permute(0, 2, 1, 3).reshape(6 * n_e, 6 * n)
    wJd = Jd * w.repeat_interleave(6)[:, None]
    A = Jd.T @ wJd
    g = wJd.T @ r.reshape(6 * n_e)

    A[:6, :6] += torch.eye(6, dtype=A.dtype, device=A.device)  # gauge block
    if n_real is not None:
        padded = (torch.arange(n, device=xi.device) >= n_real).repeat_interleave(6)
        A = A + torch.diag(padded.to(A.dtype))
    diag = torch.diagonal(A).clone()
    # Absolute floor beside the relative Levenberg ridge: a degree of freedom
    # whose diagonal is zero (a node none of whose edges constrains it) would
    # make the preconditioned Cholesky factor a singular matrix, the step
    # NaN, and the isfinite guard below would then zero every step.  With
    # the floor such a degree of freedom solves to a zero update.
    # _DIAG_FLOOR must match the preconditioner's clamp: the pair makes a
    # floored row's scaled diagonal exactly 1 (1e-8 / sqrt(1e-8)^2); a
    # tighter clamp would bring back a ~1e4 condition spike.
    A = A + torch.diag(lam * diag + _DIAG_FLOOR)
    # Jacobi preconditioning: the float32 Cholesky of the raw system (mixed
    # translation and rotation scales) loses enough digits to turn a
    # near-zero-residual solve into a random walk.
    D = 1.0 / torch.sqrt(torch.clamp(diag, min=_DIAG_FLOOR))
    As = A * D[:, None] * D[None, :]
    L, info = torch.linalg.cholesky_ex(As, check_errors=False)
    L = torch.where(info == 0, L, torch.nan)
    y = torch.cholesky_solve((D * g)[:, None], L)[:, 0]
    d = (-D * y).reshape(n, 6)
    d[0].zero_()
    d = torch.where(torch.all(torch.isfinite(d)), d, 0.0)

    cost = torch.sum(w * torch.sum(r * r, dim=-1))
    cand = lie.compose(xi, d)
    accept = _graph_cost(cand, edges) < cost
    new_xi = torch.where(accept, cand, xi)
    new_lam = torch.clamp(torch.where(accept, lam * 0.25, lam * 4.0), 1e-7, 1e3)
    return new_xi, new_lam, cost


def optimize_pose_graph(xi, edges: PoseGraphEdges, cfg: PoseGraphConfig = PoseGraphConfig(),
                        n_real=None):
    """Refine node twists on their device.  Returns (xi_refined (N, 6),
    costs (iterations,)).  ``n_real``: the live-node count of a padded
    graph."""
    lam = torch.full((), cfg.damping, dtype=torch.float32, device=xi.device)
    costs = []
    for _ in range(cfg.iterations):
        xi, lam, cost = pose_graph_step(xi, lam, edges, cfg, n_real=n_real)
        costs.append(cost)
    return xi, torch.stack(costs)


def optimize_pose_graph_padded(xi0, e_i, e_j, e_z, e_w,
                               cfg: PoseGraphConfig = PoseGraphConfig(),
                               node_bucket: int = 1, edge_bucket: int = 1, device="cuda"):
    """Host-side entry of the solve: numpy lists or arrays in, (xi_refined
    (N, 6) numpy, costs numpy) out, solved on ``device`` (the card unless
    ``"cpu"`` is asked for).  Nodes and edges are padded up to multiples of
    the buckets as ``dvo_tpu`` pads them (identity poses without edges;
    weight-0 self-loops on the pinned node), which changes nothing of the
    live nodes' solution; the default buckets of 1 pad only an empty edge
    list."""
    n = len(xi0)
    e = len(e_w)
    n_pad = -(-max(n, 1) // node_bucket) * node_bucket
    e_pad = -(-max(e, 1) // edge_bucket) * edge_bucket
    xi_p = np.zeros((n_pad, 6), np.float32)
    xi_p[:n] = np.asarray(xi0, np.float32)
    i_p = np.zeros(e_pad, np.int64)
    j_p = np.zeros(e_pad, np.int64)
    z_p = np.zeros((e_pad, 6), np.float32)
    w_p = np.zeros(e_pad, np.float32)
    i_p[:e] = np.asarray(e_i, np.int64)
    j_p[:e] = np.asarray(e_j, np.int64)
    z_p[:e] = np.stack(e_z).astype(np.float32) if e else 0
    w_p[:e] = np.asarray(e_w, np.float32)
    edges = edges_from_arrays(i_p, j_p, z_p, w_p, device)
    xi_ref, costs = optimize_pose_graph(torch.tensor(xi_p, device=device), edges, cfg, n_real=n)
    out = fetch(torch.cat([xi_ref.reshape(-1), costs]))
    return out[:6 * n_pad].reshape(n_pad, 6)[:n].copy(), out[6 * n_pad:].copy()


def apply_live_correction(state, xi_ref_slot, id_slot, max_id: int, corr):
    """Write a chunked run's live refinement into the device ``VOState``.

    The chunked path applies a correction two chunks after the promotion
    that triggered it (results drain one chunk behind), so the ring may by
    then hold keyframes promoted after the refinement was computed.  Slots
    are therefore addressed by frame identity (``history.kf_id``):

      * kf_id[slot] == id_slot[slot]: the slot still holds a refined node
        and takes its refined twist (``xi_ref_slot``, laid out by the
        push-to-slot map slot = push % capacity);
      * kf_id[slot] > max_id: promoted after the refinement; it moves
        rigidly by the newest refined node's left-correction ``corr =
        T_new @ inv(T_old)``;
      * otherwise (the never-refined first keyframe, or empty): kept.

    The reference keyframe is the ring's head, so its twist is a copy of the
    head slot's new one (a copy: the ring must not alias ``ref.xi``).
    ``prev_rel`` and ``vel`` are relative and do not change.  Depth and
    sigma maps are not re-scaled (``PoseGraphHarvester._refine_nodes``)."""
    hist = state.history
    dev = hist.xi.device
    xi_ref_slot = torch.as_tensor(np.asarray(xi_ref_slot, np.float32)).to(dev)
    id_slot = torch.as_tensor(np.asarray(id_slot, np.int32)).to(dev)
    corr = torch.as_tensor(np.asarray(corr, np.float32)).to(dev)
    rigid = lie.se3_log(corr @ lie.se3_exp(hist.xi))
    take_ref = hist.kf_id == id_slot
    take_rigid = hist.kf_id > int(max_id)
    new_xi = torch.where(take_ref[:, None], xi_ref_slot,
                         torch.where(take_rigid[:, None], rigid, hist.xi))
    return dataclasses.replace(
        state,
        history=dataclasses.replace(hist, xi=new_xi),
        ref=dataclasses.replace(state.ref, xi=new_xi.index_select(0, hist.head.view(1))[0]),
    )


# ----------------------------------------------------------- host-side utils

def chain_edges(kf_xi, weight=1.0):
    """Consecutive-keyframe odometry constraints from the emitted chain
    itself: z_k = log(T_k^-1 T_{k+1}).  Alone they make the graph exactly
    consistent (a no-op); the harvester adds all-pairs BA-window edges and
    re-tracked loop closures."""
    kf_xi = np.asarray(kf_xi)
    n = kf_xi.shape[0]
    i = np.arange(n - 1, dtype=np.int32)
    j = i + 1
    T = [_nplie.se3_exp(x) for x in kf_xi]
    z = np.stack([_nplie.se3_log(np.linalg.inv(T[a]) @ T[b])
                  for a, b in zip(i, j)]).astype(np.float32)
    return i, j, z, np.full(n - 1, weight, np.float32)


def build_edges(i_list, j_list, z_list, w_list, device="cuda") -> PoseGraphEdges:
    """Stack harvested constraint lists into a ``PoseGraphEdges`` on
    ``device``."""
    return edges_from_arrays(np.concatenate(i_list), np.concatenate(j_list),
                             np.concatenate(z_list), np.concatenate(w_list), device)


@dataclasses.dataclass
class _Node:
    frame_idx: int
    T_emit: np.ndarray                  # emitted 4x4 world pose at promotion
    gray: np.ndarray                    # input-resolution gray (host copy)
    mask: np.ndarray
    depth: "np.ndarray | None" = None   # refined base-level depth (on retire)
    sigma: "np.ndarray | None" = None


class PoseGraphHarvester:
    """Host-side constraint harvesting during a monocular run.

    The per-frame runner calls ``on_frame`` after every ``monocular_step``,
    the chunked one ``on_chunk_row`` per drained keyframe row and
    ``absorb_ring`` per chunk; ``finalize`` at the sequence's end (1) mines
    loop-closure candidates among spatially near keyframe pairs and
    re-tracks them with the ordinary tracker, on ``device``, (2) solves the
    graph and (3) re-emits the refined trajectory.

    Weights: odometry 1, BA window 3, re-tracked closure 10 (a closure is a
    direct photometric alignment, not a chained estimate).

    ``refine_every`` > 0: every that-many promotions the graph is solved
    mid-run, freshly mined closures included, and the corrections are
    written into the live keyframe ring (``state.history.xi`` and the
    reference's pose), so that the mapping builds on corrected geometry.
    ``on_frame`` then returns the corrected state (None when nothing
    changed).
    """

    W_ODOM, W_BA, W_CLOSURE = 1.0, 3.0, 10.0

    def __init__(self, cfg, K, max_closures: int = 16, closure_residual: float = 0.02,
                 verbose: bool = False, refine_every: int = 0,
                 pg_cfg: "PoseGraphConfig" = None, device="cuda"):
        self.cfg = cfg
        self.K = K
        self.max_closures = max_closures
        self.closure_residual = closure_residual
        self.verbose = verbose
        self.refine_every = refine_every
        self.device = torch.device(device)
        # One solver config for the periodic refinements and the final pass.
        self.pg_cfg = pg_cfg if pg_cfg is not None else PoseGraphConfig()
        self.nodes: list = []
        self.e_i, self.e_j, self.e_z, self.e_w = [], [], [], []
        self.closures = 0
        self._closure_pairs: set = set()
        # Candidates re-tracked and rejected: geometry changes little between
        # refinements, so a rejected pair is not tracked again.
        self._tried_pairs: set = set()
        self.live_refinements = 0
        # Largest non-rigid relative-pose change any refinement has applied
        # between consecutive live-ring keyframes (_refine_nodes).
        self.max_rel_corr_t = 0.0   # metres
        self.max_rel_corr_r = 0.0   # degrees
        # Deferred ring snapshots that arrived stale (absorb_ring).
        self.stale_snaps = 0
        # Chunked bookkeeping: ring pushes seen so far (the first keyframe is
        # push 0) and deferred (node index, ring slot) snapshot requests.
        self._pushes = 1
        self._pending_snaps: list = []

    # ------------------------------------------------------------- harvest

    def _add_edge(self, i, j, z, w):
        self.e_i.append(i)
        self.e_j.append(j)
        self.e_z.append(np.asarray(z, np.float32))
        self.e_w.append(w)

    def _add_ba_edges(self, window_T):
        """All-pairs edges between the newest ``len(window_T)`` nodes from
        their BA-refined poses (oldest first): they over-constrain the
        graph, so a refinement can correct even without a revisit."""
        m = len(window_T)
        first = len(self.nodes) - m
        for a in range(m - 1):
            if first + a < 0:
                continue
            for b in range(a + 1, m):
                z = _nplie.se3_log(np.linalg.inv(window_T[a]) @ window_T[b])
                self._add_edge(first + a, first + b, z, self.W_BA)

    def _refine_due(self) -> bool:
        return (self.refine_every > 0 and len(self.nodes) >= 4
                and len(self.nodes) % self.refine_every == 0)

    def on_frame(self, frame_idx, res, state, gray, mask):
        """Harvest this frame's ``StepResult`` (per-frame runner).  Returns a
        corrected ``VOState`` when a periodic refinement fired, else
        None."""
        hist = state.history
        # The decision and the ring's head and count in one copy.
        kf, head, _ = torch.stack([res.is_keyframe.to(torch.int32), hist.head,
                                   hist.count]).tolist()
        if not kf:
            return None
        node = _Node(frame_idx=frame_idx, T_emit=to_numpy(res.T_world),
                     gray=np.asarray(gray), mask=np.asarray(mask))
        if self.nodes:
            # The tracked relative pose is log(T_i^-1 T_j) (with_pose).
            self._add_edge(len(self.nodes) - 1, len(self.nodes), to_numpy(res.relative_xi),
                           self.W_ODOM)
            # The outgoing keyframe retired at this promotion: its final
            # depth and sigma, for closure re-tracking, are in its slot.
            slot = (head - 1) % hist.capacity
            prev = self.nodes[-1]
            prev.depth = fetch(hist.depth[slot])
            prev.sigma = fetch(hist.sigma[slot])
        self.nodes.append(node)

        if float(res.ba_cost) >= 0.0 and self.cfg.ba.enabled:
            xi_all = fetch(hist.xi)
            m = min(self.cfg.ba.window, len(self.nodes))
            self._add_ba_edges([_nplie.se3_exp(xi_all[(head - (m - 1 - a)) % hist.capacity])
                                for a in range(m)])

        return self._refine_live(state) if self._refine_due() else None

    def on_chunk_row(self, frame_idx, row, gray, mask, T_emit=None):
        """``on_frame`` for a keyframe row drained by the chunked runner.
        The retiring keyframe's depth and sigma are deferred (the runner
        fetches the ring once per chunk and calls ``absorb_ring``), and BA
        edges come from ``row.ba_window_xi``, the window's poses at this
        promotion, which the ring at the chunk's end no longer holds once
        later promotions ran BA again.  Returns True when a periodic
        refinement is due (the runner refines after absorbing the ring)."""
        cap = self.cfg.mapper.history_capacity
        node = _Node(
            frame_idx=frame_idx,
            # The (possibly corrected) pose the runner emitted for this frame.
            T_emit=to_numpy(T_emit if T_emit is not None else row.T_world).copy(),
            gray=np.asarray(gray).copy(), mask=np.asarray(mask).copy())
        if self.nodes:
            self._add_edge(len(self.nodes) - 1, len(self.nodes), to_numpy(row.relative_xi),
                           self.W_ODOM)
            # The outgoing keyframe's slot is the previous push's (pushes
            # are the only movement of the head).
            self._pending_snaps.append((len(self.nodes) - 1, (self._pushes - 1) % cap))
        self._pushes += 1
        self.nodes.append(node)

        if float(row.ba_cost) >= 0.0 and self.cfg.ba.enabled:
            win = to_numpy(row.ba_window_xi)
            m = min(len(win), len(self.nodes))
            self._add_ba_edges([_nplie.se3_exp(win[len(win) - m + a]) for a in range(m)])
        return self._refine_due()

    def absorb_ring(self, ring_depth, ring_sigma, ring_kf_id=None):
        """Resolve the deferred depth and sigma snapshots from a host copy
        of the ring.  A slot counts only if it still holds the retired
        keyframe (a chunk that promotes more keyframes than the ring holds
        overwrites early retirements before the fetch): ``ring_kf_id`` is
        checked against the node's frame id, and a stale slot leaves its
        node without depth, which closure mining then skips
        (``stale_snaps`` counts them)."""
        for node_idx, slot in self._pending_snaps:
            if ring_kf_id is not None and int(ring_kf_id[slot]) != int(
                    self.nodes[node_idx].frame_idx):
                self.stale_snaps += 1
                continue
            self.nodes[node_idx].depth = np.asarray(ring_depth[slot]).copy()
            self.nodes[node_idx].sigma = np.asarray(ring_sigma[slot]).copy()
        self._pending_snaps = []

    def refine_live_chunked(self):
        """The chunked runner's periodic refinement (after ``absorb_ring``):
        mine closures and solve over the harvested nodes.  Returns (xi_ref
        (M, 6), corr (4, 4)), the refined node twists and the newest node's
        left-correction T_new @ inv(T_old), or None.  The runner applies
        them: to the ring and the reference on the device, and to the rows
        already emitted."""
        t_old = self.nodes[-1].T_emit.copy()
        xi_ref = self._refine_nodes(track_bound=True)
        if xi_ref is None:
            return None
        corr = self.nodes[-1].T_emit @ np.linalg.inv(t_old)
        self.live_refinements += 1
        if self.verbose:
            print(f"pose-graph live refinement #{self.live_refinements} (chunked): "
                  f"{len(self.nodes)} nodes, {len(self.e_w)} edges, {self.closures} closures")
        return xi_ref, corr

    # ------------------------------------------------------------ closures

    def _retrack(self, ni: _Node, nj: _Node, K):
        """Track node j against node i with the ordinary tracker on the
        device (on a card: two frame-build launches and one GN launch per
        level).  Returns (xi (6,), final residual) from one packed fetch."""
        s = 2 ** self.cfg.pyramid.culls
        levels = self.cfg.pyramid.levels
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        d_i, s_i = dev(ni.depth), dev(ni.sigma)
        ref = build_frame_with_depth(dev(ni.gray[::s, ::s]), dev(ni.mask[::s, ::s]), d_i, s_i,
                                     K, levels, 0, 0)
        # The tracker does not read the object frame's depth: the reference
        # node's map stands in.
        obj = build_frame_with_depth(dev(nj.gray[::s, ::s]), dev(nj.mask[::s, ::s]), d_i, s_i,
                                     K, levels, 0, 1)
        tr = track(obj, ref, self.cfg.tracker)
        last = torch.clamp(tr.iterations[-1] - 1, min=0).long()
        out = fetch(torch.cat([tr.xi, tr.residuals[-1][last][None]]))
        return out[:6].copy(), float(out[6])

    def _mine_closures(self):
        n = len(self.nodes)
        if n < 4:
            return
        ts = np.stack([nd.T_emit[:3, 3] for nd in self.nodes])
        Rs = [nd.T_emit[:3, :3] for nd in self.nodes]
        step = np.linalg.norm(np.diff(ts, axis=0), axis=1)
        radius = max(2.0 * float(np.median(step)), 1e-3)
        cands = []
        for i in range(n):
            if self.nodes[i].depth is None:
                continue
            for j in range(i + 3, n):
                d = float(np.linalg.norm(ts[i] - ts[j]))
                if d > radius:
                    continue
                ang = np.arccos(np.clip((np.trace(Rs[i].T @ Rs[j]) - 1) / 2, -1, 1))
                if ang > np.deg2rad(45):
                    continue
                cands.append((d, i, j))
        cands.sort()
        cands = cands[: self.max_closures]
        if not cands:
            return

        s = 2 ** self.cfg.pyramid.culls
        K = np.asarray(self.K, np.float32).copy() / s
        K[2, 2] = 1.0
        K = torch.from_numpy(K).to(self.device)
        for d, i, j in cands:
            if (i, j) in self._closure_pairs or (i, j) in self._tried_pairs:
                continue
            self._tried_pairs.add((i, j))
            xi, resid = self._retrack(self.nodes[i], self.nodes[j], K)
            if not (0.0 <= resid < self.closure_residual):
                continue
            self._add_edge(i, j, xi, self.W_CLOSURE)
            self._closure_pairs.add((i, j))
            self.closures += 1
            if self.verbose:
                print(f"closure {i}->{j} dist={d:.3f} resid={resid:.4f}")

    # ------------------------------------------------------ live refinement

    def _node_twists(self):
        return np.stack([_nplie.se3_log(nd.T_emit) for nd in self.nodes]).astype(np.float32)

    def _refine_nodes(self, track_bound: bool = False):
        """The refinement core: mine closures over the harvested nodes,
        solve the graph with ``self.pg_cfg`` and move every node's
        ``T_emit`` to its refined estimate.  Returns the refined (M, 6)
        twists as numpy, or None when there is nothing to refine (no edges,
        or a non-finite solve).

        A live write-back corrects ring poses but not ring depth or sigma.
        Depth maps are local to their keyframe (range along its own rays)
        and so invariant under a rigid move of the whole chain; only the
        non-rigid part, the change in relative pose between consecutive ring
        keyframes, perturbs the geometry that the epipolar updates and BA
        assumed.  That part is tracked per refinement (``max_rel_corr_t``
        metres, ``max_rel_corr_r`` degrees, the maximum over consecutive
        live-ring pairs)."""
        self._mine_closures()
        if not self.e_w:
            return None
        cap = self.cfg.mapper.history_capacity
        T_before = [nd.T_emit.copy() for nd in self.nodes[-(cap + 1):]]
        xi_ref, _costs = optimize_pose_graph_padded(
            self._node_twists(), self.e_i, self.e_j, self.e_z, self.e_w, self.pg_cfg,
            device=self.device)
        if not np.all(np.isfinite(xi_ref)):
            return None
        # Closure mining and the final pass both start from the refined poses.
        for nd, x in zip(self.nodes, xi_ref):
            nd.T_emit = _nplie.se3_exp(x).astype(np.float32)
        # Per consecutive pair of the live window, delta = inv(rel_old) @ rel_new.
        T_after = [nd.T_emit for nd in self.nodes[-(cap + 1):]]
        for a in range(len(T_before) - 1 if track_bound else 0):
            rel_old = np.linalg.inv(T_before[a]) @ T_before[a + 1]
            rel_new = np.linalg.inv(T_after[a]) @ T_after[a + 1]
            d = np.linalg.inv(rel_old) @ rel_new
            dt = float(np.linalg.norm(d[:3, 3]))
            dr = float(np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))))
            self.max_rel_corr_t = max(self.max_rel_corr_t, dt)
            self.max_rel_corr_r = max(self.max_rel_corr_r, dr)
        return xi_ref

    def _refine_live(self, state):
        """The per-frame runner's periodic refinement: mine closures over
        the nodes so far, solve, and write the corrections into the live
        ring (``history.xi`` and the reference keyframe's pose).  Returns the
        corrected ``VOState``, or None when there is nothing to correct."""
        xi_ref = self._refine_nodes(track_bound=True)
        if xi_ref is None:
            return None
        # The newest min(count, nodes) nodes occupy slots head, head-1, ...
        hist = state.history
        head, count = host_ints(hist)
        live = min(count, len(self.nodes))
        xi_arr = fetch(hist.xi).copy()
        for k in range(live):
            xi_arr[(head - k) % hist.capacity] = xi_ref[len(self.nodes) - 1 - k]
        self.live_refinements += 1
        if self.verbose:
            print(f"pose-graph live refinement #{self.live_refinements}: {len(self.nodes)} "
                  f"nodes, {len(self.e_w)} edges, {self.closures} closures")
        dev = hist.xi.device
        return dataclasses.replace(
            state,
            history=dataclasses.replace(hist, xi=torch.from_numpy(xi_arr).to(dev)),
            ref=dataclasses.replace(
                state.ref, xi=torch.from_numpy(np.asarray(xi_ref[-1], np.float32)).to(dev)),
        )

    # ------------------------------------------------------------ finalize

    def finalize(self, times, poses, state=None, pg_cfg: PoseGraphConfig = None):
        """Mine closures, solve, and return (the refined (N, 4, 4)
        trajectory, the solve's costs); with fewer than 2 keyframes the
        input and no costs."""
        if len(self.nodes) < 2:
            return np.asarray(poses), np.zeros(0, np.float32)
        # The newest keyframe never retired: its maps are in the live ring.
        if state is not None and self.nodes[-1].depth is None:
            hist = state.history
            head, _ = host_ints(hist)
            self.nodes[-1].depth = fetch(hist.depth[head])
            self.nodes[-1].sigma = fetch(hist.sigma[head])
        self._mine_closures()
        xi_ref, costs = optimize_pose_graph_padded(
            self._node_twists(), self.e_i, self.e_j, self.e_z, self.e_w,
            pg_cfg if pg_cfg is not None else self.pg_cfg, device=self.device)
        refined = apply_refinement(times, poses, [nd.frame_idx for nd in self.nodes], xi_ref)
        return refined, costs


def apply_refinement(times, poses, kf_frame_idx, kf_xi_refined):
    """Re-emit a full trajectory after a refinement: each frame's pose is
    corrected by its most recent keyframe's correction, T'_f = T'_kf
    (T_kf^-1 T_f); the motion tracked since the keyframe is trusted.
    ``poses``: (N, 4, 4) as emitted; ``kf_frame_idx``: the frame index of
    each keyframe node; ``kf_xi_refined``: (M, 6).  Returns (N, 4, 4)."""
    poses = np.asarray(poses)
    out = poses.copy()
    kf_T_new = [_nplie.se3_exp(np.asarray(x)) for x in kf_xi_refined]
    kf_idx = list(kf_frame_idx)
    cur = -1
    for f in range(len(poses)):
        while cur + 1 < len(kf_idx) and kf_idx[cur + 1] <= f:
            cur += 1
        if cur < 0:
            continue
        corr = kf_T_new[cur] @ np.linalg.inv(poses[kf_idx[cur]])
        out[f] = corr @ poses[f]
    return out
