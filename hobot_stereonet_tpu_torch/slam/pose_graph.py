"""Pose-graph optimization and appearance-based loop closure: the port of
``hobot_stereonet_tpu/slam/pose_graph.py``.

  * a static-shape problem: N poses, E edges with a validity mask (padded
    edges are masked, not absent);
  * the residual of an edge: ``r_e = log_se3(T_meas^-1 * T_i * T_j^-1)``;
  * exact Jacobians by forward-mode differentiation (``torch.func.jacfwd``)
    of the residual stack with respect to the [N, 6] left-perturbation
    twists at 0;
  * damped Gauss-Newton with dense normal equations [6N, 6N], pose 0 held
    by a stiff prior, a fixed number of iterations;
  * loop-closure candidates scored by one batched descriptor product over
    all past keyframes, verified geometrically by the RANSAC PnP.

``make_distributed_pose_graph`` shards the edges over the mesh's ``data``
ranks; all-reduces (sums) of H, g and the cost over the ``data`` group stand
in for the JAX package's ``psum``s.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.collectives import all_sum, data_group
from . import se3


class PoseGraph(NamedTuple):
    """Static-shape pose-graph problem.  Poses are world -> cam; an edge
    (i, j) carries the measured relative transform T_ij ~= T_i * T_j^-1."""

    R: torch.Tensor        # [N, 3, 3] initial rotations
    t: torch.Tensor        # [N, 3] initial translations
    edge_i: torch.Tensor   # [E] int64
    edge_j: torch.Tensor   # [E] int64
    R_ij: torch.Tensor     # [E, 3, 3] measured relative rotations
    t_ij: torch.Tensor     # [E, 3] measured relative translations
    weight: torch.Tensor   # [E] information weight (loop edges > odometry)
    valid: torch.Tensor    # [E] bool, the padding mask


def relative_pose(Ra, ta, Rb, tb) -> Tuple[torch.Tensor, torch.Tensor]:
    """T_a * T_b^-1: the pose of frame b's camera expressed in frame a."""
    Rbi, tbi = se3.inverse(Rb, tb)
    return se3.compose(Ra, ta, Rbi, tbi)


def _edge_residuals(xi, R0, t0, graph: PoseGraph) -> torch.Tensor:
    """[E, 6] residuals at left-perturbations xi [N, 6] of (R0, t0)."""
    dR, dt = se3.exp_se3(xi)
    R, t = se3.compose(dR, dt, R0, t0)
    R_rel, t_rel = relative_pose(R[graph.edge_i], t[graph.edge_i],
                                 R[graph.edge_j], t[graph.edge_j])
    Rm_inv, tm_inv = se3.inverse(graph.R_ij, graph.t_ij)
    R_err, t_err = se3.compose(Rm_inv, tm_inv, R_rel, t_rel)
    return se3.log_se3(R_err, t_err)


class PoseGraphResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    cost_history: torch.Tensor


def _gn_system(R, t, graph: PoseGraph):
    """Weighted normal equations (H [6N,6N], g [6N], cost) at xi = 0."""
    n = R.shape[0]
    xi0 = torch.zeros((n, 6), dtype=R.dtype, device=R.device)
    r = _edge_residuals(xi0, R, t, graph)                                     # [E, 6]
    J = torch.func.jacfwd(_edge_residuals)(xi0, R, t, graph)                  # [E,6,N,6]
    w = graph.valid.float() * graph.weight
    Jr = J.reshape(-1, 6, n * 6)
    Jf = Jr * w[:, None, None]
    H = torch.einsum("eik,eil->kl", Jf, Jr)
    g = torch.einsum("eik,ei->k", Jf, r)
    cost = torch.sum(w * torch.sum(r * r, dim=-1))
    return H, g, cost


@se3.f32_matmuls
def optimize_pose_graph(graph: PoseGraph, iters: int = 20, damping: float = 1e-6,
                        group=None) -> PoseGraphResult:
    """Damped Gauss-Newton over the whole graph; pose 0 held by a prior.
    ``group``: None on one device; else a process group whose ranks each
    hold a slice of the edges in ``graph``, the same poses everywhere: H, g
    and the cost are summed over it, and the solve runs on every rank alike."""
    n = graph.R.shape[0]
    gauge = torch.zeros(6 * n, device=graph.R.device)
    gauge[:6] = 1e8
    reg = damping * torch.eye(6 * n, device=graph.R.device) + torch.diag(gauge)
    R, t = graph.R, graph.t
    costs = []
    for _ in range(iters):
        H, g, cost = _gn_system(R, t, graph)
        if group is not None:
            H, g, cost = all_sum([H, g, cost], group)
        dx = -torch.linalg.solve(H + reg, g[:, None]).reshape(n, 6)
        dR, dt = se3.exp_se3(dx)
        R, t = se3.compose(dR, dt, R, t)
        costs.append(cost)
    return PoseGraphResult(R=R, t=t, cost_history=torch.stack(costs))


def make_distributed_pose_graph(mesh, iters: int = 20, damping: float = 1e-6):
    """Edge-sharded pose-graph Gauss-Newton over the mesh's ``data`` ranks
    (every rank of the group calls the returned function on the same graph).

    Data rank d takes the d-th equal slice of the edges and runs
    :func:`optimize_pose_graph` over the ``data`` group: its (J^T W J, J^T W
    r, cost), summed over the group, form the global normal equations.  E
    must divide by the ``data`` size (pad with ``valid=False`` edges at pose
    0; ``ValueError`` otherwise)."""
    group = data_group(mesh)

    def run(graph: PoseGraph) -> PoseGraphResult:
        shards = torch.distributed.get_world_size(group)
        e = graph.edge_i.shape[0]
        if e % shards:
            raise ValueError(f"{e} edges do not split over data={shards}")
        per, d = e // shards, torch.distributed.get_rank(group)
        local = PoseGraph(graph.R, graph.t, *(a[d * per:(d + 1) * per] for a in graph[2:]))
        return optimize_pose_graph(local, iters, damping, group=group)

    return run


# ---------------------------------------------------------------------------
# Loop closure: appearance scoring + geometric verification
# ---------------------------------------------------------------------------


@se3.f32_matmuls
def similarity_scores(query_desc, query_valid, all_desc, all_valid,
                      min_sim: float = 0.7) -> torch.Tensor:
    """[Nkf] place-recognition scores of one query keyframe against a stack
    of keyframes ([Nkf, K, D], [Nkf, K]): the share of the query's valid
    descriptors with a strong mutual match, over the smaller count of valid
    descriptors.  One batched product."""
    sim = torch.matmul(query_desc, all_desc.transpose(-1, -2))                # [N, K, K]
    sim = torch.where(query_valid[None, :, None] & all_valid[:, None, :], sim,
                      torch.tensor(float("-inf"), device=sim.device))
    best_b = sim.argmax(dim=2)                                                # [N, K]
    best_a_of_b = sim.argmax(dim=1)                                           # [N, K]
    k = sim.shape[1]
    mutual = torch.gather(best_a_of_b, 1, best_b) == torch.arange(k, device=sim.device)
    strong = sim.amax(dim=2) > min_sim
    good = (mutual & strong & query_valid[None]).sum(dim=1)
    denom = torch.clamp(torch.minimum(query_valid.sum(), all_valid.sum(dim=1)), min=1)
    return good.float() / denom.float()


class LoopClosure(NamedTuple):
    i: int                 # index of the matched (older) keyframe
    j: int                 # index of the query (newest) keyframe
    R_ij: np.ndarray       # measured T_i * T_j^-1
    t_ij: np.ndarray
    num_inliers: int
    score: float


def _verify_candidate(slam, cand, query, i: int, j: int, score: float,
                      min_inliers: int) -> Optional[LoopClosure]:
    """Geometric verification: the candidate's landmarks in its own camera
    frame against the query's keypoints -> PnP gives T_j * T_i^-1."""
    from .features import match
    from .odometry import robust_pnp

    dev = slam.device
    m = match(cand.keypoints, query.keypoints)
    mvalid = m.valid & torch.as_tensor(cand.valid, device=dev)[m.idx_a]
    pts_cand = se3.transform(torch.as_tensor(cand.R, device=dev),
                             torch.as_tensor(cand.t, device=dev),
                             torch.as_tensor(cand.points_w, device=dev))
    res = robust_pnp(slam.generator, pts_cand[m.idx_a], query.keypoints.xy[m.idx_b],
                     mvalid, slam.camera, thresh_px=slam.cfg.huber_delta_px)
    n_inl = int(res.num_inliers)
    if n_inl < min_inliers:
        return None
    Ri, ti = se3.inverse(res.R, res.t)
    return LoopClosure(i=i, j=j, R_ij=Ri.cpu().numpy(), t_ij=ti.cpu().numpy(),
                       num_inliers=n_inl, score=score)


def detect_loops(slam, min_gap: int = 5, score_threshold: float = 0.25,
                 min_inliers: int = 20, max_loops: int = 3) -> list:
    """Loop closures for the newest keyframe of a :class:`~.tracker.StereoSLAM`:
    every keyframe at least ``min_gap`` behind is scored in one pass; the
    candidates above ``score_threshold`` are verified in descending score
    until ``max_loops`` are accepted, each ``min_gap`` from the others."""
    kfs = slam.state.keyframes
    j = len(kfs) - 1
    if j < min_gap + 1:
        return []
    query = kfs[j]
    cands = kfs[: j - min_gap + 1]
    desc = torch.stack([k.keypoints.desc for k in cands])
    val = torch.stack([k.keypoints.valid for k in cands])
    scores = similarity_scores(query.keypoints.desc, query.keypoints.valid, desc,
                               val).cpu().numpy()
    order = np.argsort(scores)[::-1]
    accepted: list = []
    for idx in order:
        if len(accepted) >= max_loops or float(scores[idx]) < score_threshold:
            break
        if any(abs(int(idx) - a.i) < min_gap for a in accepted):
            continue
        lc = _verify_candidate(slam, cands[int(idx)], query, int(idx), j,
                               float(scores[idx]), min_inliers)
        if lc is not None:
            accepted.append(lc)
    return accepted


def detect_loop(slam, min_gap: int = 5, score_threshold: float = 0.25,
                min_inliers: int = 20) -> Optional[LoopClosure]:
    """The single best loop closure (:func:`detect_loops` with one)."""
    loops = detect_loops(slam, min_gap=min_gap, score_threshold=score_threshold,
                         min_inliers=min_inliers, max_loops=1)
    return loops[0] if loops else None


def build_keyframe_graph(slam, loops=(), odometry_weight: float = 1.0,
                         loop_weight: float = 10.0, pad_edges_to: int = 0,
                         pad_poses_to: int = 0) -> PoseGraph:
    """The odometry chain (consecutive keyframes' current relative poses)
    plus loop-closure edges, padded to ``pad_edges_to`` with masked
    self-edges and to ``pad_poses_to`` with edge-free identity poses."""
    kfs = slam.state.keyframes
    n = len(kfs)
    R = np.stack([k.R for k in kfs])
    t = np.stack([k.t for k in kfs])
    if pad_poses_to and n < pad_poses_to:
        R = np.concatenate(
            [R, np.broadcast_to(np.eye(3, dtype=R.dtype), (pad_poses_to - n, 3, 3))])
        t = np.concatenate([t, np.zeros((pad_poses_to - n, 3), t.dtype)])
    dev = slam.device
    R = torch.as_tensor(R, device=dev)
    t = torch.as_tensor(t, device=dev)
    ei, ej, Rm, tm, w, v = [], [], [], [], [], []
    for a in range(n - 1):
        Rr, tr = relative_pose(R[a], t[a], R[a + 1], t[a + 1])
        ei.append(a), ej.append(a + 1)
        Rm.append(Rr), tm.append(tr)
        w.append(odometry_weight), v.append(True)
    for lc in loops:
        ei.append(lc.i), ej.append(lc.j)
        Rm.append(torch.as_tensor(lc.R_ij, device=dev)), tm.append(
            torch.as_tensor(lc.t_ij, device=dev))
        w.append(loop_weight), v.append(True)
    while pad_edges_to and len(ei) < pad_edges_to:
        ei.append(0), ej.append(0)
        Rm.append(torch.eye(3, device=dev)), tm.append(torch.zeros(3, device=dev))
        w.append(0.0), v.append(False)
    return PoseGraph(
        R=R, t=t, edge_i=torch.tensor(ei, device=dev), edge_j=torch.tensor(ej, device=dev),
        R_ij=torch.stack(Rm), t_ij=torch.stack(tm),
        weight=torch.tensor(w, dtype=torch.float32, device=dev),
        valid=torch.tensor(v, device=dev))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def close_loops(slam, min_gap: int = 5, iters: int = 20, max_loops: int = 3
                ) -> Optional[dict]:
    """Detect loops for the newest keyframe and, if any verify, optimize the
    keyframe pose graph and write the correction back into the SLAM state:
    keyframe poses, each keyframe's landmarks re-anchored to keep their
    camera-frame position, the intermediate frames' poses corrected with
    their keyframe's, and both loop endpoints registered as anchors that
    window eviction keeps.  Shapes are padded to powers of two, as the JAX
    package pads them."""
    loops = detect_loops(slam, min_gap=min_gap, max_loops=max_loops)
    if not loops:
        return None
    st = slam.state
    kfs = st.keyframes
    n = len(kfs)
    graph = build_keyframe_graph(slam, loops=loops, pad_poses_to=_next_pow2(n),
                                 pad_edges_to=_next_pow2(n - 1 + len(loops)))
    res = optimize_pose_graph(graph, iters=iters)
    R_all, t_all = res.R.cpu().numpy(), res.t.cpu().numpy()

    old_poses = [(kf.R.copy(), kf.t.copy()) for kf in kfs]
    corrections = []            # per keyframe: K_old^-1 K_new as (R, t), world -> world
    for idx, kf in enumerate(kfs):
        R_new, t_new = R_all[idx], t_all[idx]
        R_old, t_old = old_poses[idx]
        p_cam = kf.points_w @ R_old.T + t_old
        kf.points_w = (p_cam - t_new) @ R_new
        kf.R, kf.t = R_new, t_new
        corrections.append((R_old.T @ R_new, R_old.T @ (t_new - t_old)))
        if 0 <= kf.index < len(st.poses):
            st.poses[kf.index] = (kf.R, kf.t)
            st.trajectory[kf.index] = slam._center(kf.R, kf.t)

    kf_indices = [kf.index for kf in kfs]
    bounds = kf_indices + [len(st.poses)]
    for k in range(n):
        Rc, tc = corrections[k]
        for fi in range(bounds[k] + 1, bounds[k + 1]):
            if fi in kf_indices or not (0 <= fi < len(st.poses)):
                continue
            Rf, tf = st.poses[fi]
            Rn, tn = Rf @ Rc, Rf @ tc + tf
            st.poses[fi] = (Rn, tn)
            st.trajectory[fi] = slam._center(Rn, tn)

    anchors = getattr(slam, "loop_anchor_indices", None)
    if anchors is not None:
        for lc in loops:
            anchors.add(kfs[lc.i].index)
            anchors.add(kfs[lc.j].index)
    return {"loop": loops[0], "loops": loops, "cost": res.cost_history.cpu().numpy()}
