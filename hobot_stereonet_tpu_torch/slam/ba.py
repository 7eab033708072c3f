"""Bundle adjustment: dense-block Schur-complement Gauss-Newton, the port
of ``hobot_stereonet_tpu/slam/ba.py``.

The problem is laid out in fixed-shape dense blocks:

  * a window of N keyframe poses (twist increments, pose 0 held by a stiff
    prior);
  * M landmarks and an observation grid obs [N, M, 2] with a validity mask
    (missing observations are masked, not absent);
  * Hll [M, 3, 3] block-diagonal, inverted as a batch of 3x3 matrices;
  * the Schur complement ``S = Hpp - Hpl Hll^-1 Hlp`` by ``einsum``;
  * the landmarks' back-substitution batched over M.

``make_distributed_bundle_adjust`` shards the landmarks over the mesh's
``data`` ranks: each builds its partial Schur complement, and all-reduces
(sums) over the ``data`` group stand in for the JAX package's ``psum``s.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import CameraConfig
from ..parallel.collectives import all_gather_cat, all_sum, data_group
from . import se3
from .odometry import _huber_weight, _projection_jacobian


class BAProblem(NamedTuple):
    poses: Tuple[torch.Tensor, torch.Tensor]  # (R [N,3,3], t [N,3]) world->cam
    landmarks: torch.Tensor                   # [M, 3] world points
    obs: torch.Tensor                         # [N, M, 2] pixel observations
    valid: torch.Tensor                       # [N, M] bool


def _residuals_and_jacobians(R, t, landmarks, obs, valid, camera: CameraConfig,
                             huber_px: float):
    """Residuals r [N,M,2], pose Jacobians Jp [N,M,2,6], landmark Jacobians
    Jl [N,M,2,3] and robust weights w [N,M]."""
    f = camera.focal_px
    cx, cy = camera.width / 2.0, camera.height / 2.0
    pc = torch.einsum("nij,mj->nmi", R, landmarks) + t[:, None, :]   # [N,M,3]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = pc[..., 0] / z * f + cx
    v = pc[..., 1] / z * f + cy
    r = torch.stack([u, v], dim=-1) - obs
    Jp = _projection_jacobian(pc, f)                                  # [N,M,2,6]
    # d(pc)/dX = R, so Jl = d(proj)/d(pc) R: the first three columns of Jp.
    Jl = torch.einsum("nmij,njk->nmik", Jp[..., :3], R)               # [N,M,2,3]
    w = valid.float() * _huber_weight(torch.sum(r * r, dim=-1), huber_px)
    w = w * (pc[..., 2] > 0.05)                # gate out points behind the camera
    return r, Jp, Jl, w


def _diagonal_only(H: torch.Tensor) -> torch.Tensor:
    return H * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)


def _build_normal_blocks(r, Jp, Jl, w, damping: float):
    """Weighted normal-equation blocks, damped (absolute + multiplicative)."""
    Jp_w = Jp * w[..., None, None]
    Jl_w = Jl * w[..., None, None]
    Hpp = torch.einsum("nmik,nmil->nkl", Jp_w, Jp)
    Hll = torch.einsum("nmik,nmil->mkl", Jl_w, Jl)
    Hpl = torch.einsum("nmik,nmil->nmkl", Jp_w, Jl)
    gp = torch.einsum("nmik,nmi->nk", Jp_w, r)
    gl = torch.einsum("nmik,nmi->mk", Jl_w, r)
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp = Hpp + damping * eye6 + damping * _diagonal_only(Hpp)
    Hll = Hll + damping * eye3 + 10.0 * damping * _diagonal_only(Hll)
    return Hpp, Hll, Hpl, gp, gl


def _reduced_system(Hpp, Hll, Hpl, gp, gl):
    """The reduced camera system S [N,N,6,6], b [N,6] (the landmarks
    eliminated), and Hll^-1 for the back-substitution."""
    n = Hpp.shape[0]
    Hll_inv = torch.linalg.inv(Hll)
    A = torch.einsum("nmkl,mlo->nmko", Hpl, Hll_inv)
    S = -torch.einsum("nmko,pmlo->npkl", A, Hpl)
    ar = torch.arange(n, device=Hpp.device)
    S[ar, ar] += Hpp
    b = gp - torch.einsum("nmko,mo->nk", A, gl)
    return S, b, Hll_inv


def _solve_reduced(S, b, Hpl, Hll_inv, gl, gauge_fix_first: bool = True):
    """Solve the reduced camera system and back-substitute the landmarks."""
    n = S.shape[0]
    S_flat = S.transpose(1, 2).reshape(6 * n, 6 * n)
    if gauge_fix_first:
        # Hold pose 0 by a stiff prior instead of resizing the system.
        S_flat[range(6), range(6)] += 1e8
    dx_p = -torch.linalg.solve(S_flat, b.reshape(6 * n, 1)).reshape(n, 6)
    rhs = gl + torch.einsum("nmkl,nk->ml", Hpl, dx_p)
    dx_l = -torch.einsum("mkl,ml->mk", Hll_inv, rhs)
    return dx_p, dx_l


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    landmarks: torch.Tensor
    cost_history: torch.Tensor


@se3.f32_matmuls
def bundle_adjust(problem: BAProblem, camera: CameraConfig, iters: int = 10,
                  huber_px: float = 3.0, damping: float = 1e-3, group=None) -> BAResult:
    """Dense-block BA, a fixed number of iterations.  ``group``: None on one
    device; else a process group whose ranks each hold a slice of the
    landmarks (and their observation columns) in ``problem``, the same poses
    everywhere: the reduced camera system and the cost are summed over it
    (the absolute pose damping, added on every rank, kept once), and the
    result holds this rank's landmarks."""
    R, t = problem.poses
    lm = problem.landmarks
    shards = 1 if group is None else torch.distributed.get_world_size(group)
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    costs = []
    for _ in range(iters):
        r, Jp, Jl, w = _residuals_and_jacobians(R, t, lm, problem.obs, problem.valid,
                                                camera, huber_px)
        cost = torch.sum(w * torch.sum(r * r, dim=-1))
        Hpp, Hll, Hpl, gp, gl = _build_normal_blocks(r, Jp, Jl, w, damping)
        if shards > 1:
            Hpp = Hpp - damping * eye6 * (1.0 - 1.0 / shards)
        S, b, Hll_inv = _reduced_system(Hpp, Hll, Hpl, gp, gl)
        if group is not None:
            S, b, cost = all_sum([S, b, cost], group)
        costs.append(cost)
        dx_p, dx_l = _solve_reduced(S, b, Hpl, Hll_inv, gl)
        dR, dt = se3.exp_se3(dx_p)
        R, t = se3.compose(dR, dt, R, t)
        lm = lm + dx_l
    return BAResult(R=R, t=t, landmarks=lm, cost_history=torch.stack(costs))


def make_distributed_bundle_adjust(mesh, camera: CameraConfig, iters: int = 10,
                                   huber_px: float = 3.0, damping: float = 1e-3):
    """Landmark-sharded BA over the mesh's ``data`` ranks (every rank of the
    group calls the returned function on the same problem).

    Data rank d takes the d-th equal slice of the landmarks and their
    observation columns, and runs :func:`bundle_adjust` over the ``data``
    group: its partial Schur complement, summed over the group, forms the
    global reduced camera system, and the pose solve ([6N, 6N]) runs on
    every rank alike; the landmarks' back-substitution stays on its rank,
    and the result gathers them.  M must divide by the ``data`` size
    (``ValueError``)."""
    group = data_group(mesh)

    def run(problem: BAProblem) -> BAResult:
        shards = torch.distributed.get_world_size(group)
        m = problem.landmarks.shape[0]
        if m % shards:
            raise ValueError(f"{m} landmarks do not split over data={shards}")
        per, d = m // shards, torch.distributed.get_rank(group)
        cols = slice(d * per, (d + 1) * per)
        local = BAProblem(problem.poses, problem.landmarks[cols], problem.obs[:, cols],
                          problem.valid[:, cols])
        res = bundle_adjust(local, camera, iters, huber_px, damping, group=group)
        return res._replace(landmarks=all_gather_cat(res.landmarks, group))

    return run
