"""Stereo visual odometry: triangulation, robust PnP: the port of
``hobot_stereonet_tpu/slam/odometry.py``.

RANSAC is a batch of M minimal-sample hypotheses refined together: one
batched Gauss-Newton (``[M, ...]`` tensors, a batched ``torch.linalg.solve``,
no loop over hypotheses), scored by inlier count; the best is refined on
all its inliers.  The iteration counts are fixed (the JAX package's
``lax.scan`` loops).  Sampling is split from scoring
(:func:`sample_hypotheses`, :func:`score_hypotheses`), so that a caller may
give the hypotheses' indices, as the tests give the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import CameraConfig
from . import se3


def triangulate(xy: torch.Tensor, disparity: torch.Tensor, camera: CameraConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel coords [K, 2] + disparity [K] -> camera-frame points [K, 3] and
    their validity (positive disparity, depth in (0.1, 200) m).

    Rectified-stereo back-projection: Z = f*B/d, X = (u-cx)Z/f,
    Y = (v-cy)Z/f, the principal point at the image centre."""
    f = camera.focal_px
    cx, cy = camera.width / 2.0, camera.height / 2.0
    d = torch.clamp(disparity, min=1e-6)
    z = f * camera.baseline_m / d
    x = (xy[:, 0] - cx) * z / f
    y = (xy[:, 1] - cy) * z / f
    valid = (disparity > 0.5) & (z > 0.1) & (z < 200.0)
    return torch.stack([x, y, z], dim=-1), valid


def project(points_cam: torch.Tensor, camera: CameraConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame [..., 3] -> pixel [..., 2]; valid = in front of the camera."""
    f = camera.focal_px
    cx, cy = camera.width / 2.0, camera.height / 2.0
    z = torch.clamp(points_cam[..., 2], min=1e-6)
    u = points_cam[..., 0] / z * f + cx
    v = points_cam[..., 1] / z * f + cy
    return torch.stack([u, v], dim=-1), points_cam[..., 2] > 0.1


def _huber_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    return torch.where(r <= delta, torch.ones_like(r), delta / r)


def _projection_jacobian(pc: torch.Tensor, f: float) -> torch.Tensor:
    """d(projection)/d(left perturbation xi) at camera-frame points
    [..., 3] -> [..., 2, 6]."""
    z = torch.clamp(pc[..., 2], min=1e-6)
    x, y = pc[..., 0], pc[..., 1]
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    J_pc = torch.stack([
        torch.stack([f * inv_z, zero, -f * x * inv_z ** 2], -1),
        torch.stack([zero, f * inv_z, -f * y * inv_z ** 2], -1),
    ], dim=-2)                                                        # [..., 2, 3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    J_xi = torch.cat([eye, -se3.hat(pc)], dim=-1)                     # [..., 3, 6]
    return J_pc @ J_xi


@se3.f32_matmuls
def pnp_gauss_newton(points_w: torch.Tensor, obs_px: torch.Tensor, weights: torch.Tensor,
                     camera: CameraConfig, R0: torch.Tensor, t0: torch.Tensor,
                     iters: int = 8, huber_px: float = 3.0, damping: float = 1e-4
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted robust PnP: minimize the reprojection error of world points
    [K, 3] against observations [K, 2] under the pose (R, t) (world -> cam),
    with left-multiplied increments, for a fixed number of iterations.

    ``weights`` [..., K] and the initial pose ([..., 3, 3], [..., 3]) may
    carry leading batch dims (the RANSAC hypotheses), solved together."""
    eye6 = torch.eye(6, dtype=points_w.dtype, device=points_w.device)
    R, t = R0, t0
    for _ in range(iters):
        pc = se3.transform(R, t, points_w)                            # [..., K, 3]
        proj, _ = project(pc, camera)
        r = proj - obs_px
        J = _projection_jacobian(pc, camera.focal_px)                 # [..., K, 2, 6]
        w = weights * _huber_weight(torch.sum(r * r, dim=-1), huber_px)
        Jw = J * w[..., None, None]
        H = torch.einsum("...kil,...kim->...lm", Jw, J) + damping * eye6
        g = torch.einsum("...kil,...ki->...l", Jw, r)
        xi = -torch.linalg.solve(H, g[..., None])[..., 0]
        dR, dt = se3.exp_se3(xi)
        R, t = se3.compose(dR, dt, R, t)
    return R, t


def reprojection_inliers(R, t, points_w, obs_px, camera: CameraConfig,
                         thresh_px: float = 3.0) -> torch.Tensor:
    pc = se3.transform(R, t, points_w)
    proj, in_front = project(pc, camera)
    err = torch.linalg.vector_norm(proj - obs_px, dim=-1)
    return (err < thresh_px) & in_front


class TrackResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor  # [K] bool
    num_inliers: torch.Tensor
    hypothesis: "torch.Tensor | None" = None   # index of the winning hypothesis


def sample_hypotheses(generator: torch.Generator, valid: torch.Tensor,
                      num_hypotheses: int = 64, sample_size: int = 6) -> torch.Tensor:
    """[M, sample_size] indices: for each hypothesis, ``sample_size``
    distinct indices drawn without replacement with probability uniform
    over the ``valid`` entries (Gumbel top-k, the method of
    ``jax.random.choice(..., p=p, replace=False)``), from ``generator``."""
    p = valid.float()
    p = p / torch.clamp(p.sum(), min=1.0)
    u = torch.rand((num_hypotheses, valid.shape[0]), generator=generator,
                   device=valid.device).clamp_(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.topk(gumbel + torch.log(p), sample_size, dim=1).indices


@se3.f32_matmuls
def score_hypotheses(idx: torch.Tensor, points_w: torch.Tensor, obs_px: torch.Tensor,
                     valid: torch.Tensor, camera: CameraConfig,
                     thresh_px: float = 3.0) -> TrackResult:
    """RANSAC on given hypotheses ``idx`` [M, S]: each hypothesis' pose by
    6 Gauss-Newton steps from the identity on its S points (all M in one
    batch), the one with the most inliers (the first of equals) refined by
    8 steps on its inliers."""
    m, k = idx.shape[0], points_w.shape[0]
    w = torch.zeros((m, k), device=points_w.device).scatter_(1, idx, 1.0)
    R0, t0 = se3.identity((m,), device=points_w.device)
    Rs, ts = pnp_gauss_newton(points_w, obs_px, w, camera, R0, t0, iters=6)
    inl = reprojection_inliers(Rs, ts, points_w, obs_px, camera, thresh_px) & valid
    best = torch.argmax(inl.sum(dim=1))
    R_best, t_best = Rs[best], ts[best]
    inl = reprojection_inliers(R_best, t_best, points_w, obs_px, camera, thresh_px) & valid
    R_f, t_f = pnp_gauss_newton(points_w, obs_px, inl.float(), camera, R_best, t_best,
                                iters=8)
    inl_f = reprojection_inliers(R_f, t_f, points_w, obs_px, camera, thresh_px) & valid
    return TrackResult(R=R_f, t=t_f, inliers=inl_f, num_inliers=inl_f.sum(), hypothesis=best)


def robust_pnp(generator: torch.Generator, points_w: torch.Tensor, obs_px: torch.Tensor,
               valid: torch.Tensor, camera: CameraConfig, num_hypotheses: int = 64,
               sample_size: int = 6, thresh_px: float = 3.0) -> TrackResult:
    """Vectorized RANSAC + Gauss-Newton PnP: :func:`sample_hypotheses` from
    ``generator`` (the JAX package's key), then :func:`score_hypotheses`."""
    idx = sample_hypotheses(generator, valid, num_hypotheses, sample_size)
    return score_hypotheses(idx, points_w, obs_px, valid, camera, thresh_px)
