"""SE(3) Lie-group utilities (batched), the port of ``hobot_stereonet_tpu/slam/se3.py``.

Conventions, as in the JAX package:

  * a pose T = (R, t) maps points from *world* to *camera*:
    ``x_cam = R x_w + t``;
  * tangent vectors ``xi = [rho (3), phi (3)]`` (translation first), with
    exp/log by Rodrigues; every op broadcasts over leading batch dims.

Every geometry entry point runs with TF32 off (:func:`f32_matmuls`, through
``utils/precision.py::float32_exact``): the counterpart of the JAX
package's ``f32_matmuls``, which keeps chained 3x3 pose algebra and the
Gauss-Newton normal equations in full float32 (reduced-precision matmuls
took the synthetic trajectory's ATE from millimetres to over 2 m).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..utils.precision import float32_exact

_EPS = 1e-8


def f32_matmuls(fn):
    """Run ``fn`` with TF32 off for matrix products and convolutions."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with float32_exact():
            return fn(*args, **kwargs)

    return wrapped


def _eye(like: torch.Tensor, shape=()) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(*shape, 3, 3)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = phi.unbind(-1)
    zeros = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zeros, -z, y], dim=-1),
        torch.stack([z, zeros, -x], dim=-1),
        torch.stack([-y, x, zeros], dim=-1),
    ], dim=-2)


def _theta_coeffs(phi: torch.Tensor):
    """(small mask, t2, theta) [..., 1, 1], with theta's operand kept away
    from 0 (where the derivative of the norm is not finite)."""
    t2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = t2 < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    return small, t2, theta


@f32_matmuls
def exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    small, t2, theta = _theta_coeffs(phi)
    K = hat(phi)
    I = _eye(K, K.shape[:-2])
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, torch.ones_like(t2), t2))
    return I + a * K + b * (K @ K)


@f32_matmuls
def log_so3(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle."""
    trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    # Near the identity arccos has infinite slope: take the small-angle
    # branch, log ~ 0.5 * vee(R - R^T).
    near0 = cos_theta > 1.0 - 1e-7
    zero = torch.zeros_like(cos_theta)
    theta = torch.where(near0, zero, torch.arccos(torch.where(near0, zero, cos_theta)))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    th = theta[..., None]
    n0 = near0[..., None]
    sin_theta = torch.sin(torch.where(n0, torch.ones_like(th), th))
    s = torch.where(n0, 0.5 + th * th / 12.0, th / (2.0 * torch.clamp(sin_theta, min=1e-8)))
    return s * w


def _v_matrix(phi: torch.Tensor) -> torch.Tensor:
    """The left Jacobian V of SO(3) at ``phi``: ``t = V rho``."""
    small, t2, theta = _theta_coeffs(phi)
    K = hat(phi)
    I = _eye(K, K.shape[:-2])
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta)) / (safe_t2 * theta))
    return I + b * K + c * (K @ K)


@f32_matmuls
def exp_se3(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., 6] twist -> (R [..., 3, 3], t [..., 3])."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return exp_so3(phi), (_v_matrix(phi) @ rho[..., None])[..., 0]


@f32_matmuls
def log_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> [..., 6] twist."""
    phi = log_so3(R)
    rho = torch.linalg.solve(_v_matrix(phi), t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


@f32_matmuls
def compose(Ra, ta, Rb, tb) -> Tuple[torch.Tensor, torch.Tensor]:
    """T_a * T_b (apply b first, then a)."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


@f32_matmuls
def inverse(R, t) -> Tuple[torch.Tensor, torch.Tensor]:
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


@f32_matmuls
def transform(R, t, points: torch.Tensor) -> torch.Tensor:
    """Apply a pose to [..., N, 3] points."""
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def identity(batch_shape=(), device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    R = torch.eye(3, device=device).expand(*batch_shape, 3, 3)
    return R, torch.zeros((*batch_shape, 3), device=device)


@f32_matmuls
def relative_pose_error(R_est, t_est, R_gt, t_gt) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rotation error rad, translation error) between two poses."""
    dR = R_gt.transpose(-1, -2) @ R_est
    return (torch.linalg.vector_norm(log_so3(dR), dim=-1),
            torch.linalg.vector_norm(t_est - t_gt, dim=-1))
