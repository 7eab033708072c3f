"""Resolution changes: fixed 2x stencils and learned convex upsampling.

Counterparts of ``hobot_stereonet_tpu/ops/upsample.py``, on the same
channel-last [B, H, W, C] layout.  None has a Pallas kernel there, and all
stay plain PyTorch here.  ``upsample_bilinear`` serves power-of-two factors
only: the reference's ``jax.image.resize`` fallback for other factors is
used by no model and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _stencil2x(x: torch.Tensor, dim: int) -> torch.Tensor:
    """2x half-pixel bilinear along ``dim`` (1 or 2) of [B, H, W, C], edges
    repeated: out[2i] = 0.25 x[i-1] + 0.75 x[i], out[2i+1] = 0.75 x[i] + 0.25 x[i+1]."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    out = torch.stack([even, odd], dim + 1)
    return out.flatten(dim, dim + 1)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C], half-pixel-centre bilinear (the
    result of ``jax.image.resize(..., "bilinear")`` at a factor of 2)."""
    return _stencil2x(_stencil2x(x, 1), 2)


def upsample_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C] by repeated 2x stencils; ``h`` and ``w``
    must be ``H`` and ``W`` times one power of two."""
    while x.shape[1] * 2 <= h and x.shape[2] * 2 <= w:
        x = upsample2x_bilinear(x)
    if x.shape[1] != h or x.shape[2] != w:
        raise NotImplementedError(
            f"upsample_bilinear to {h}x{w} from {x.shape[1]}x{x.shape[2]}: the port serves "
            "power-of-two factors only")
    return x


def downsample2x_avg(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, C] 2x2 average, summed in the
    reference's order."""
    return 0.25 * (x[:, ::2, ::2] + x[:, 1::2, ::2] + x[:, ::2, 1::2] + x[:, 1::2, 1::2])


def downsample_avg(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``factor`` (a power of two) times :func:`downsample2x_avg`'s 2x."""
    while factor > 1:
        x = downsample2x_avg(x)
        factor //= 2
    return x


def convex_upsample(disp: torch.Tensor, mask_logits: torch.Tensor, k: int) -> torch.Tensor:
    """Learned k-x upsampling of a coarse disparity.

    disp:        [B, h, w] coarse disparity (already in full-res px units)
    mask_logits: [B, h, w, 9*k*k], channels split as (9, k*k)
    returns      [B, h*k, w*k] float32

    Each fine pixel is a softmax-weighted combination of the zero-padded 3x3
    coarse neighbourhood.  The softmax runs in the mask's dtype and rounds
    where ``jax.nn.softmax`` does: after ``x - max``, after ``exp``, after
    the sum (taken in float32) and after the division.  The weighted sum
    runs in float32.
    """
    b, h, w = disp.shape
    x = mask_logits.reshape(b, h, w, 9, k * k)
    e = torch.exp(x - x.amax(3, keepdim=True))
    m = e / e.float().sum(3, keepdim=True).to(e.dtype)
    dp = F.pad(disp.float(), (1, 1, 1, 1))
    neighborhood = torch.stack(
        [dp[:, i: i + h, j: j + w] for i in range(3) for j in range(3)], dim=3
    )  # [B, h, w, 9]
    fine = torch.einsum("bhwn,bhwnk->bhwk", neighborhood, m.float())
    fine = fine.reshape(b, h, w, k, k).permute(0, 1, 3, 2, 4)
    return fine.reshape(b, h * k, w * k)
