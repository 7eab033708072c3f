"""Resolution changes: fixed 2x stencils and learned convex upsampling.

Counterparts of ``hobot_stereonet_tpu/ops/upsample.py``, on the same
channel-last [B, H, W, C] layout.  None has a Pallas kernel there, and all
stay plain PyTorch here.  ``upsample_bilinear`` takes power-of-two factors
by the 2x stencils and any other by :func:`resize_bilinear`, the
semantics of the reference's ``jax.image.resize(..., "bilinear")``
fallback (used by no model).

Under row tiling (``parallel/tiling.py``) the 2x stencil and the convex
upsampling read their neighbour rows from the halo exchange: the stencil's
edge-replicated, the convex upsampling's zero at the image's edge.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import tiling


def _stencil2x(x: torch.Tensor, dim: int) -> torch.Tensor:
    """2x half-pixel bilinear along ``dim`` (1 or 2) of [B, H, W, C], edges
    repeated: out[2i] = 0.25 x[i-1] + 0.75 x[i], out[2i+1] = 0.75 x[i] + 0.25 x[i+1].
    Rows of a row tile take their neighbours from the tiles beside it."""
    n = x.shape[dim]
    tiles = tiling.active() if dim == 1 else None
    if tiles is not None:
        ext = tiles.exchange(x, 1, 1, dim, edge="replicate")
        prev, nxt = ext.narrow(dim, 0, n), ext.narrow(dim, 2, n)
    else:
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
    """[B, H, W, C] -> [B, h, w, C]: 2x stencils while both sides can double,
    then :func:`resize_bilinear` to what is left (the reference's order)."""
    while x.shape[1] * 2 <= h and x.shape[2] * 2 <= w:
        x = upsample2x_bilinear(x)
    if x.shape[1] != h or x.shape[2] != w:
        x = resize_bilinear(x, h, w)
    return x


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 weights of ``jax.image.resize``'s bilinear
    (``compute_weight_mat`` with the triangle kernel, antialiased): sample
    points at half-pixel centres, the kernel widened by the factor when
    shrinking, each column's weights divided by their sum (the taps outside
    the input dropped), columns whose point lies outside the input zero."""
    inv = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)   # Python floats, as JAX
    kscale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kscale
    wts = torch.clamp(1.0 - dist, min=0.0)
    total = wts.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    wts = torch.where(total.abs() > eps, wts / torch.where(total != 0, total, 1.0),
                      torch.zeros(()))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros(())).to(device)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C] as ``jax.image.resize(x, ..., "bilinear")``
    computes it (antialiased when shrinking), one weight matrix an axis, in
    float32 for float32 input (``x``'s dtype otherwise).  An axis whose size
    does not change is left as it is."""
    dt = x.dtype if x.is_floating_point() else torch.float32
    out = x.to(dt)
    if x.shape[1] != h:
        out = torch.einsum("bhwc,hk->bkwc", out, _resize_weights(x.shape[1], h, x.device).to(dt))
    if x.shape[2] != w:
        out = torch.einsum("bhwc,wk->bhkc", out, _resize_weights(x.shape[2], w, x.device).to(dt))
    return out


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
    tiles = tiling.active()
    if tiles is not None:                   # the rows beside the tile, zero at the edge
        dp = F.pad(tiles.exchange(disp.float(), 1, 1, 1), (1, 1))
    else:
        dp = F.pad(disp.float(), (1, 1, 1, 1))
    neighborhood = torch.stack(
        [dp[:, i: i + h, j: j + w] for i in range(3) for j in range(3)], dim=3
    )  # [B, h, w, 9]
    fine = torch.einsum("bhwn,bhwnk->bhwk", neighborhood, m.float())
    fine = fine.reshape(b, h, w, k, k).permute(0, 1, 3, 2, 4)
    return fine.reshape(b, h * k, w * k)
