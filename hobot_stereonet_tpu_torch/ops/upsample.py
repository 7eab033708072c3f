"""Learned convex upsampling (RAFT-style).

Counterpart of ``convex_upsample`` in ``hobot_stereonet_tpu/ops/upsample.py``.
It has no Pallas kernel there and stays plain PyTorch here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
