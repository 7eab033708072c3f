"""Feature detection, description and matching with static shapes: the
port of ``hobot_stereonet_tpu/slam/features.py``.

A dense Harris response, 3x3 non-maximum suppression, a fixed number K of
keypoints (padded keypoints carry ``valid = False``), edge-padded
normalized patch descriptors, and matching as one descriptor matrix
product (``torch.matmul``) with mutual-nearest and ratio tests.

Ties: ``jax.lax.top_k`` orders equal values by index, lower first, and
``torch.topk`` promises no order among them.  The keypoints are therefore
taken from a stable descending sort of the response (equal responses, the
suppressed ``-inf`` ones above all, keep their raster order), which is
``lax.top_k``'s order.  ``argmax`` returns the first maximum in both
frameworks.  The ratio test reads only the two largest values, whose
order ties do not change.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .se3 import f32_matmuls


class Keypoints(NamedTuple):
    xy: torch.Tensor      # [K, 2] float32 (x, y) pixel coords
    score: torch.Tensor   # [K] Harris response
    desc: torch.Tensor    # [K, D] L2-normalized descriptors
    valid: torch.Tensor   # [K] bool


def _gray(img: torch.Tensor) -> torch.Tensor:
    if img.dim() == 3 and img.shape[-1] == 3:
        img = img.float()
        return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return img.float()


def _pad_edge(x: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(x[None, None], (n, n, n, n), mode="replicate")[0, 0]


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box filter by separable shifts, edge padded."""
    xp = _pad_edge(x, 1)
    h = xp[:-2] + xp[1:-1] + xp[2:]
    v = h[:, :-2] + h[:, 1:-1] + h[:, 2:]
    return v / 9.0


def harris_response(img: torch.Tensor, k: float = 0.04) -> torch.Tensor:
    """Dense Harris corner response, [H, W]."""
    gp = _pad_edge(_gray(img), 1)
    ix = (gp[1:-1, 2:] - gp[1:-1, :-2]) * 0.5
    iy = (gp[2:, 1:-1] - gp[:-2, 1:-1]) * 0.5
    sxx, syy, sxy = _box3(ix * ix), _box3(iy * iy), _box3(ix * iy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _nms3(resp: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression mask."""
    h, w = resp.shape
    rp = F.pad(resp, (1, 1, 1, 1), value=float("-inf"))
    stack = torch.stack([rp[i:i + h, j:j + w] for i in range(3) for j in range(3)])
    return resp >= stack.amax(0)


def _patch_descriptors(g: torch.Tensor, xy: torch.Tensor, patch: int = 16) -> torch.Tensor:
    """Normalized patch descriptors [K, patch*patch] at integer coords."""
    half = patch // 2
    gp = _pad_edge(g, half)
    x, y = xy[:, 0].long(), xy[:, 1].long()
    offs = torch.arange(patch, device=g.device) - half
    rows = (y[:, None] + half + offs)[:, :, None]            # [K, patch, 1]
    cols = (x[:, None] + half + offs)[:, None, :]            # [K, 1, patch]
    d = gp[rows, cols].reshape(xy.shape[0], -1)
    d = d - d.mean(dim=1, keepdim=True)
    n = torch.linalg.vector_norm(d, dim=1, keepdim=True)
    return d / torch.clamp(n, min=1e-6)


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor, equal
    values in index order (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def detect_and_describe(img: torch.Tensor, num_keypoints: int = 512, patch: int = 16,
                        border: int = 8, min_score: float = 1e-7) -> Keypoints:
    """[H, W(, 3)] image -> K keypoints with descriptors (static K)."""
    g = _gray(img) / 255.0
    resp = harris_response(g)
    h, w = resp.shape
    neg = torch.tensor(float("-inf"), device=resp.device)
    resp = torch.where(_nms3(resp), resp, neg)
    yy = torch.arange(h, device=resp.device)[:, None]
    xx = torch.arange(w, device=resp.device)[None, :]
    in_border = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    resp = torch.where(in_border, resp, neg)
    score, idx = top_k_stable(resp.reshape(-1), num_keypoints)
    xy = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)
    return Keypoints(xy=xy, score=score, desc=_patch_descriptors(g, xy, patch),
                     valid=score > min_score)


class Matches(NamedTuple):
    idx_a: torch.Tensor   # [M] indices into keypoints A (M = K)
    idx_b: torch.Tensor   # [M] indices into keypoints B
    valid: torch.Tensor   # [M] bool: mutual nearest, ratio test, validity


@f32_matmuls
def match(a: Keypoints, b: Keypoints, ratio: float = 0.9, min_sim: float = 0.5) -> Matches:
    """Mutual-nearest-neighbour matching: similarity = desc_a @ desc_b^T
    (cosine similarity of L2-normalized descriptors)."""
    sim = torch.matmul(a.desc, b.desc.T)
    sim = torch.where(a.valid[:, None] & b.valid[None, :], sim,
                      torch.tensor(float("-inf"), device=sim.device))
    best_b = sim.argmax(dim=1)
    top2 = torch.topk(sim, 2, dim=1).values
    best_a_of_b = sim.argmax(dim=0)
    k = sim.shape[0]
    ar = torch.arange(k, device=sim.device)
    mutual = best_a_of_b[best_b] == ar
    passes_ratio = top2[:, 1] < ratio * top2[:, 0]
    strong = top2[:, 0] > min_sim
    valid = mutual & passes_ratio & strong & a.valid & b.valid[best_b]
    return Matches(idx_a=ar, idx_b=best_b, valid=valid)
