"""Training: the multiscale disparity loss, the optimizer and the train step.

Counterpart of ``hobot_stereonet_tpu/runtime/training.py``: smooth-L1 over
the coarse-to-fine pyramid, optax's ``clip_by_global_norm(1.0)`` then
``adamw`` on a warmup-cosine schedule, and a step that returns the loss,
the EPE and the gradient's global norm before clipping.

Where the reference's optax differs from PyTorch's own optimizers, the port
follows optax:

  * the clip scales by ``1 / ||g||`` when ``||g|| >= 1`` (not by
    ``1 / (||g|| + 1e-6)`` as ``torch.nn.utils.clip_grad_norm_``);
  * AdamW decays every parameter, GroupNorm's and the biases too;
  * the schedule is evaluated at the step count before the update, so the
    first step has learning rate 0.

The optimizer updates the parameters and its moments in place (JAX returns
new arrays), with ``torch._foreach_*`` operations: a few launches a step
for all the tensors.

:func:`make_sharded_train_step` is the reference's step over a (data, tile)
mesh (``parallel/mesh.py``), SPMD: each rank runs it on its shard (its data
slice of the batch, and with ``tile_rows`` its tile's rows), the forward
row-tiled (``parallel/tiling.py``) with a differentiable halo exchange and
GroupNorm, the loss over the global batch's valid pixels, and the
gradients summed over the mesh in rank order before one optimizer update
on every rank, which leaves the replicated parameters and moments
bit-equal on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import mesh as mesh_mod, tiling
from ..parallel.collectives import all_gather_cat, sum_in_rank_order
from ..parallel.halo import memory_format
from ..utils.precision import exact_float32


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _downsample_disparity(gt: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H, W] -> [B, h, w]: a bilinear resize of positions (values stay
    in full-resolution pixels).  ``jax.image.resize(..., "bilinear")``
    antialiases when it shrinks: its triangle kernel widens by the scale,
    which is ``F.interpolate``'s ``antialias=True``."""
    if gt.shape[1] == h and gt.shape[2] == w:
        return gt
    return F.interpolate(gt[:, None], size=(h, w), mode="bilinear", antialias=True,
                         align_corners=False)[:, 0]


def multiscale_loss(outputs: Dict, gt_disparity: torch.Tensor,
                    valid: Optional[torch.Tensor] = None, max_disparity: float = 192.0,
                    level_weights: Optional[Sequence[float]] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Smooth-L1 supervision over every level of ``outputs["pyramid"]``.

    ``valid`` masks pixels (default ``0 < gt < max_disparity``); at each
    level the ground truth and the mask are resized to the level and the
    mask kept where it is above 0.5.  Level ``i`` of ``L`` weighs
    ``0.5 ** (L - 1 - i)``.  Returns (loss, {"loss", "epe"}), the EPE at
    full resolution over the valid pixels.
    """
    total, epe = _loss_terms(outputs["pyramid"], gt_disparity, valid, max_disparity,
                             level_weights)
    return total, {"loss": total, "epe": epe}


def _loss_terms(pyramid, gt: torch.Tensor, valid: Optional[torch.Tensor],
                max_disparity: float, level_weights: Optional[Sequence[float]],
                tiles=None, total_counts: Optional[Callable] = None):
    """(loss, epe) of :func:`multiscale_loss`.  On a mesh: ``tiles`` (the
    forward's ``RowTiles``, or None) makes ``gt`` and ``valid`` this tile's
    rows, resized to each level as whole images (gathered over the tile
    group) and cut back to the tile's rows; ``total_counts`` maps this
    rank's valid-pixel counts (float32 [levels + 1]) to the global batch's,
    so that the ranks' losses add up to the global one."""
    gt_img, valid_img = gt, valid
    if tiles is not None:
        gt_img = tiles.gather(gt, 1)
        valid_img = None if valid is None else tiles.gather(valid.float(), 1)
    if valid_img is None:
        valid_img = (gt_img > 0) & (gt_img < max_disparity)
    valid_img = valid_img.float()
    if level_weights is None:
        level_weights = tuple(0.5 ** (len(pyramid) - 1 - i) for i in range(len(pyramid)))

    def rows(img, h, w):            # img resized to a level, this tile's rows of it
        if tiles is None:
            return _downsample_disparity(img, h, w)
        starts, counts, total = tiles.layout(h)
        i = tiles.index
        return _downsample_disparity(img, total, w)[:, starts[i]:starts[i] + counts[i]]

    nums, counts = [], []
    for pred in pyramid:
        h, w = pred.shape[1], pred.shape[2]
        gt_s = rows(gt_img, h, w)
        v_s = (rows(valid_img, h, w) > 0.5).float()
        nums.append(torch.sum(smooth_l1(pred.float() - gt_s) * v_s))
        counts.append(torch.sum(v_s))
    final = pyramid[-1].float()
    v = rows(valid_img, *final.shape[1:])
    nums.append(torch.sum(torch.abs(final - rows(gt_img, *final.shape[1:])) * v))
    counts.append(torch.sum(v))
    if total_counts is not None:
        counts = list(total_counts(torch.stack(counts)))
    total = 0.0
    for w_lvl, num, count in zip(level_weights, nums[:-1], counts[:-1]):
        total = total + w_lvl * num / torch.clamp(count, min=1.0)
    return total, nums[-1] / torch.clamp(counts[-1], min=1.0)


# optax.adamw's defaults, which the reference keeps.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class Optimizer:
    """optax's ``chain(clip_by_global_norm(1.0), adamw(schedule,
    weight_decay))`` with ``warmup_cosine_decay_schedule(0, lr, warmup_steps,
    total_steps)``: :func:`make_optimizer` builds it.  The state is
    ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``."""

    lr: float
    weight_decay: float
    warmup_steps: int
    total_steps: int

    def schedule(self, count: int) -> float:
        """The learning rate at step count ``count``, in float32 as optax
        computes it: linear from 0 over the warmup, then a cosine to 0."""
        f = np.float32
        warm, decay = self.warmup_steps, self.total_steps - self.warmup_steps
        lr = f(self.lr)
        if count < warm:
            frac = f(1) - f(min(max(count, 0), warm)) / f(warm)
            return float(-lr * frac + lr)
        c = f(min(count - warm, decay))
        cosine = f(0.5) * (f(1) + np.cos(f(math.pi) * c / f(decay)))
        return float(lr * cosine)

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: dict) -> Tuple[dict, torch.Tensor]:
        """One update of ``params`` (in place) from ``grads``; returns (the
        next state, the gradients' global norm before clipping, a 0-d tensor
        on their device).  Nothing waits for the device."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        # clip: t when ||g|| < 1, else t / ||g|| (times 1).
        g = torch._foreach_div(g, torch.where(norm < 1.0, torch.ones_like(norm), norm))
        count = state["count"] + 1
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
        f = np.float32
        bc1 = float(f(1) - f(ADAM_B1) ** f(count))
        bc2 = float(f(1) - f(ADAM_B2) ** f(count))
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.schedule(state["count"]))
        torch._foreach_add_(p, upd)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}, norm


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-4, warmup_steps: int = 500,
                   total_steps: int = 100_000) -> Optimizer:
    return Optimizer(lr, weight_decay, warmup_steps, max(total_steps, warmup_steps + 1))


@dataclass
class TrainState:
    """``params``: the network's parameters by ``state_dict`` name (the
    module's own tensors, updated in place); ``opt_state``: the optimizer's;
    ``step``: steps taken."""

    params: Dict[str, torch.Tensor]
    opt_state: dict
    step: int


def create_train_state(model: nn.Module, generator: Optional[torch.Generator],
                       optimizer: Optimizer) -> TrainState:
    """Fresh weights for ``model`` from ``generator``
    (:func:`~.weights.init_params`) and a fresh optimizer state."""
    from .weights import init_params

    model.load_state_dict(init_params(model.cfg, model, generator))
    params = dict(model.named_parameters())
    return TrainState(params, optimizer.init(params), 0)


def make_train_step(model: nn.Module, optimizer: Optimizer,
                    max_disparity: float = 192.0) -> Callable:
    """``step(state, left, right, gt, valid=None) -> (state, metrics)``:
    forward, :func:`multiscale_loss`, backward and one optimizer update.
    ``metrics`` holds 0-d tensors on the device: ``loss``, ``epe`` and
    ``grad_norm`` (before clipping).  A float32 model on CUDA runs its
    forward and backward without TF32 (:mod:`..utils.precision`).  Raises
    if a parameter got no gradient."""

    def step(state: TrainState, left, right, gt, valid=None):
        for p in state.params.values():
            p.grad = None
        with exact_float32(model.cfg.compute_dtype, left.device):    # the backward too
            out = model(left, right)
            loss, metrics = multiscale_loss(out, gt, valid, max_disparity)
            loss.backward()
        grads = {k: p.grad for k, p in state.params.items()}
        missing = [k for k, g in grads.items() if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        opt_state, norm = optimizer.step(state.params, grads, state.opt_state)
        metrics = {"loss": loss.detach(), "epe": metrics["epe"].detach(), "grad_norm": norm}
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return step


def _memory_order(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as a 1-D view in memory order (``t`` contiguous in
    its memory format, as a parameter's gradient is)."""
    if not t.is_contiguous(memory_format=memory_format(t)):
        raise ValueError(f"a gradient of strides {t.stride()} is not dense")
    return t.as_strided((t.numel(),), (1,))


def make_sharded_train_step(model: nn.Module, optimizer: Optimizer, mesh,
                            max_disparity: float = 192.0, tile_rows: bool = True) -> Callable:
    """:func:`make_train_step` over a (data, tile) ``mesh`` (a ``DeviceMesh``
    from ``parallel.mesh.make_mesh``): ``step(state, left, right, gt,
    valid=None) -> (state, metrics)``, called by every rank of the mesh on
    its own shard (``parallel.mesh.shard_batch(mesh, x, tile_rows, factor=2^K)``:
    its data slice of the batch and, with ``tile_rows``, its tile's rows at
    full resolution, split at 1/2^K).

    Each rank runs the forward on its shard, row-tiled when the mesh has
    more than one tile (the halo exchange and the GroupNorm's statistics
    over the tile group, both differentiable), and the loss of
    :func:`multiscale_loss` over its rows with the valid-pixel counts of the
    global batch, so that the ranks' losses add up to the global loss.
    After the backward the gradients, as one flat buffer, are summed over
    the mesh: gathered over the tile group and added in float64 in rank
    order, then the same over the data group, and rounded once, so that
    every rank holds the same bits.  The optimizer then makes the same
    update on every rank; ``metrics`` (``loss``, ``epe``, ``grad_norm``) are
    the global ones, the same on every rank.  With ``tile_rows=False`` the
    ranks of a tile group each run the whole rows of their data slice and
    take tile rank 0's sums.

    The replicated state: call ``parallel.mesh.replicate(mesh, state.params)``
    once before the first step (every rank then holds the mesh's first
    rank's weights) on a fresh or equal optimizer state; the step keeps the
    parameters and the moments bit-equal on every rank.  The step refuses a
    tile count that the images' rows at 1/2^K cannot take, and shards of a
    batch that does not split over ``data``."""
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not on the mesh")
    mc = mesh_mod.mesh_config(mesh)
    tile_group = mesh.get_group(mesh_mod.TILE_AXIS)
    data_group = mesh.get_group(mesh_mod.DATA_AXIS)
    factor = model.cfg.cost_resolution_divisor
    layouts: Dict[tuple, Optional[tiling.RowTiles]] = {}

    def mesh_sum(t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the mesh in rank order (float64): over the tile
        group (without ``tile_rows``: tile rank 0's), then the data group."""
        t = sum_in_rank_order(t, tile_group) if tile_rows else \
            all_gather_cat(t[None], tile_group)[0].double()
        return sum_in_rank_order(t, data_group)

    def tiles_for(left: torch.Tensor) -> Optional[tiling.RowTiles]:
        key = tuple(left.shape)
        if key not in layouts:
            shape = torch.tensor(left.shape[:2], dtype=torch.int64, device=left.device)
            rows = all_gather_cat(shape[None], tile_group)[:, 1].tolist()
            batches = all_gather_cat(shape[None], data_group)[:, 0].tolist()
            if len(set(batches)) > 1:
                raise ValueError(f"a batch of {sum(batches)} does not split over "
                                 f"data={mc.data}")
            tiles = None
            if tile_rows and mc.tile > 1:
                tiles = tiling.RowTiles(sum(rows), factor, tile_group)
                mine = tiles.full_rows()
                if mine.stop - mine.start != left.shape[1]:
                    raise ValueError(f"a shard of {left.shape[1]} rows is not this rank's "
                                     f"tile {mine.start}:{mine.stop} of {sum(rows)} split at "
                                     f"1/{factor} (parallel.mesh.shard_batch(..., "
                                     f"factor={factor}))")
            layouts[key] = tiles
        return layouts[key]

    def step(state: TrainState, left, right, gt, valid=None):
        tiles = tiles_for(left)
        for p in state.params.values():
            p.grad = None
        with exact_float32(model.cfg.compute_dtype, left.device):    # the backward too
            with tiling.row_tiles(tiles):
                out = model(left, right)
            loss, epe = _loss_terms(out["pyramid"], gt, valid, max_disparity, None, tiles,
                                    lambda c: mesh_sum(c).to(c.dtype))
            loss.backward()
        grads = {k: p.grad for k, p in state.params.items()}
        missing = [k for k, g in grads.items() if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        views = [_memory_order(g) for g in grads.values()]    # the same on every rank
        flat = mesh_sum(torch.cat(views)).to(views[0].dtype)
        torch._foreach_copy_(views, list(flat.split([v.numel() for v in views])))
        opt_state, norm = optimizer.step(state.params, grads, state.opt_state)
        both = mesh_sum(torch.stack([loss.detach(), epe.detach()])).to(loss.dtype)
        metrics = {"loss": both[0], "epe": both[1], "grad_norm": norm}
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return step
