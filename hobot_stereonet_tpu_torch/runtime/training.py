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
for all the tensors.  The sharded step (the reference's
``make_sharded_train_step``, data and tile) comes next, over the serving
mesh of ``parallel/``: it needs the halo exchange's backward and a
cross-tile GroupNorm backward.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

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
    pyramid = outputs["pyramid"]
    if valid is None:
        valid = (gt_disparity > 0) & (gt_disparity < max_disparity)
    valid = valid.float()
    if level_weights is None:
        level_weights = tuple(0.5 ** (len(pyramid) - 1 - i) for i in range(len(pyramid)))
    total = 0.0
    for w_lvl, pred in zip(level_weights, pyramid):
        h, w = pred.shape[1], pred.shape[2]
        gt_s = _downsample_disparity(gt_disparity, h, w)
        v_s = (_downsample_disparity(valid, h, w) > 0.5).float()
        err = smooth_l1(pred.float() - gt_s)
        total = total + w_lvl * torch.sum(err * v_s) / torch.clamp(torch.sum(v_s), min=1.0)
    final = pyramid[-1].float()
    epe = torch.sum(torch.abs(final - gt_disparity) * valid) / torch.clamp(torch.sum(valid),
                                                                           min=1.0)
    return total, {"loss": total, "epe": epe}


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
