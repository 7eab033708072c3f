"""The training loop on procedural scenes.

Counterpart of ``hobot_stereonet_tpu/runtime/train_loop.py``: the same
arguments, defaults, batches and recipe, on ``cuda:0`` unless ``device``
says otherwise.  Batches leave the host as uint8 and are cast on the
device: RGB, or YUV (BT.601, clipped to [0, 255]), then ``(x - 128) / 128``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..config import StereoNetConfig, resolve_device
from ..models import build_model, model_name
from ..ops import colorspace as cs
from ..ops.kernels.numerics import fma_f32
from . import checkpoint as ckpt
from . import training
from .weights import from_flax_params


def to_model_input(u8: torch.Tensor, color_space: str = "rgb") -> torch.Tensor:
    """uint8 [B,H,W,3] RGB -> the network's float32 input, on u8's device.

    The YUV conversion (``ops/colorspace.rgb_to_yuv``'s BT.601) is written
    as XLA compiles the reference's jitted step, with its fused
    multiply-adds: ``y = fma(Kb, b, fma(Kr, r, Kg g))``,
    ``u = fma(b - y, Us, 128)``, ``v = fma(r - y, Vs, 128)``; so the input
    is the reference's bit for bit."""
    x = u8.float()
    if color_space == "yuv":
        r, g, b = x.unbind(-1)
        y = fma_f32(cs._KB, b, fma_f32(cs._KR, r, g * cs._KG))
        x = torch.stack([y, fma_f32(b - y, cs._U_SCALE, 128.0),
                         fma_f32(r - y, cs._V_SCALE, 128.0)], -1)
        x = torch.clamp(x, 0.0, 255.0)
    return (x - 128.0) / 128.0


def train_synthetic(steps: int = 100, batch_size: int = 4, crop_hw=(128, 256),
                    checkpoint_dir: Optional[str] = None, log_every: int = 20,
                    lr: float = 1e-3, seed: int = 0, model=None, dataset=None,
                    eval_every: int = 0, resume_from: Optional[str] = None,
                    save_every: int = 500, model_cfg: Optional[StereoNetConfig] = None,
                    color_space: str = "rgb", device=None) -> Dict:
    """Train a network (default ``FastStereoNet``; ``model`` may be
    ``"fast"``, ``"classic"`` or a built network) on procedural scenes
    rendered at twice ``crop_hw``; returns the final metrics, ``steps_per_sec``
    and the logged history.

    The weights start from ``init_params`` drawn from ``torch.Generator``
    seeded with ``seed`` or, with ``resume_from``, from that checkpoint's
    weights with a fresh optimizer and schedule.  The state is saved to
    ``checkpoint_dir`` every ``save_every`` steps and at the end.  The loop
    waits for the device on a scalar every 25 steps and where it logs.
    ``eval_every`` is accepted, as the reference's, and unused.
    """
    from ..data.loader import BatchIterator, SyntheticStereoDataset

    dev = resolve_device(device, "train_synthetic")
    cfg = model_cfg if model_cfg is not None else StereoNetConfig()
    net = build_model("fast" if model is None else model, cfg, dev)
    if dataset is None:
        dataset = SyntheticStereoDataset(size=512, seed=seed, height=crop_hw[0] * 2,
                                         width=crop_hw[1] * 2)
    it = iter(BatchIterator(dataset, batch_size=batch_size, crop_hw=crop_hw, seed=seed))
    optimizer = training.make_optimizer(lr=lr, warmup_steps=min(100, steps // 10 + 1),
                                        total_steps=max(steps, 2))
    next(it)            # the reference draws its init sample from the first batch
    state = training.create_train_state(net, torch.Generator().manual_seed(seed), optimizer)
    if resume_from:
        # Continue from the weights; the optimizer and schedule start afresh.
        params = ckpt.load_params(resume_from, like=net)
        net.load_state_dict(from_flax_params(params, net.cfg, model_name(net)))
    step_fn = training.make_train_step(net, optimizer, max_disparity=net.cfg.max_disparity)

    history = []
    metrics = None
    t0 = time.perf_counter()
    for i in range(steps):
        l, r, d = next(it)
        left = to_model_input(torch.from_numpy(l).to(dev), color_space)
        right = to_model_input(torch.from_numpy(r).to(dev), color_space)
        state, metrics = step_fn(state, left, right, torch.from_numpy(d).to(dev))
        if (i + 1) % 25 == 0:
            float(metrics["loss"])          # bound the work queued ahead of the device
        if log_every and (i + 1) % log_every == 0:
            loss, epe = float(metrics["loss"]), float(metrics["epe"])
            history.append({"step": i + 1, "loss": loss, "epe": epe})
            print(f"step {i + 1}/{steps} loss={loss:.4f} epe={epe:.3f}px", flush=True)
        if checkpoint_dir and save_every and (i + 1) % save_every == 0 and (i + 1) < steps:
            ckpt.save_train_state(checkpoint_dir, state)
    final_loss = float(metrics["loss"]) if metrics else float("nan")
    dt = time.perf_counter() - t0
    if checkpoint_dir:
        ckpt.save_train_state(checkpoint_dir, state)
    return {
        "steps": steps,
        "final_loss": final_loss,
        "final_epe": float(metrics["epe"]) if metrics else float("nan"),
        "steps_per_sec": round(steps / dt, 3),
        "history": history,
    }

