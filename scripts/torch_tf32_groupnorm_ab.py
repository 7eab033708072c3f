#!/usr/bin/env python3
"""One-time measurements of the PyTorch port on one NVIDIA GPU: float32 with
TF32 on against off, and the training step with the port's GroupNorm
against ATen's.

    python3 scripts/torch_tf32_groupnorm_ab.py [--turns 4] [--log DIR]

TF32.  The package turns TF32 off wherever a network computes in float32 on
the card (``utils/precision.py``).  "on" replaces that guard with a no-op
and leaves TF32 as PyTorch defaults it (cuDNN on, matmul off), as the
package ran before the guard.  On and off: the CLASSIC StereoNet in float32
on the two 256x512 held-out scenes against the stored JAX float32 output
(max |error|), its held-out EPE over the 120 scenes, and one float32 train
step of each network from its committed weights against JAX's stored step
(loss, the farthest gradient in relative L2, gradients beyond 1e-3).

GroupNorm.  The flagship's device step (batch 8 of 128x256 crops, bf16, one
batch kept on the card) with the port's GroupNorm and with ATen's
``F.group_norm`` on float32 casts with the bias add, the residual add and
LeakyReLU as separate ops (as the port ran them before its kernel),
in turns (port, ATen, ATen, port, ...): steps/s over 10 steps; the device
time of one profiled step of each; and one residual block's GroupNorm at
that step's shape ([16, 32, 16, 32] bf16, with the conv bias, the skip and
LeakyReLU), forward and forward + backward: the host's time
to issue a call (200 calls, no synchronization between them) and its
device time (``torch.profiler``, 20 calls).

Prints one JSON object a line, the card's name and power limit first.
Imports torch, numpy and the port.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hobot_stereonet_tpu_torch import reference  # noqa: E402
from hobot_stereonet_tpu_torch.config import Config, StereoNetConfig  # noqa: E402
from hobot_stereonet_tpu_torch.data.loader import (BatchIterator,  # noqa: E402
                                                   SyntheticStereoDataset)
from hobot_stereonet_tpu_torch.models import StereoNet, build_model  # noqa: E402
from hobot_stereonet_tpu_torch.models.layers import GroupNorm, leaky_relu  # noqa: E402
from hobot_stereonet_tpu_torch.ops import preprocess as pp  # noqa: E402
from hobot_stereonet_tpu_torch.runtime import training  # noqa: E402
from hobot_stereonet_tpu_torch.runtime.evaluate import evaluate_dataset  # noqa: E402
from hobot_stereonet_tpu_torch.runtime.train_loop import to_model_input  # noqa: E402
from hobot_stereonet_tpu_torch.runtime.weights import (_flatten, _unwrap,  # noqa: E402
                                                       from_flax_params, to_flax_params)
from hobot_stereonet_tpu_torch.utils import precision  # noqa: E402
from hobot_stereonet_tpu_torch.utils.profiling import device_trace  # noqa: E402

DEV = torch.device("cuda:0")
CROP, BATCH = (128, 256), 8


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 as PyTorch defaults it, the package's guard a no-op (``on``);
    else the package as shipped."""
    saved = (precision.float32_exact, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if on:
        precision.float32_exact = contextlib.nullcontext
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        (precision.float32_exact, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _aten_forward(self, x, conv_bias=None, skip=None, activate=False):
    """The blocks' GroupNorm as ATen and separate ops compute it: the bias
    add, ``F.group_norm`` on float32 casts, the residual add, LeakyReLU."""
    if conv_bias is not None:
        x = x + conv_bias.to(x.dtype).view((1, -1) + (1,) * (x.dim() - 2))
    r = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps).to(x.dtype)
    r = r if skip is None else skip + r
    return leaky_relu(r) if activate else r


@contextlib.contextmanager
def aten_group_norm(on: bool):
    """``GroupNorm.forward`` as ATen and separate ops (``on``)."""
    saved = GroupNorm.forward
    if on:
        GroupNorm.forward = _aten_forward
    try:
        yield
    finally:
        GroupNorm.forward = saved


def device_ms(prof) -> float:
    return sum(a.device_time_total for a in prof.key_averages()
               if str(getattr(a, "device_type", "")).endswith("CUDA")) / 1e3


def classic_f32(heldout) -> dict:
    params = reference.load_params(reference.CLASSIC_PARAMS_NPZ)
    stored = reference.load_outputs(reference.CLASSIC_OUTPUTS_NPZ)
    mcfg = StereoNetConfig(compute_dtype=torch.float32)
    net = StereoNet(mcfg, device=DEV)
    net.load_state_dict(from_flax_params(params, mcfg, "classic"))
    net.eval()
    rgb = Config().preprocess
    scenes = [heldout[i] for i in reference.SCENES]
    x = torch.cat([pp.rgb_pair_to_model_input(s.left, s.right, rgb, DEV) for s in scenes])
    with torch.inference_mode():
        d = net(*pp.split_model_input(x))["disparity"].cpu().numpy()
    cfg = dataclasses.replace(Config(), model=dataclasses.replace(
        Config().model, compute_dtype=torch.float32))
    res = evaluate_dataset("classic", params, heldout, cfg, device=DEV)
    return dict(scenes_max_abs_err_px=float(np.abs(d - stored["f32_disparity"]).max()),
                heldout_epe_px=res.epe, per_frame_epe=np.asarray(res.per_frame_epe))


def train_step_f32(model: str) -> dict:
    stored = reference.load_train_step(model)
    cfg = StereoNetConfig(compute_dtype=torch.float32)
    net = build_model(model, cfg, DEV)
    npz = reference.PARAMS_NPZ if model == "fast" else reference.CLASSIC_PARAMS_NPZ
    net.load_state_dict(from_flax_params(reference.load_params(npz), cfg, model))
    opt = training.make_optimizer()
    params = dict(net.named_parameters())
    state = training.TrainState(params, opt.init(params), 0)
    left, right = (to_model_input(torch.from_numpy(stored[k]).to(DEV), str(stored["color_space"]))
                   for k in ("left_u8", "right_u8"))
    _, m = training.make_train_step(net, opt, cfg.max_disparity)(
        state, left, right, torch.from_numpy(stored["disparity"]).to(DEV))
    flat = {"/".join(k): v for k, v in _flatten(_unwrap(to_flax_params(
        {k: p.grad for k, p in params.items()})))}
    want = stored["f32"]
    errs = reference.grad_mismatches(flat, want["grads"], 0.0)
    worst = max(errs, key=lambda e: e[1]) if errs else ("", 0.0)
    return dict(loss=float(m["loss"]), jax_loss=float(want["loss"]),
                farthest_gradient=worst[0], farthest_relative_l2=worst[1],
                beyond_1e3=sum(e[1] > reference.TRAIN_F32_GRAD_RTOL for e in errs),
                gradients=len(flat))


def group_norm_ab(turns: int, log: Path) -> None:
    cfg = Config.from_json(str(ROOT / "checkpoints" / "flagship" / "config.json"))
    scenes = SyntheticStereoDataset(size=64, seed=0, height=2 * CROP[0], width=2 * CROP[1])
    l8, r8, d8 = next(iter(BatchIterator(scenes, BATCH, CROP, seed=1)))
    left, right = (to_model_input(torch.from_numpy(a).to(DEV), cfg.preprocess.color_space)
                   for a in (l8, r8))
    gt = torch.from_numpy(d8).to(DEV)
    net = build_model("fast", cfg.model, DEV)
    opt = training.make_optimizer(lr=1e-3, warmup_steps=4, total_steps=1000)
    state = training.create_train_state(net, torch.Generator().manual_seed(1), opt)
    step = training.make_train_step(net, opt, cfg.model.max_disparity)
    for aten in (False, True):
        with aten_group_norm(aten):
            for _ in range(3):
                state, m = step(state, left, right, gt)
    torch.cuda.synchronize()

    rates = {"port": [], "ATen": []}
    for i in range(turns):
        label = "ATen" if i % 4 in (1, 2) else "port"
        with aten_group_norm(label == "ATen"):
            t0 = time.perf_counter()
            for _ in range(10):
                state, m = step(state, left, right, gt)
            float(m["loss"])
            rates[label].append(10 / (time.perf_counter() - t0))
    step_ms = {}
    for label in ("port", "ATen"):
        with aten_group_norm(label == "ATen"), device_trace(str(log / f"step_{label}")) as prof:
            state, m = step(state, left, right, gt)
            float(m["loss"])
        step_ms[label] = device_ms(prof)
    emit(what="flagship training step, batch 8 of 128x256, bf16", steps_per_s=rates,
         device_ms_a_step=step_ms)

    gn = GroupNorm(32).to(DEV)
    x = torch.randn((2 * BATCH, 32) + tuple(c // 8 for c in CROP), device=DEV).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    dy = torch.randn_like(x)
    cb, sk = torch.randn(32, device=DEV), torch.randn_like(x).detach()
    kw = dict(conv_bias=cb, skip=sk, activate=True)
    for label in ("port", "ATen"):
        out = {}
        with aten_group_norm(label == "ATen"):
            for what, fn in (("forward", lambda: gn(x.detach(), **kw)),
                             ("forward+backward", lambda: gn(x, **kw).backward(dy))):
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                issue_us = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
                with device_trace(str(log / f"gn_{label}_{what}")) as prof:
                    for _ in range(20):
                        fn()
                    torch.cuda.synchronize()
                out[what] = dict(host_issue_us=issue_us, device_us=device_ms(prof) / 20 * 1e3)
        emit(what=f"one ResBlock GroupNorm (bias, skip, LeakyReLU) [16, 32, 16, 32] bf16, "
                  f"{label}", **out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--log", default=str(ROOT / "build" / "ab_profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    emit(card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True).stdout.strip())
    group_norm_ab(args.turns, Path(args.log))
    heldout = reference.heldout_dataset()
    for on in (True, False):
        with tf32(on):
            c = classic_f32(heldout)
            pf = c.pop("per_frame_epe")
            steps = {model: train_step_f32(model) for model in ("fast", "classic")}
        emit(tf32="on" if on else "off", classic_f32=c, train_step_f32=steps)
        if on:
            pf_on = pf
    emit(classic_f32_heldout_max_per_scene_diff_px=float(np.abs(pf_on - pf).max()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
