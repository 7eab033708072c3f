"""w8a8 int8 inference: every conv of the network as an s8 x s8 -> s32 conv.

Counterpart of ``hobot_stereonet_tpu/ops/quant.py``.  Weights are
quantized symmetrically per output channel, activations per sample, and
every ``SameConv2d`` runs as :class:`Int8Conv2d` (the kernel of
``ops/kernels/int8_conv.py``); GroupNorm, the activations, the
correlation and the soft-argmin stay in floating point.

Two schemes, as in the JAX package:

  * dynamic (``quantize_model(model)``): each conv takes its input's scale
    per sample at run time, ``max|x| / 127``;
  * static (``quantize_model(model, calib)``): each conv has a calibrated
    input scale, ``calib[flax path]`` (``checkpoints/flagship/calib.json``);
    a conv missing from the calibration runs the dynamic scheme.

flax swaps the conv at apply time (``nn.intercept_methods``); the port
swaps the modules once.  Keys are flax module paths, the port's submodule
names with ``.`` -> ``/`` (``FeatureTower_0/ConvBlock_0/Conv_0``).

The arithmetic is the JAX package's as XLA compiles it (bit for bit on
the CPU, ``tests/test_torch_quant.py``).  XLA turns a division by a
constant into a multiplication by the constant's float32 reciprocal and
fuses a multiply followed by an add (``ops/kernels/numerics.py``).  So:

  * a scale ``max / 127`` computed inside the compiled program (the
    dynamic scheme: activations and weights) is ``max * float32(1/127)``;
    the static scheme's weights are quantized op by op when JAX bakes
    them (``bake_weights``), a true division by 127;
  * the dynamic scheme quantizes with a true division by the run-time
    scale, the static scheme multiplies by ``float32(1 / s_x)``;
  * the epilogue is ``fma(float(acc), s_x * s_k, bias)``, rounded once to
    the compute dtype.

The model input reaches the first conv unrounded: the conv quantizes its
argument as it comes, before any cast to the compute dtype, as flax's
interceptor does.  Per-sample scales and the kernel's fixed order of
summation make a frame's result independent of the batch it is in.
"""

from __future__ import annotations

import collections
import json
from typing import Iterable, Mapping, Optional

import torch
import torch.nn as nn

from ..models.layers import SameConv2d, cast_convs
from .kernels import int8_conv as k8
from .kernels.numerics import reciprocal_f32

QMAX = 127.0
MIN_SCALE = 1e-12
# What XLA multiplies by for "/ 127" inside a compiled program.
INV_QMAX = reciprocal_f32(QMAX)

# The dynamic scheme's max reductions on CUDA tensors, one per conv call (a
# torch call, not a kernel of the port): ``amax_calls["cuda"]``.
amax_calls: "collections.Counter[str]" = collections.Counter()


def _scale(amax: torch.Tensor, baked: bool) -> torch.Tensor:
    s = amax.float() / QMAX if baked else amax.float() * INV_QMAX
    return torch.clamp(s, min=MIN_SCALE)


def quantize_weight(weight: torch.Tensor, baked: bool = False):
    """Per-output-channel symmetric int8 of a float32 conv weight [Cout, Cin, kh, kw].

    Returns ``(q int8 [Cout, Cin, kh, kw], s float32 [Cout])`` with
    ``s = max(max|w| / 127, 1e-12)`` and ``q = clip(round(w / s), +-127)``.
    ``baked=False``: as the dynamic scheme quantizes inside its compiled
    program (``max|w| * float32(1/127)``); ``baked=True``: as ``bake_weights``
    does for the static scheme (a true division)."""
    if weight.dtype != torch.float32:
        raise TypeError(f"quantize the float32 weights, got {weight.dtype}")
    s = _scale(weight.abs().amax(dim=(1, 2, 3)), baked)
    q = torch.clamp(torch.round(weight / s.view(-1, 1, 1, 1)), -QMAX, QMAX)
    return q.to(torch.int8), s


def activation_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-sample scale of an activation [N, ...]: ``max(max|x| / 127, 1e-12)``,
    float32 [N], as the dynamic scheme computes it."""
    amax = torch.linalg.vector_norm(x, float("inf"), dim=tuple(range(1, x.dim())))
    if x.device.type == "cuda":
        amax_calls["cuda"] += 1
    return _scale(amax, baked=False)


def quantize_activation(x: torch.Tensor):
    """Per-sample dynamic symmetric int8: ``(q int8, s float32 [N])`` with
    ``q = clip(round(x / s[n]), +-127)`` (a true division)."""
    s = activation_scale(x)
    q = torch.clamp(torch.round(x.float() / s.view(-1, *([1] * (x.dim() - 1)))), -QMAX, QMAX)
    return q.to(torch.int8), s


class Int8Conv2d(nn.Module):
    """A ``SameConv2d`` run as a w8a8 conv, with its int8 weights quantized
    once from the float32 ones.

    ``act_scale`` is the calibrated input scale of the static scheme,
    rounded once to float32; ``None`` selects the dynamic scheme.  The
    output has ``out_dtype`` (the compute dtype) in channels-last memory.
    """

    def __init__(self, conv: SameConv2d, out_dtype: torch.dtype,
                 act_scale: Optional[float] = None):
        super().__init__()
        q, s = quantize_weight(conv.weight.detach(), baked=act_scale is not None)
        self.stride = conv.stride[0]
        self.out_dtype = out_dtype
        self.register_buffer("q_weight", q)
        self.register_buffer("packed_weight", k8.pack_weight(q))
        self.register_buffer("weight_scale", s)
        self.register_buffer("bias", conv.bias.detach().float().clone())
        self.static = act_scale is not None
        if self.static:
            s_x = float(torch.tensor(act_scale, dtype=torch.float32))
            dev = q.device
            self.register_buffer("act_scale", torch.tensor([s_x], device=dev))
            self.register_buffer("act_mult", torch.tensor([reciprocal_f32(s_x)], device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last)
        if self.static:
            sx, qs = self.act_scale, self.act_mult
        else:
            sx = qs = activation_scale(x)
        return k8.int8_conv(x, self.q_weight, self.packed_weight, self.weight_scale, self.bias,
                            sx, qs, stride=self.stride, divide=not self.static,
                            out_dtype=self.out_dtype)


def unsupported_convs(model: nn.Module) -> list:
    """The convs of ``model`` that :class:`Int8Conv2d` does not run, as
    ``"path: what"`` strings: 3-D convs and dilated convs.  (On the card
    the kernel also needs Cin = 3 or a multiple of 8 and Cout a multiple
    of 8; ``int8_conv`` raises at the call.)"""
    out = []
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv3d):
            out.append(f"{name}: 3-D {'x'.join(map(str, m.kernel_size))}")
        elif isinstance(m, nn.Conv2d) and m.dilation != (1, 1):
            out.append(f"{name}: dilation {m.dilation[0]}")
    return out


def quantize_model(model: nn.Module, calib: "Mapping[str, float] | str | None" = None
                   ) -> nn.Module:
    """Swap every ``SameConv2d`` of ``model`` for an :class:`Int8Conv2d`, in place.

    The convs must still hold their float32 weights (call this before
    ``cast_convs``).  ``calib`` (a dict or a ``calib.json`` path) selects
    the static scheme for the convs it names; the rest run the dynamic
    scheme.  The output dtype is ``model.cfg.compute_dtype``.  Returns the
    model.  Raises ``NotImplementedError`` if the model has a conv that
    the int8 kernel does not take (:func:`unsupported_convs`).
    """
    missing = unsupported_convs(model)
    if missing:
        raise NotImplementedError(
            "not served in int8 by the port yet: the int8 conv kernel takes 2-D undilated "
            f"convs, and this model also has {missing}")
    if isinstance(calib, str):
        calib = load_calibration(calib)
    calib = calib or {}
    out_dtype = model.cfg.compute_dtype
    for name, m in list(model.named_modules()):
        if isinstance(m, SameConv2d):
            parent, _, leaf = name.rpartition(".")
            owner = model.get_submodule(parent) if parent else model
            setattr(owner, leaf, Int8Conv2d(m, out_dtype, calib.get(name.replace(".", "/"))))
    return model


@torch.inference_mode()
def calibrate_activation_scales(model: nn.Module, batches: Iterable) -> dict:
    """One pass of the float ``model`` over calibration inputs -> ``{conv path: act scale}``.

    ``batches`` yields the model's positional arguments (``(left, right)``).
    Records the max |input| of each conv over all batches (as the conv
    receives it, before its cast) and returns ``max(amax, 1e-12) / 127``
    in Python floats, as the JAX package's does."""
    amax: dict = {}

    def hook(key):
        def rec(_mod, args):
            m = float(args[0].float().abs().max())
            amax[key] = max(amax.get(key, 0.0), m)
        return rec

    handles = [m.register_forward_pre_hook(hook(name.replace(".", "/")))
               for name, m in model.named_modules() if isinstance(m, SameConv2d)]
    try:
        for batch in batches:
            model(*batch)
    finally:
        for h in handles:
            h.remove()
    return {k: max(v, MIN_SCALE) / QMAX for k, v in amax.items()}


def save_calibration(path: str, calib: Mapping[str, float]) -> None:
    with open(path, "w") as f:
        json.dump({k: float(v) for k, v in calib.items()}, f, indent=1, sort_keys=True)


def load_calibration(path: str) -> dict:
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f).items()}


def make_static_quant(model: nn.Module, calib: "Mapping[str, float] | str") -> nn.Module:
    """The static scheme from a calibration dict or ``calib.json`` path:
    :func:`quantize_model` with ``calib``.  (The JAX package's returns the
    calibration and the baked int8 weights; here the weights are baked
    into the swapped modules.)"""
    return quantize_model(model, calib)


def serving_model(model: nn.Module, int8: bool = False,
                  static_quant: "Mapping[str, float] | str | None" = None) -> nn.Module:
    """A model with float32 weights, made ready to serve in ``eval`` mode:
    w8a8 with ``static_quant`` (the static scheme; a dict or ``calib.json``
    path) or ``int8`` (the dynamic scheme), as the JAX package's
    ``make_apply_fn`` selects; then every float conv cast to the compute
    dtype (``cast_convs``)."""
    if int8 or static_quant is not None:
        quantize_model(model, static_quant)
    return cast_convs(model, model.cfg.compute_dtype).eval()
