"""w8a8 int8 inference: every conv of the network as an s8 x s8 -> s32 conv.

Counterpart of ``hobot_stereonet_tpu/ops/quant.py``.  Weights are
quantized symmetrically per output channel, activations per sample, and
every ``SameConv2d`` and ``SameConv3d`` runs as :class:`Int8Conv`: on the
card through the kernel of ``ops/kernels/int8_conv.py`` where it takes the
conv's shape (zero padded to its channels where needed: every conv of both
networks, CLASSIC's 3-D and dilated ones included), else through the
exact library product of ``ops/int8_gemm.py``;
GroupNorm, the activations, the correlation and the soft-argmin stay in
floating point.

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

Under row tiling (``parallel/tiling.py``) a conv runs its route on its
tile extended by the rows its taps reach and crops the output back, as the
float convs do (``models/layers.py``); the dynamic scheme's per-sample max
is taken over the whole image, an all-reduce (max) over the tile group.
Static scales are the same on every rank already.

A conv quantizes its argument as it comes, as flax's interceptor does;
the networks cast the feature tower's and each refinement's input to the
compute dtype first, as the flax modules do.  Per-sample scales and fixed
orders of summation make a frame's result independent of the batch it is
in.
"""

from __future__ import annotations

import collections
import json
from typing import Iterable, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import SameConv2d, SameConv3d, cast_convs
from ..parallel import tiling
from . import int8_gemm
from .kernels import int8_conv as k8
from .kernels.numerics import reciprocal_f32

CONVS = (SameConv2d, SameConv3d)
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
    """Per-output-channel symmetric int8 of a float32 conv weight [Cout, Cin, *kernel].

    Returns ``(q int8 [Cout, Cin, *kernel], s float32 [Cout])`` with
    ``s = max(max|w| / 127, 1e-12)`` and ``q = clip(round(w / s), +-127)``.
    ``baked=False``: as the dynamic scheme quantizes inside its compiled
    program (``max|w| * float32(1/127)``); ``baked=True``: as ``bake_weights``
    does for the static scheme (a true division)."""
    if weight.dtype != torch.float32:
        raise TypeError(f"quantize the float32 weights, got {weight.dtype}")
    s = _scale(weight.abs().amax(dim=tuple(range(1, weight.dim()))), baked)
    q = torch.clamp(torch.round(weight / s.view(-1, *([1] * (weight.dim() - 1)))), -QMAX, QMAX)
    return q.to(torch.int8), s


def activation_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-sample scale of an activation [N, ...]: ``max(max|x| / 127, 1e-12)``,
    float32 [N], as the dynamic scheme computes it; of a row tile, the max
    over the tile group's rows (the whole image's)."""
    amax = torch.linalg.vector_norm(x, float("inf"), dim=tuple(range(1, x.dim())))
    if x.device.type == "cuda":
        amax_calls["cuda"] += 1
    tiles = tiling.active()
    if tiles is not None:
        amax = tiles.all_max(amax)
    return _scale(amax, baked=False)


def quantize_activation(x: torch.Tensor):
    """Per-sample dynamic symmetric int8: ``(q int8, s float32 [N])`` with
    ``q = clip(round(x / s[n]), +-127)`` (a true division)."""
    s = activation_scale(x)
    q = torch.clamp(torch.round(x.float() / s.view(-1, *([1] * (x.dim() - 1)))), -QMAX, QMAX)
    return q.to(torch.int8), s


class Int8Conv(nn.Module):
    """A ``SameConv2d`` or ``SameConv3d`` run as a w8a8 conv, with its int8
    weights quantized once from the float32 ones.

    ``act_scale`` is the calibrated input scale of the static scheme,
    rounded once to float32; ``None`` selects the dynamic scheme.  The
    output has ``out_dtype`` (the compute dtype) in channels-last memory.

    The route on the card is fixed here, by shape: the int8 conv kernel
    (``route == "kernel"``) for every conv it takes
    (:func:`~.kernels.int8_conv.kernel_takes`), zero padded to the channels
    it takes where needed (:func:`~.kernels.int8_conv.padded_channels`:
    CLASSIC's Cout 1 and 12 and Cin 12), else the exact library product of
    ``ops/int8_gemm.py`` (``"library"``: a shape neither network has).  A
    shape routed to the kernel that it cannot plan raises; nothing falls
    back.  On the CPU both are the kernel's plain version.
    """

    def __init__(self, conv: "SameConv2d | SameConv3d", out_dtype: torch.dtype,
                 act_scale: Optional[float] = None):
        super().__init__()
        q, s = quantize_weight(conv.weight.detach(), baked=act_scale is not None)
        self.stride = conv.stride[0]
        self.dilation = conv.dilation[0]
        self.out_dtype = out_dtype
        cout, cin = q.shape[:2]
        # what the kernel runs at
        self.channels = k8.padded_channels(cin, cout, q.shape[2:], self.dilation)
        # The networks hand each conv its input in the compute dtype.
        self.route = "kernel" if k8.kernel_takes(*self.channels, q.shape[2:], self.stride,
                                                 self.dilation, out_dtype) else "library"
        bias = conv.bias.detach().float().clone()
        self.register_buffer("q_weight", q)
        self.register_buffer("weight_scale", s)
        self.register_buffer("bias", bias)
        if self.route == "kernel":
            # The weights, scales and biases the kernel runs, zero padded.
            pc, po = self.channels[0] - cin, self.channels[1] - cout
            q = F.pad(q, (0, 0) * (q.dim() - 2) + (0, pc, 0, po))
            self.register_buffer("card_weight", q)
            self.register_buffer("card_scale", F.pad(s, (0, po)))
            self.register_buffer("card_bias", F.pad(bias, (0, po)))
            self.register_buffer("packed_weight", k8.pack_weight(q))
        else:
            self.register_buffer("packed_weight", int8_gemm.gemm_weight(q))
        self.static = act_scale is not None
        if self.static:
            s_x = float(torch.tensor(act_scale, dtype=torch.float32))
            dev = q.device
            self.register_buffer("act_scale", torch.tensor([s_x], device=dev))
            self.register_buffer("act_mult", torch.tensor([reciprocal_f32(s_x)], device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=k8.memory_format(x.dim()))
        if self.static:
            sx, qs = self.act_scale, self.act_mult
        else:
            sx = qs = activation_scale(x)
        tiles = tiling.active()
        if tiles is not None:                  # rows: dim 2 of NCHW, 3 of NCDHW
            kernel = self.q_weight.shape[x.dim() - 2]
            return tiles.conv(lambda t: self._conv(t, sx, qs), x, x.dim() - 2, kernel,
                              self.stride, self.dilation)
        return self._conv(x, sx, qs)

    def _conv(self, x: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=k8.memory_format(x.dim()))
        if x.device.type == "cpu":
            return k8.int8_conv(x, self.q_weight, self.packed_weight, self.weight_scale,
                                self.bias, sx, qs, stride=self.stride, divide=not self.static,
                                out_dtype=self.out_dtype, dilation=self.dilation)
        return self.on_card(x, sx, qs, divide=not self.static)

    def on_card(self, x: torch.Tensor, sx: torch.Tensor, qs: torch.Tensor, *,
                divide: bool) -> torch.Tensor:
        """The conv of a channels-last tensor through its card route, with
        the input scales ``sx`` and ``qs`` (:func:`~.kernels.int8_conv.int8_conv`'s);
        on a CPU tensor the kernels' wrappers run their plain versions."""
        kw = dict(stride=self.stride, divide=divide, out_dtype=self.out_dtype)
        if self.route == "library":
            return int8_gemm.int8_conv_im2col(x, self.q_weight, self.packed_weight,
                                              self.weight_scale, self.bias, sx, qs,
                                              dilation=self.dilation, **kw)
        cin, cout = x.shape[1], self.q_weight.shape[0]
        if self.channels[0] != cin:                         # zero input channels
            padded = x.new_zeros((x.shape[0], *x.shape[2:], self.channels[0])).movedim(-1, 1)
            padded[:, :cin] = x
            x = padded
        y = k8.int8_conv(x, self.card_weight, self.packed_weight, self.card_scale,
                         self.card_bias, sx, qs, dilation=self.dilation, **kw)
        if self.channels[1] != cout:                        # drop the padded outputs
            y = y[:, :cout].contiguous(memory_format=k8.memory_format(y.dim()))
        return y


def quantize_model(model: nn.Module, calib: "Mapping[str, float] | str | None" = None
                   ) -> nn.Module:
    """Swap every ``SameConv2d`` and ``SameConv3d`` of ``model`` for an
    :class:`Int8Conv`, in place.

    The convs must still hold their float32 weights (call this before
    ``cast_convs``).  ``calib`` (a dict or a ``calib.json`` path) selects
    the static scheme for the convs it names; the rest run the dynamic
    scheme.  The output dtype is ``model.cfg.compute_dtype``.  Returns the
    model.
    """
    if isinstance(calib, str):
        calib = load_calibration(calib)
    calib = calib or {}
    out_dtype = model.cfg.compute_dtype
    for name, m in list(model.named_modules()):
        if isinstance(m, CONVS):
            parent, _, leaf = name.rpartition(".")
            owner = model.get_submodule(parent) if parent else model
            setattr(owner, leaf, Int8Conv(m, out_dtype, calib.get(name.replace(".", "/"))))
    return model


def routes(model: nn.Module) -> dict:
    """``{conv path: "kernel" | "library"}`` of a quantized model's convs."""
    return {name.replace(".", "/"): m.route for name, m in model.named_modules()
            if isinstance(m, Int8Conv)}


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
               for name, m in model.named_modules() if isinstance(m, CONVS)]
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
