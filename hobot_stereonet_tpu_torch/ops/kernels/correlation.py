"""Correlation-volume and fused soft-argmin kernels.

Counterparts of ``hobot_stereonet_tpu/ops/pallas/correlation.py``
(``correlation_volume_pallas`` and ``soft_argmin_pallas``).  The CUDA
sources are ``csrc/correlation.cu`` and ``csrc/soft_argmin.cu``; the
``*_plain`` functions are the same functions in plain PyTorch.  The
soft-argmin comes in two layouts: channel-last logits [B,H,W,D] (the
flagship's, :func:`soft_argmin_confidence`) and a D-leading cost
[B,D,H,W] (the CLASSIC StereoNet's, :func:`soft_argmin_cost`).

The three public functions are differentiable: each is a
``torch.autograd.Function`` whose backward is a kernel too
(``hst_correlation_backward``, ``hst_soft_argmin_backward``,
``hst_soft_argmin_dlead_backward``) on CUDA tensors and an explicit formula
(``*_backward_plain``) on CPU tensors.  The backward follows the
vector-Jacobian product that ``jax.vjp`` takes of the JAX package's XLA
functions (``build_correlation_volume``, ``soft_argmin``,
``disparity_confidence``), rounding where it rounds; the soft-argmin ones
on the launch :func:`soft_argmin_backward_plan` fixes.  The forwards are the
custom operators ``hst::correlation_volume``, ``hst::soft_argmin_confidence``
and ``hst::soft_argmin_cost``; the Function wraps them only where autograd
records the call, so that under ``torch.no_grad`` or
``torch.inference_mode`` (and in an exported program) the op runs alone:
the same kernel launches, the same bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import build
from .numerics import reciprocal_f32

CORRELATION = "correlation"
SOFT_ARGMIN = "soft_argmin"
SOFT_ARGMIN_COST = "soft_argmin_cost"
CORRELATION_BWD = "correlation_bwd"
SOFT_ARGMIN_BWD = "soft_argmin_bwd"
SOFT_ARGMIN_COST_BWD = "soft_argmin_cost_bwd"
SOFT_ARGMIN_VECTOR_D = 24     # D of the one-pass kernel (the flagship's coarse D)
# The D-leading soft-argmin's vector route as csrc/soft_argmin.cu fixes it:
# pixels a thread (one 4-byte bf16 or 8-byte float32 load a candidate) and
# threads a block; the scalar route's block.
SOFT_ARGMIN_COST_PIXELS = 2
SOFT_ARGMIN_COST_THREADS = 128
SOFT_ARGMIN_COST_SCALAR_THREADS = 256
# The widest band the correlation backward's tensor-core kernel takes: D + 15
# band columns in at most 4 k-steps of 16.
BWD_MAX_D = 49
_DTYPES = (torch.float32, torch.bfloat16)
_PLAIN_DTYPES = _DTYPES + (torch.float64,)    # the plain versions also take float64


def _check_features(feat_l: torch.Tensor, feat_r: torch.Tensor, dtypes=_DTYPES) -> None:
    if feat_l.shape != feat_r.shape or feat_l.dim() != 4:
        raise ValueError(
            f"{CORRELATION}: expected two [B,H,W,C] maps of one shape, got "
            f"{tuple(feat_l.shape)} and {tuple(feat_r.shape)}")
    if feat_l.dtype != feat_r.dtype or feat_l.dtype not in dtypes:
        raise TypeError(
            f"{CORRELATION}: expected float32 or bfloat16 features of one "
            f"type, got {feat_l.dtype} and {feat_r.dtype}")
    if feat_l.device != feat_r.device:
        raise ValueError(f"{CORRELATION}: features on {feat_l.device} and {feat_r.device}")


def correlation_divisor(c: int, dtype: torch.dtype) -> float:
    """``sqrt(C)`` as the reference divides by it: the float32 square root
    rounded to the features' dtype (5.65625 for C = 32 in bf16)."""
    return float(torch.tensor(math.sqrt(c), dtype=torch.float32).to(dtype))


def _correlation_plain(feat_l: torch.Tensor, feat_r: torch.Tensor, num_disparities: int,
                       round_gram) -> torch.Tensor:
    _check_features(feat_l, feat_r)
    w, c = feat_l.shape[2], feat_l.shape[3]
    dt = feat_l.dtype
    fl, fr = feat_l.float(), feat_r.float()
    divisor = correlation_divisor(c, dt)
    out = fl.new_zeros(fl.shape[:3] + (num_disparities,))
    for d in range(min(num_disparities, w)):
        gram = (fl[:, :, d:] * fr[:, :, : w - d]).sum(-1)
        out[:, :, d:, d] = round_gram(gram).float() / divisor
    return out.to(dt)


def correlation_volume_plain(feat_l: torch.Tensor, feat_r: torch.Tensor,
                             num_disparities: int) -> torch.Tensor:
    """[B,H,W,C] x2 -> [B,H,W,D] with ``out[..., x, d] = <fl[x], fr[x-d]> / sqrt(C)``,
    zero where ``x < d``.

    Rounds as ``build_correlation_volume`` in the JAX package does: the
    product sums in f32 and is rounded to the features' dtype, then divided
    by :func:`correlation_divisor` and rounded again.
    """
    return _correlation_plain(feat_l, feat_r, num_disparities,
                              lambda gram: gram.to(feat_l.dtype))


def correlation_gram_band(feat_l: torch.Tensor, feat_r: torch.Tensor,
                          num_disparities: int):
    """(lo, hi): bf16 volumes from :func:`correlation_volume_plain`'s
    arithmetic with each rounded Gram value moved one representable bf16
    step down and up.

    A kernel that sums the Gram value in another f32 order and then rounds
    as the reference does lands in ``[lo, hi]`` unless the sum is near zero
    (the division and the rounding after it are monotone).  One Gram step
    can become two steps of the output: the division by 5.65625 maps one
    step to 0.7 to 1.4 steps of the quotient.
    """
    if feat_l.dtype != torch.bfloat16:
        raise TypeError(f"{CORRELATION}: the Gram band is defined for bf16 features")
    return tuple(_correlation_plain(feat_l, feat_r, num_disparities,
                                    lambda gram, s=step: bf16_step(gram.bfloat16(), s))
                 for step in (-1, 1))


def _bf16_ordinal(t: torch.Tensor) -> torch.Tensor:
    """bf16 -> int32 that counts representable values (+0 and -0 are 0)."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Representable bf16 steps between two bf16 tensors, elementwise (int32;
    +0 and -0 count as one value).  The kernel checks measure with it."""
    return (_bf16_ordinal(a) - _bf16_ordinal(b)).abs()


def bf16_step(t: torch.Tensor, steps: int) -> torch.Tensor:
    """``t`` (bf16) moved ``steps`` representable values up (or down if < 0)."""
    o = _bf16_ordinal(t) + steps
    bits = torch.where(o < 0, (-o) | 0x8000, o)
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16).view(torch.bfloat16)


def correlation_volume(feat_l: torch.Tensor, feat_r: torch.Tensor,
                       num_disparities: int) -> torch.Tensor:
    """Channel-last correlation volume [B,H,W,D] in the features' dtype,
    differentiable in both maps (:func:`correlation_volume_backward`).

    CUDA tensors go through ``csrc/correlation.cu``: bf16 on the tensor
    cores (C a multiple of 16 up to 256, 16-byte aligned maps), f32 in
    full f32.  CPU tensors go through :func:`correlation_volume_plain`.
    """
    if needs_grad(feat_l, feat_r):
        return _CorrelationVolume.apply(feat_l, feat_r, num_disparities)
    return torch.ops.hst.correlation_volume(feat_l, feat_r, num_disparities)


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``: the ``autograd.Function``
    around an op runs only then, so that an exported graph holds the op itself."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class _CorrelationVolume(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat_l, feat_r, num_disparities):
        ctx.save_for_backward(feat_l, feat_r)
        return torch.ops.hst.correlation_volume(feat_l, feat_r, num_disparities)

    @staticmethod
    def backward(ctx, dcorr):
        feat_l, feat_r = ctx.saved_tensors
        dfl, dfr = correlation_volume_backward(dcorr.contiguous(), feat_l, feat_r)
        return dfl, dfr, None


@torch.library.custom_op("hst::correlation_volume", mutates_args=(), device_types="cpu")
def _correlation_op(feat_l: torch.Tensor, feat_r: torch.Tensor,
                    num_disparities: int) -> torch.Tensor:
    """``hst::correlation_volume``: the plain version on the CPU, the kernel
    on CUDA (:func:`_correlation_cuda`); no other device."""
    return correlation_volume_plain(feat_l, feat_r, num_disparities)


@_correlation_op.register_fake
def _(feat_l, feat_r, num_disparities):
    _check_features(feat_l, feat_r)
    return feat_l.new_empty(feat_l.shape[:3] + (num_disparities,))


@_correlation_op.register_kernel("cuda")
def _correlation_cuda(feat_l: torch.Tensor, feat_r: torch.Tensor,
                      num_disparities: int) -> torch.Tensor:
    _check_features(feat_l, feat_r)
    if not (feat_l.is_contiguous() and feat_r.is_contiguous()):
        raise ValueError(f"{CORRELATION}: features must be contiguous [B,H,W,C]")
    if num_disparities <= 0:
        raise ValueError(f"{CORRELATION}: num_disparities must be positive")
    b, h, w, c = feat_l.shape
    is_bf16 = feat_l.dtype == torch.bfloat16
    if is_bf16 and (c % 16 or c > 256):
        raise ValueError(f"{CORRELATION}: bf16 features need C % 16 == 0 and C <= 256 "
                         f"for the tensor-core kernel, got C = {c}")
    if is_bf16 and (feat_l.data_ptr() % 16 or feat_r.data_ptr() % 16):
        raise ValueError(f"{CORRELATION}: bf16 features must start 16-byte aligned")
    out = torch.empty((b, h, w, num_disparities), dtype=feat_l.dtype,
                      device=feat_l.device)
    err = build.library().hst_correlation(
        feat_l.data_ptr(), feat_r.data_ptr(), out.data_ptr(), b, h, w, c,
        num_disparities, correlation_divisor(c, feat_l.dtype), int(is_bf16),
        build.stream_handle(feat_l))
    build.check(CORRELATION, err)
    build.launch_counts[CORRELATION] += 1
    return out


def _check_cotangent(name: str, t, shape, dtype=None, device=None) -> None:
    """Raise unless ``t`` (None passes) has ``shape`` and, where given, ``dtype``
    and ``device``."""
    if t is None:
        return
    if (tuple(t.shape) != tuple(shape) or dtype not in (None, t.dtype)
            or device not in (None, t.device)):
        raise ValueError(f"{name}: expected a cotangent of shape {tuple(shape)} "
                         f"({dtype or 'any dtype'}, on {device or 'any device'}), got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def correlation_volume_backward_plain(dcorr: torch.Tensor, feat_l: torch.Tensor,
                                      feat_r: torch.Tensor):
    """The gradients (dfl, dfr) [B,H,W,C] of :func:`correlation_volume_plain`
    given ``dcorr`` [B,H,W,D], as explicit formulas:

      ``g[x,d] = T(dcorr[x,d] * f32(1/divisor))``, zero where ``x < d``;
      ``dfl[x] = T(sum_d g[x,d] fr[x-d])``, ``dfr[x'] = T(sum_d g[x'+d,d] fl[x'+d])``,

    with T the features' dtype and the sums in float32 in the order of d.
    That is ``jax.vjp`` of ``build_correlation_volume``: XLA divides by the
    constant divisor as a multiply by its float32 reciprocal, and the Gram
    matrix's transpose sums in float32 and rounds once.  float64 features
    (which only the plain versions take) sum in float64.
    """
    _check_features(feat_l, feat_r, _PLAIN_DTYPES)
    b, h, w, c = feat_l.shape
    d_total = dcorr.shape[-1]
    dt = feat_l.dtype
    acc = torch.promote_types(dt, torch.float32)
    _check_cotangent(CORRELATION_BWD, dcorr, (b, h, w, d_total), dt, feat_l.device)
    inv = reciprocal_f32(correlation_divisor(c, dt))
    g = (dcorr.to(acc) * inv).to(dt).to(acc)
    x = torch.arange(w, device=dcorr.device)[:, None]
    d = torch.arange(d_total, device=dcorr.device)[None]
    g = torch.where(x >= d, g, 0.0)
    fl, fr = feat_l.to(acc), feat_r.to(acc)
    dfl, dfr = torch.zeros_like(fl), torch.zeros_like(fr)
    for k in range(min(d_total, w)):
        gk = g[:, :, k:, k:k + 1]
        dfl[:, :, k:] += gk * fr[:, :, : w - k]
        dfr[:, :, : w - k] += gk * fl[:, :, k:]
    return dfl.to(dt), dfr.to(dt)


def correlation_backward_route(dtype: torch.dtype, c: int, d_total: int, *ptrs: int) -> str:
    """The kernel ``hst_correlation_backward`` is told to run, fixed before
    launch: "mma" (bf16 on the tensor cores: C % 16 == 0, C <= 256, D <=
    ``BWD_MAX_D`` and the four feature tensors' addresses ``ptrs`` 16-byte
    aligned; the C side refuses an "mma" launch that does not fit), else
    "simt" (float32 always)."""
    fits = (c % 16 == 0 and c <= 256 and d_total <= BWD_MAX_D
            and all(p % 16 == 0 for p in ptrs))
    return "mma" if dtype == torch.bfloat16 and fits else "simt"


def correlation_volume_backward(dcorr: torch.Tensor, feat_l: torch.Tensor,
                                feat_r: torch.Tensor):
    """(dfl, dfr): the backward of :func:`correlation_volume`.

    CUDA tensors go through ``hst_correlation_backward``
    (``csrc/correlation.cu``: bf16 on the tensor cores where
    :func:`correlation_backward_route` says "mma", else its SIMT kernel), CPU
    tensors through :func:`correlation_volume_backward_plain`.
    """
    if feat_l.device.type == "cpu":
        return correlation_volume_backward_plain(dcorr, feat_l, feat_r)
    _check_features(feat_l, feat_r)
    if feat_l.device.type != "cuda":
        raise ValueError(f"{CORRELATION_BWD}: unsupported device {feat_l.device}")
    b, h, w, c = feat_l.shape
    d = dcorr.shape[-1]
    _check_cotangent(CORRELATION_BWD, dcorr, (b, h, w, d), feat_l.dtype, feat_l.device)
    if not (dcorr.is_contiguous() and feat_l.is_contiguous() and feat_r.is_contiguous()):
        raise ValueError(f"{CORRELATION_BWD}: dcorr and the features must be contiguous")
    dfl, dfr = torch.empty_like(feat_l), torch.empty_like(feat_r)
    route = correlation_backward_route(feat_l.dtype, c, d, feat_l.data_ptr(), feat_r.data_ptr(),
                                       dfl.data_ptr(), dfr.data_ptr())
    err = build.library().hst_correlation_backward(
        dcorr.data_ptr(), feat_l.data_ptr(), feat_r.data_ptr(), dfl.data_ptr(), dfr.data_ptr(),
        b, h, w, c, d, reciprocal_f32(correlation_divisor(c, feat_l.dtype)),
        int(feat_l.dtype == torch.bfloat16), int(route == "mma"), build.stream_handle(feat_l))
    build.check(CORRELATION_BWD, err)
    build.launch_counts[CORRELATION_BWD] += 1
    build.route_counts[f"{CORRELATION_BWD}/{route}"] += 1
    return dfl, dfr


def _check_logits(logits: torch.Tensor, dtypes=_DTYPES) -> None:
    if logits.dim() != 4:
        raise ValueError(f"{SOFT_ARGMIN}: expected [B,H,W,D] logits, got {tuple(logits.shape)}")
    if logits.dtype not in dtypes:
        raise TypeError(f"{SOFT_ARGMIN}: expected float32 or bfloat16, got {logits.dtype}")


def soft_argmin_confidence_plain(logits: torch.Tensor, scale: float = 1.0):
    """[B,H,W,D] logits -> (disp, conf), both [B,H,W] f32 (float64 for
    float64 logits, which only this plain version takes).

    With ``p = softmax(logits)`` over D (the softmax of ``cost = -logits``):
    ``disp = scale * sum_d d * p_d`` and ``conf = max_d p_d``.
    """
    _check_logits(logits, _PLAIN_DTYPES)
    dt = torch.promote_types(logits.dtype, torch.float32)
    p = torch.softmax(logits.to(dt), dim=-1)
    d = torch.arange(logits.shape[-1], dtype=dt, device=logits.device)
    return (p * d).sum(-1) * scale, p.amax(-1)


def uses_vector_kernel(logits: torch.Tensor) -> bool:
    """Whether CUDA logits take the one-pass 16-byte-load kernel (bf16,
    D = ``SOFT_ARGMIN_VECTOR_D``, 16-byte aligned rows); others take the
    generic kernel."""
    return (logits.dtype == torch.bfloat16 and logits.shape[-1] == SOFT_ARGMIN_VECTOR_D
            and logits.data_ptr() % 16 == 0)


def _seq_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order (as the kernels sum), keepdim."""
    acc = t[..., :1]
    for j in range(1, t.shape[-1]):
        acc = acc + t[..., j:j + 1]
    return acc


def _softmax_vjp(x: torch.Tensor, gd, gc, scale: float) -> torch.Tensor:
    """d(disp, conf)/dx . (gd, gc) for ``p = softmax(x)`` over the last axis,
    ``disp = scale * sum_j j p_j``, ``conf = max_j p_j``; in x's dtype (float32
    or float64), in the order of XLA's operations (``csrc/soft_argmin.cu``
    writes the same).  ``gd`` or ``gc`` None is a zero cotangent; the max's
    n tied entries share ``gc`` equally, as ``jnp.max``'s VJP does."""
    w = torch.exp(x - x.amax(-1, keepdim=True))
    y = _seq_sum(w)
    r2 = 1.0 / (y * y)
    dx = torch.zeros_like(x)
    if gd is not None:
        ct = (gd.to(x.dtype) * scale)[..., None] * torch.arange(
            x.shape[-1], dtype=x.dtype, device=x.device)
        dx = (ct / y - _seq_sum((ct * r2) * w)) * w
    if gc is not None:
        p = w / y
        ind = (p == p.amax(-1, keepdim=True)).to(x.dtype)
        ci = (gc.to(x.dtype)[..., None] / _seq_sum(ind)) * ind
        dx = (ci / y - _seq_sum((ci * r2) * w)) * w + dx
    return dx


def soft_argmin_confidence_backward_plain(logits: torch.Tensor, gd, gc, scale: float = 1.0):
    """The gradient of :func:`soft_argmin_confidence_plain`'s (disp, conf)
    with respect to the logits [B,H,W,D], given their cotangents ``gd``,
    ``gc`` [B,H,W] (either may be None), as explicit formulas:

      ``dlogit_j = scale gd p_j (j - E[d]) + gc (p_m [j in argmax] / n - p_j p_m)``,

    computed in float32 (float64 for float64 logits) in the order in which
    XLA computes ``jax.vjp`` of ``soft_argmin`` and ``disparity_confidence``
    and rounded once to the logits' dtype.
    """
    _check_logits(logits, _PLAIN_DTYPES)
    for g in (gd, gc):
        _check_cotangent(SOFT_ARGMIN_BWD, g, logits.shape[:3])
    dt = torch.promote_types(logits.dtype, torch.float32)
    return _softmax_vjp(logits.to(dt), gd, gc, scale).to(logits.dtype)


def _soft_argmin_backward_launch(name, x, gd, gc, scale, shape, dims, plan=None):
    """Launch the backward kernel of ``name`` (SOFT_ARGMIN_BWD: channel-last
    logits, SOFT_ARGMIN_COST_BWD: a D-leading cost) on the plan
    :func:`soft_argmin_backward_plan` gives, or on ``plan``; the C side
    refuses a plan that does not fit."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the input must be contiguous")
    for g in (gd, gc):
        _check_cotangent(name, g, shape, torch.float32, x.device)
    grads = [None if g is None else g.contiguous() for g in (gd, gc)]
    b, d, plane = dims
    layout = CHANNEL_LAST if name == SOFT_ARGMIN_BWD else D_LEADING
    if plan is None:
        plan = soft_argmin_backward_plan(layout, b, d, plane, x.data_ptr(), x.element_size(),
                                         gc is not None)
    dx = torch.empty_like(x)
    fn = "hst_soft_argmin_backward" if layout == CHANNEL_LAST else "hst_soft_argmin_dlead_backward"
    err = getattr(build.library(), fn)(
        x.data_ptr(), *(0 if g is None else g.data_ptr() for g in grads), dx.data_ptr(), b, d,
        plane, float(scale), int(x.dtype == torch.bfloat16), int(plan.route == "staged"),
        plan.lanes, plan.pixels, plan.threads, *plan.grid, plan.smem, build.stream_handle(x))
    build.check(name, err)
    build.launch_counts[name] += 1
    build.route_counts[f"{name}/{plan.route}"] += 1
    return dx


def soft_argmin_confidence_backward(logits: torch.Tensor, gd, gc, scale: float = 1.0):
    """The backward of :func:`soft_argmin_confidence`: CUDA tensors go
    through ``hst_soft_argmin_backward`` (``csrc/soft_argmin.cu``) on the
    route :func:`soft_argmin_backward_plan` picks, CPU tensors through
    :func:`soft_argmin_confidence_backward_plain`."""
    if logits.device.type == "cpu":
        return soft_argmin_confidence_backward_plain(logits, gd, gc, scale)
    _check_logits(logits)
    b, h, w, d = logits.shape
    return _soft_argmin_backward_launch(SOFT_ARGMIN_BWD, logits, gd, gc, scale, (b, h, w),
                                        (b, d, h * w))


class _SoftArgmin(torch.autograd.Function):
    """(disp, conf) = ``forward_fn(x, scale)``, differentiated by
    ``backward_fn(x, gd, gc, scale)`` (a cotangent not given is None)."""

    @staticmethod
    def forward(ctx, x, scale, forward_op, backward_fn):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x)
        ctx.scale, ctx.backward_fn = scale, backward_fn
        return forward_op(x, scale)

    @staticmethod
    def backward(ctx, gd, gc):
        (x,) = ctx.saved_tensors
        dx = None if gd is None and gc is None else ctx.backward_fn(x, gd, gc, ctx.scale)
        return dx, None, None, None


def soft_argmin_confidence(logits: torch.Tensor, scale: float = 1.0):
    """Fused soft-argmin disparity x ``scale`` and peak-probability
    confidence, differentiable in the logits
    (:func:`soft_argmin_confidence_backward`).

    CUDA tensors go through ``csrc/soft_argmin.cu`` (its D = 24 bf16 kernel
    where :func:`uses_vector_kernel`, else its generic kernel); CPU tensors
    through :func:`soft_argmin_confidence_plain`.
    """
    op = torch.ops.hst.soft_argmin_confidence
    if needs_grad(logits):
        return _SoftArgmin.apply(logits, float(scale), op, soft_argmin_confidence_backward)
    return op(logits, float(scale))


def _fake_disp_conf(x: torch.Tensor, spatial):
    disp = x.new_empty(spatial, dtype=torch.promote_types(x.dtype, torch.float32))
    return disp, torch.empty_like(disp)


@torch.library.custom_op("hst::soft_argmin_confidence", mutates_args=(), device_types="cpu")
def _soft_argmin_op(logits: torch.Tensor, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``hst::soft_argmin_confidence``: the plain version on the CPU, the
    kernel on CUDA (:func:`_soft_argmin_cuda`)."""
    return soft_argmin_confidence_plain(logits, scale)


@_soft_argmin_op.register_fake
def _(logits, scale):
    _check_logits(logits, _PLAIN_DTYPES)
    return _fake_disp_conf(logits, logits.shape[:3])


@_soft_argmin_op.register_kernel("cuda")
def _soft_argmin_cuda(logits: torch.Tensor, scale: float):
    _check_logits(logits)
    if not logits.is_contiguous():
        raise ValueError(f"{SOFT_ARGMIN}: logits must be contiguous [B,H,W,D]")
    b, h, w, d = logits.shape
    disp = torch.empty((b, h, w), dtype=torch.float32, device=logits.device)
    conf = torch.empty_like(disp)
    err = build.library().hst_soft_argmin(
        logits.data_ptr(), disp.data_ptr(), conf.data_ptr(), b * h * w, d,
        float(scale), int(logits.dtype == torch.bfloat16),
        int(uses_vector_kernel(logits)), build.stream_handle(logits))
    build.check(SOFT_ARGMIN, err)
    build.launch_counts[SOFT_ARGMIN] += 1
    return disp, conf


def _check_cost(cost: torch.Tensor, dtypes=_DTYPES) -> None:
    if cost.dim() != 4:
        raise ValueError(f"{SOFT_ARGMIN_COST}: expected a [B,D,H,W] cost, got {tuple(cost.shape)}")
    if cost.dtype not in dtypes:
        raise TypeError(f"{SOFT_ARGMIN_COST}: expected float32 or bfloat16, got {cost.dtype}")


def soft_argmin_cost_plain(cost: torch.Tensor, scale: float = 1.0):
    """[B,D,H,W] cost -> (disp, conf), both [B,H,W] f32 (float64 for a
    float64 cost): the softmax of ``-cost`` over D,
    ``disp = scale * sum_d d * p_d``, ``conf = max_d p_d``."""
    _check_cost(cost, _PLAIN_DTYPES)
    return soft_argmin_confidence_plain(-cost.movedim(1, -1), scale)


def soft_argmin_cost_backward_plain(cost: torch.Tensor, gd, gc, scale: float = 1.0):
    """The gradient of :func:`soft_argmin_cost_plain`'s (disp, conf) with
    respect to the cost [B,D,H,W]: :func:`soft_argmin_confidence_backward_plain`'s
    formula on ``logits = -cost``, negated, rounded once to the cost's dtype."""
    _check_cost(cost, _PLAIN_DTYPES)
    for g in (gd, gc):
        _check_cotangent(SOFT_ARGMIN_COST_BWD, g, cost.shape[:1] + cost.shape[2:])
    dt = torch.promote_types(cost.dtype, torch.float32)
    dx = _softmax_vjp(-cost.to(dt).movedim(1, -1), gd, gc, scale)
    return (-dx).movedim(-1, 1).to(cost.dtype)


def soft_argmin_cost_backward(cost: torch.Tensor, gd, gc, scale: float = 1.0):
    """The backward of :func:`soft_argmin_cost`: CUDA tensors go through
    ``hst_soft_argmin_dlead_backward`` (``csrc/soft_argmin.cu``), which reads
    and writes the cost's D planes where they lie, on the route
    :func:`soft_argmin_backward_plan` picks; CPU tensors through
    :func:`soft_argmin_cost_backward_plain`."""
    if cost.device.type == "cpu":
        return soft_argmin_cost_backward_plain(cost, gd, gc, scale)
    _check_cost(cost)
    b, d, h, w = cost.shape
    return _soft_argmin_backward_launch(SOFT_ARGMIN_COST_BWD, cost, gd, gc, scale, (b, h, w),
                                        (b, d, h * w))


def soft_argmin_cost(cost: torch.Tensor, scale: float = 1.0):
    """Fused soft-argmin disparity x ``scale`` and peak-probability
    confidence of a D-leading cost [B,D,H,W] (lower is better),
    differentiable in the cost (:func:`soft_argmin_cost_backward`).

    CUDA tensors go through ``csrc/soft_argmin.cu``'s D-leading kernels,
    which read the cost where it lies (it must be contiguous), on the route
    :func:`soft_argmin_cost_plan` picks; CPU tensors through
    :func:`soft_argmin_cost_plain`.
    """
    op = torch.ops.hst.soft_argmin_cost
    if needs_grad(cost):
        return _SoftArgmin.apply(cost, float(scale), op, soft_argmin_cost_backward)
    return op(cost, float(scale))


@torch.library.custom_op("hst::soft_argmin_cost", mutates_args=(), device_types="cpu")
def _soft_argmin_cost_op(cost: torch.Tensor, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``hst::soft_argmin_cost``: the plain version on the CPU, the
    D-leading kernel on CUDA (:func:`_soft_argmin_cost_cuda`)."""
    return soft_argmin_cost_plain(cost, scale)


@_soft_argmin_cost_op.register_fake
def _(cost, scale):
    _check_cost(cost, _PLAIN_DTYPES)
    return _fake_disp_conf(cost, cost.shape[:1] + cost.shape[2:])


@_soft_argmin_cost_op.register_kernel("cuda")
def _soft_argmin_cost_cuda(cost: torch.Tensor, scale: float):
    _check_cost(cost)
    if not cost.is_contiguous():
        raise ValueError(f"{SOFT_ARGMIN_COST}: the cost must be contiguous [B,D,H,W]")
    b, d, h, w = cost.shape
    plan = soft_argmin_cost_plan(b, d, h * w, cost.data_ptr(), cost.element_size())
    return _soft_argmin_cost_launch(cost, scale, plan.route)


def _soft_argmin_cost_launch(cost: torch.Tensor, scale: float, route: str):
    """Launch ``route`` ("vector" or "scalar"); the C side refuses a vector
    launch that does not fit."""
    b, d, h, w = cost.shape
    disp = torch.empty((b, h, w), dtype=torch.float32, device=cost.device)
    conf = torch.empty_like(disp)
    err = build.library().hst_soft_argmin_dlead(
        cost.data_ptr(), disp.data_ptr(), conf.data_ptr(), b, d, h * w, float(scale),
        int(cost.dtype == torch.bfloat16), int(route == "vector"), build.stream_handle(cost))
    build.check(SOFT_ARGMIN_COST, err)
    build.launch_counts[SOFT_ARGMIN_COST] += 1
    build.route_counts[f"{SOFT_ARGMIN_COST}/{route}"] += 1
    return disp, conf


class CostPlan(NamedTuple):
    """A launch of ``hst_soft_argmin_dlead``."""
    route: str           # "vector" or "scalar"
    pixels: int          # adjacent pixels a thread (1 on the scalar route)
    threads: int         # threads a block
    grid: tuple          # (blocks along a plane, B)


def soft_argmin_cost_plan(b: int, d: int, plane: int, ptr: int, itemsize: int) -> CostPlan:
    """The route of the D-leading soft-argmin for a contiguous cost [b, d,
    plane] of ``itemsize``-byte values at address ``ptr``, fixed by the
    shape and the address before launch.

    The vector route (``SOFT_ARGMIN_COST_PIXELS`` adjacent pixels a thread,
    one load of them a candidate) needs d == ``SOFT_ARGMIN_VECTOR_D``, plane
    % pixels == 0 and ``ptr`` aligned to pixels * itemsize bytes; anything
    else takes the scalar route, one pixel a thread.  Either grid's second
    dimension is the batch.
    """
    p, t = SOFT_ARGMIN_COST_PIXELS, SOFT_ARGMIN_COST_THREADS
    if d == SOFT_ARGMIN_VECTOR_D and plane % p == 0 and ptr % (p * itemsize) == 0:
        return CostPlan("vector", p, t, (-(-plane // (p * t)), b))
    t = SOFT_ARGMIN_COST_SCALAR_THREADS
    return CostPlan("scalar", 1, t, (-(-plane // t), b))


CHANNEL_LAST, D_LEADING = "channel_last", "d_leading"
# The backward kernels' staged route as csrc/soft_argmin.cu compiles it: lanes a
# pixel, the most threads a block and the largest D-leading tile it takes.  The
# plan gives a block BWD_BLOCK_THREADS threads and a pixel the fewest lanes (two
# at least with a confidence cotangent) whose threads reach BWD_FILL (two
# 128-thread blocks on each of an H100's 132 multiprocessors):
# scripts/torch_cost_kernels_ab.py --sweep measured these.
BWD_LANES = (1, 2, 4, 8)
BWD_MAX_THREADS = 256
BWD_DLEAD_MAX_TILE = 64
BWD_TILES = (256, 128, 64, 32, 16, 8, 4)
BWD_BLOCK_THREADS = 64
BWD_FILL = 132 * 256


class BackwardPlan(NamedTuple):
    """A launch of ``hst_soft_argmin_backward`` or ``hst_soft_argmin_dlead_backward``."""
    route: str           # "staged" or "scalar"
    lanes: int           # L: lanes a pixel (1 on the scalar route)
    threads: int         # threads a block: pixels * lanes
    pixels: int          # T: pixels a tile (a block)
    grid: tuple          # channel-last (tiles, 1); D-leading (tiles along a plane, B)
    smem: int            # dynamic shared-memory bytes


def bwd_lanes(n: int, has_gc: bool) -> int:
    """L for ``n`` pixels: the fewest lanes a pixel whose threads, n * L, reach
    ``BWD_FILL`` (every lane beyond one repeats the ordered sums' steps); at
    least two with a confidence cotangent, whose terms at one lane a pixel
    take 110 registers (and half the occupancy) against 48 at two."""
    return next((lanes for lanes in BWD_LANES[int(has_gc):] if n * lanes >= BWD_FILL),
                BWD_LANES[-1])


def _bwd_tile_fits(layout: str, plane: int, itemsize: int, lanes: int, t: int) -> bool:
    threads = t * lanes
    fits = lanes in BWD_LANES and t > 0 and threads % 32 == 0 and threads <= BWD_MAX_THREADS
    if layout == D_LEADING:          # whole 16-byte rows of a plane, no tile across samples
        fits = (fits and t <= BWD_DLEAD_MAX_TILE and t & (t - 1) == 0 and plane % t == 0
                and (t * itemsize) % 16 == 0)
    return fits


def soft_argmin_backward_plan(layout: str, b: int, d: int, plane: int, ptr: int, itemsize: int,
                              has_gc: bool, lanes: int | None = None,
                              pixels: int | None = None) -> BackwardPlan:
    """The launch of a soft-argmin backward kernel, fixed by the shape and the
    input's address before launch.

    ``layout`` is ``CHANNEL_LAST`` (logits [b, plane, d]) or ``D_LEADING``
    (a cost [b, d, plane]); ``ptr`` the input's address, ``itemsize`` its
    element's bytes; ``has_gc`` whether a confidence cotangent comes.  The
    staged route needs d == ``SOFT_ARGMIN_VECTOR_D``, a 16-byte aligned
    input and a tile: L lanes a pixel (:func:`bwd_lanes`, or ``lanes``) and
    the largest tile T of ``BWD_TILES`` (or ``pixels``) with T * L threads a
    multiple of 32 up to ``BWD_BLOCK_THREADS``; D-leading, T must also be a
    power of two up to ``BWD_DLEAD_MAX_TILE`` that divides the plane in whole
    16-byte rows.  Anything else takes the scalar route, one thread a pixel
    at 256 a block.  Raises ValueError where an explicit ``lanes`` or
    ``pixels`` does not fit.
    """
    if layout not in (CHANNEL_LAST, D_LEADING):
        raise ValueError(f"unknown layout {layout!r}")
    n = b * plane
    if d == SOFT_ARGMIN_VECTOR_D and ptr % 16 == 0:
        lanes_ = lanes or bwd_lanes(n, has_gc)
        tiles = (pixels,) if pixels else [t for t in BWD_TILES if t * lanes_ <= BWD_BLOCK_THREADS]
        t = next((t for t in tiles if _bwd_tile_fits(layout, plane, itemsize, lanes_, t)), None)
        if t and layout == CHANNEL_LAST:
            return BackwardPlan("staged", lanes_, t * lanes_, t, (-(-n // t), 1),
                                t * d * itemsize)
        if t:
            return BackwardPlan("staged", lanes_, t * lanes_, t, (plane // t, b),
                                d * (BWD_DLEAD_MAX_TILE + 16 // itemsize) * itemsize)
    if lanes or pixels:
        raise ValueError(f"no staged launch of L = {lanes}, T = {pixels} fits {layout} "
                         f"[{b}, {d}, {plane}] at {ptr:#x}")
    t = SOFT_ARGMIN_COST_SCALAR_THREADS
    if layout == CHANNEL_LAST:
        return BackwardPlan("scalar", 1, t, t, (-(-n // t), 1), 0)
    return BackwardPlan("scalar", 1, t, t, (-(-plane // t), b), 0)
