"""Channels-last GroupNorm: ATen's one-thread CPU statistics, on either device.

flax's ``GroupNorm`` (eps 1e-6, float32 statistics and parameters) has no
Pallas kernel in the JAX package: XLA fuses it.  The port computes it the
way ATen's CPU kernel does for a channels-last input at one thread
(``native_group_norm``, spatial size >= 1024), in an order that does not
depend on the thread count or the batch, so that the card and the CPU give
the same bits.  For each sample n and group g of D = C/G channels over P
spatial positions (logical (h, w) or (d, h, w) order, which is memory
order for channels-last input):

  1. per channel c, sequential float32 sums over the positions in order:
     ``s1_c += x`` and ``s2_c = fma(x, x, s2_c)``, each rounded once, as
     ATen's vectorized loop computes them (for bf16 input x * x is exact in
     float32, so ``s2_c += x * x`` is the same);
  2. ``S1``, ``S2``: the group's D channel sums added in channel order;
  3. ``s = float32(1 / float32(D * P))``, ``mean = float32(S1 * s)``;
  4. ``var = max(fma(S2, s, -float32(mean * mean)), 0)``, rounded once;
  5. ``rstd = float32(1 / sqrt(float64(var) + 1e-6))``: the add, the root
     and the division in float64, then one rounding;
  6. per channel, ``scale = float32(rstd * gamma_c)``,
     ``bias = fma(-scale, mean, beta_c)`` and ``y = fma(x, scale, bias)``,
     rounded to the input's dtype.

Each (sample, channel) sum is one dependent chain, so the result of a
sample does not depend on the batch it is in.  The CUDA source is
``csrc/group_norm.cu``; :func:`group_norm_plain` is the same function in
plain PyTorch and numpy.  :func:`group_norm` is differentiable: its
backward is ATen's ``native_group_norm_backward`` on the float32 input
with the forward's statistics, the backward ``F.group_norm`` runs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import build
from .numerics import fma_f32

NAME = "group_norm"
DTYPES = (torch.bfloat16, torch.float32)


def _memory_format(x: torch.Tensor):
    return torch.channels_last_3d if x.dim() == 5 else torch.channels_last


def _check(x: torch.Tensor, num_groups: int, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"{NAME}: expected bfloat16 or float32 input, got {x.dtype}")
    if x.dim() not in (4, 5):
        raise ValueError(f"{NAME}: expected NCHW or NCDHW input, got {tuple(x.shape)}")
    c = x.shape[1]
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"{NAME}: {num_groups} groups do not divide {c} channels")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != (c,):
            raise ValueError(f"{NAME}: {name} must be float32 [{c}], got {t.dtype} "
                             f"{tuple(t.shape)}")


def add_f32(y: np.ndarray, s: np.ndarray) -> np.ndarray:
    """float32(y + s) rounded once, for float64 ``y`` and float32 values
    ``s`` (as float64) whose exact sum float64 may not hold."""
    t = y + s
    r = t.astype(np.float32)
    # Rounding t again to float32 can differ from rounding the exact sum
    # once only where t lies half-way between two float32 values.
    tie = (t.view(np.int64) & 0x1FFFFFFF) == 0x10000000
    if tie.any():
        i = np.nonzero(tie)
        yi, si, ti = y[i], s[i], t[i]
        bv = ti - yi
        err = (yi - (ti - bv)) + (si - bv)       # exact (y + s) - t (TwoSum)
        lo = np.nextafter(r[i], np.float32(-np.inf))
        lo = np.where(r[i].astype(np.float64) < ti, r[i], lo)
        hi = np.nextafter(lo, np.float32(np.inf))
        r[i] = np.where(err > 0, hi, np.where(err < 0, lo, r[i]))
    return r


_FMA_BLOCK = 2048                # positions a chain takes per vectorized pass


def _spacing(s: np.ndarray):
    """For float32 values ``s`` >= 0 (as float64): (u, top), the spacing of
    float32 values from ``s`` up and the start of the next binade, where the
    spacing doubles (2^-149 and 2^-126 below the normal range)."""
    _, e = np.frexp(s)                           # s in [2^(e-1), 2^e)
    tiny = s < 2.0 ** -126
    return (np.where(tiny, 2.0 ** -149, np.ldexp(1.0, e - 24)),
            np.where(tiny, 2.0 ** -126, np.ldexp(1.0, e)))


def _fma_square_sums(a: np.ndarray) -> np.ndarray:
    """float32 [N, C]: the sequential chains ``s = fma(x, x, s)`` over axis 1
    of float32 ``a`` [N, P, C], each step rounded once to float32.

    While a chain's sum stays in one binade of spacing u, each step adds
    ``x * x`` rounded to a multiple of u (the squares are exact in float64),
    so a run of steps is one exact float64 cumsum.  A chain leaves that
    vectorized run at a step whose rounding could differ (its sum reaches the
    next binade, or the square lies half-way between two multiples of u),
    takes that step with :func:`add_f32`, and goes on from there.
    """
    n, p, c = a.shape
    m = n * c
    s = np.zeros(m, np.float64)
    done = ~np.isfinite(a).all(axis=1).reshape(m)    # NaN or inf: sums of them
    if done.any():
        y = np.square(a.astype(np.float64)).transpose(1, 0, 2).reshape(p, m)
        s[done] = y[:, done].sum(0)
    cols = np.arange(m)
    with np.errstate(over="ignore", invalid="ignore"):
        for p0 in range(0, p, _FMA_BLOCK):
            y = np.square(a[:, p0:p0 + _FMA_BLOCK].astype(np.float64))
            k = y.shape[1]
            y = y.transpose(1, 0, 2).reshape(k, m)
            before = np.arange(k)[:, None]
            start = np.where(done, k, 0)             # each chain's next step
            while True:
                live = (start < k) & np.isfinite(s)
                if not live.any():
                    break
                u, top = _spacing(s)
                q = y / u                            # exact: u is a power of 2
                whole = np.floor(q)
                frac = q - whole
                r = (whole + (frac > 0.5)) * u
                skip = before < start
                r[skip] = 0.0
                run = s + np.cumsum(r, axis=0)       # exact below top
                stop_at = (run >= top) | (frac == 0.5)
                stop_at[skip] = False
                stop = np.where(stop_at.any(0), stop_at.argmax(0), k)
                ran = live & (stop > start)
                s[ran] = run[stop[ran] - 1, cols[ran]]
                one = live & (stop < k)
                s[one] = add_f32(y[stop[one], cols[one]], s[one])
                start = np.where(live, stop + one, start)
    return s.astype(np.float32).reshape(n, c)


def statistics_plain(x: torch.Tensor, num_groups: int, eps: float):
    """(mean, rstd), each float32 [N, G], of bf16 or float32 ``x``
    (steps 1-5 of the module docstring)."""
    n, c = x.shape[:2]
    d = c // num_groups
    a = x.detach().movedim(1, -1).reshape(n, -1, c).float().cpu().numpy()   # [N, P, C]
    # np.cumsum's last row is a strict sequential float32 sum (np.sum is
    # pairwise, and torch.cumsum accumulates in float64 on the CPU).
    s1 = np.cumsum(a, axis=1, dtype=np.float32)[:, -1]
    if x.dtype == torch.bfloat16:                # x * x exact: fma(x, x, s) = s + x * x
        s2 = np.cumsum(a * a, axis=1, dtype=np.float32)[:, -1]
    else:
        s2 = _fma_square_sums(a)
    g1 = np.cumsum(s1.reshape(n, num_groups, d), axis=2, dtype=np.float32)[..., -1]
    g2 = np.cumsum(s2.reshape(n, num_groups, d), axis=2, dtype=np.float32)[..., -1]
    s = np.float32(1) / np.float32(d * a.shape[1])
    mean = torch.from_numpy(g1 * s)
    var = fma_f32(torch.from_numpy(g2), float(s), -(mean * mean)).clamp_min(0.0)
    rstd = (1.0 / torch.sqrt(var.double() + eps)).float()
    return mean.to(x.device), rstd.to(x.device)


def scale_bias(mean: torch.Tensor, rstd: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor):
    """Step 6's per-channel (scale, bias), float32 [N, C]."""
    n, g = mean.shape
    rep = weight.shape[0] // g
    m, r = mean.repeat_interleave(rep, 1), rstd.repeat_interleave(rep, 1)
    scale = r * weight
    return scale, fma_f32(-scale, m, bias.expand_as(scale))


def group_norm_plain(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float):
    """GroupNorm of bf16 or float32 NCHW / NCDHW ``x`` in any memory format
    -> (y in ``x``'s dtype and memory format, mean, rstd float32 [N, G])."""
    _check(x, num_groups, weight, bias)
    mean, rstd = statistics_plain(x, num_groups, eps)
    scale, shift = scale_bias(mean, rstd, weight.detach().float(), bias.detach().float())
    view = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    y = fma_f32(x.detach().float(), scale.view(view), shift.view(view))
    out = torch.empty_like(x, memory_format=torch.preserve_format)
    return out.copy_(y), mean, rstd


def _group_norm_cuda(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float):
    """The kernel: channels-last bf16 or float32 on the card."""
    _check(x, num_groups, weight, bias)
    fmt = _memory_format(x)
    if not x.is_contiguous(memory_format=fmt):
        raise ValueError(f"{NAME}: the kernel takes {fmt} input, got strides {x.stride()}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError(f"{NAME}: weight and bias must be on {x.device}")
    n, c = x.shape[:2]
    p = math.prod(x.shape[2:])
    y = torch.empty_like(x, memory_format=fmt)
    mean = torch.empty((n, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    scale = torch.empty((n, c, 2), dtype=torch.float32, device=x.device)
    if x.numel():
        err = build.library().hst_group_norm(
            x.data_ptr(), weight.contiguous().data_ptr(), bias.contiguous().data_ptr(),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), n, c, p,
            num_groups, float(eps), int(x.dtype == torch.bfloat16), build.stream_handle(x))
        build.check(NAME, err)
        build.launch_counts[NAME] += 1
    return y, mean, rstd


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        if x.device.type == "cpu":
            y, mean, rstd = group_norm_plain(x, num_groups, weight, bias, eps)
        elif x.device.type == "cuda":
            y, mean, rstd = _group_norm_cuda(x, num_groups, weight, bias, eps)
        else:
            raise ValueError(f"{NAME}: unsupported device {x.device}")
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        n, c = x.shape[:2]
        # The layouts F.group_norm's autograd hands this backward: the
        # input's channels-last on the CPU, NCHW on CUDA (whose backward
        # takes no other).
        fmt = torch.contiguous_format
        if x.device.type == "cpu" and x.is_contiguous(memory_format=_memory_format(x)):
            fmt = _memory_format(x)
        dx, dw, db = torch.ops.aten.native_group_norm_backward(
            dy.float().contiguous(memory_format=fmt), x.float().contiguous(memory_format=fmt),
            mean, rstd, weight, n, c, math.prod(x.shape[2:]), ctx.num_groups,
            list(ctx.needs_input_grad[:3]))
        return (dx.to(x.dtype) if dx is not None else None), dw, db, None, None


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """GroupNorm of bf16 or float32 ``x`` with float32 ``weight`` and
    ``bias``: the kernel for a CUDA tensor (channels-last memory), the plain
    version for a CPU tensor; differentiable."""
    return _GroupNorm.apply(x, weight, bias, num_groups, eps)
