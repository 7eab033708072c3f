"""float32 arithmetic as XLA compiles it, for the kernels' plain versions.

XLA, which compiles the JAX package, rewrites two things that the JAX code
writes as separate float32 operations:

  * ``a * b + c`` becomes one fused multiply-add, rounded once;
  * ``x / c`` with ``c`` a constant becomes ``x * float32(1 / c)``.

The CUDA kernels write both with intrinsics (``__fmaf_rn``, ``__fmul_rn``),
so that neither ``nvcc``'s contraction nor its flags change them, and their
plain versions compute the same with :func:`fma_f32` and :func:`reciprocal_f32`.
"""

from __future__ import annotations

import torch


def reciprocal_f32(c: float) -> float:
    """``float32(1 / float32(c))``: what XLA multiplies by for ``x / c``."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one / torch.tensor(c, dtype=torch.float32))


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` on float32 values with one rounding to float32.

    The product of two float32 values is exact in float64; the float64 sum
    is rounded once, and its exact error (Knuth's TwoSum) decides the one
    case where rounding that sum to float32 again could differ from
    rounding the exact value: a sum that lands half-way between two
    float32 values.  Finite values without overflow only.  At least one
    argument is a float32 tensor; the others may be Python floats.
    """
    dev = next(t.device for t in (a, b, c) if isinstance(t, torch.Tensor))
    a, b, c = (torch.as_tensor(t, dtype=torch.float32, device=dev).double() for t in (a, b, c))
    p = a * b
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    r = s.float()
    inf = torch.tensor(float("inf"), device=dev)
    lo = torch.where(r.double() <= s, r, torch.nextafter(r, -inf))
    hi = torch.nextafter(lo, inf)
    tie = s == (lo.double() + hi.double()) * 0.5
    return torch.where(tie & (err > 0), hi, torch.where(tie & (err < 0), lo, r))

