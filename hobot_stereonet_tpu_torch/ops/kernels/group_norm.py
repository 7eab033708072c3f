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

Each (sample, channel) sum is one sequential chain, so the result of a
sample does not depend on the batch it is in.  The CUDA source is
``csrc/group_norm.cu``: it computes those chains bit for bit by an exact
parallel scan (its header states the invariant; :func:`scan_sums_model`
here models it in numpy for the tests), or, where the batch supplies
:data:`SEQUENTIAL_CHAINS` (sample, channel) pairs or more, by walking each
chain in order, one thread a chain (a launch of its own before the rest).  :func:`group_norm_plain` is the same
function in plain PyTorch and numpy.  :func:`group_norm_fused` adds the
conv's bias before and a residual add and LeakyReLU after, in the same
launch on the card; :func:`group_norm` is its call with none of the three.
Both are differentiable: the backward is ATen's
``native_group_norm_backward`` on the float32 input with the forward's
statistics, the backward ``F.group_norm`` runs.  :func:`tiled_group_norm`
is the GroupNorm of a row tile of an image split over ranks (the entries
split at the statistics, :func:`group_norm_stats` and
:func:`group_norm_apply`), with a backward that sums ATen's formula's terms
over the ranks.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import build
from .numerics import fma_f32

NAME = "group_norm"
DTYPES = (torch.bfloat16, torch.float32)


def _memory_format(x: torch.Tensor):
    return torch.channels_last_3d if x.dim() == 5 else torch.channels_last


def _check(x: torch.Tensor, num_groups: int, weight: Optional[torch.Tensor],
           bias: Optional[torch.Tensor]) -> None:
    """Refuse what the kernel does not take; None skips ``weight`` and
    ``bias`` (mode STATS reads neither)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"{NAME}: expected bfloat16 or float32 input, got {x.dtype}")
    if x.dim() not in (4, 5):
        raise ValueError(f"{NAME}: expected NCHW or NCDHW input, got {tuple(x.shape)}")
    c = x.shape[1]
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"{NAME}: {num_groups} groups do not divide {c} channels")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (c,)):
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


# ---------------------------------------------------------------------------
# The statistics kernel's exact parallel scan, as a numpy model (tests only)
# ---------------------------------------------------------------------------
#
# Mirrors csrc/group_norm.cu step by step: a sample's P positions in
# segments of LANES runs of R positions, walked in order.  A map is in
# units of a spacing u = 2^(E - 150) (E a float32 exponent field, the "key"): the
# segment's is the spacing of the largest sum that the float64 prefix of
# the segments' sums predicts in it.  A step whose value is a multiple of
# u is exact wherever the sum stays below 2^24 u; a step that rounds needs
# the sum in the top binade [2^23 u, 2^24 u).  A segment whose map cannot
# be taken is stepped alone.  :func:`scan_sums_model` returns the chains'
# bits and how often that fallback ran.

LANES = 32                     # lanes a warp: runs a segment, segments a window
KEY_NONE = -1                  # no spacing: the sum is out of the range a key takes
MAP_INF = 1 << 29              # a bound with no prefix (identity) or a dead path
MAP_REACH = 1 << 25            # a path that moved this far cannot pass any check
Q_LIMIT = float(1 << 22)       # a run whose sum of |v / u| reaches this is dead
KEY_EXPONENTS = (32, 200)      # exponent fields a key takes
# A map: int64 rows (a0, a1, lo0, lo1, hi0, hi1, rl0, rl1, rh0, rh1): for a
# start k (units of u) of parity p the steps add a_p, every prefix lies in
# [k + lo_p, k + hi_p] and every prefix right after a rounding step in
# [k + rl_p, k + rh_p].
IDENTITY = np.array([0, 0] + [MAP_INF] * 2 + [-MAP_INF] * 2 + [MAP_INF] * 2 + [-MAP_INF] * 2,
                    np.int64)
DEAD = np.array([0, 0] + [-MAP_INF] * 2 + [MAP_INF] * 2 + [MAP_INF] * 2 + [-MAP_INF] * 2,
                np.int64)


def scan_run_length(c: int) -> int:
    """R, positions of a lane's run: a segment (LANES runs) holds about 16K
    elements; even, so that a bf16 run fills whole 4-byte words."""
    return min(128, max(2, (512 // c) & ~1))


def _field(s) -> int:
    return (int(np.asarray(s, np.float32).view(np.uint32)) >> 23) & 0xFF


def scan_key(m) -> int:
    """The key for a sum of magnitude up to ``m``: the exponent field of
    float32(|m|), 127 for zero, KEY_NONE outside the fields a key takes."""
    m = abs(float(np.float32(m)))
    e = 127 if m == 0 else _field(m)
    if not np.isfinite(m) or e > KEY_EXPONENTS[1]:
        return KEY_NONE
    return max(e, KEY_EXPONENTS[0])


def _start(s, key):
    """s in units of u(key), an integer of magnitude below 2^24, or None."""
    if key == KEY_NONE or not np.isfinite(s):
        return None
    k = float(s) * 2.0 ** (150 - key)
    return int(k) if abs(k) < 2 ** 24 and k == np.rint(k) else None


def _value(k: int, key: int) -> np.float32:
    return np.float32(k * 2.0 ** (key - 150))


def _range_ok(m: np.ndarray, k, key: int) -> np.ndarray:
    """Whether map(s) ``m`` [..., 10] are exact from a start k: every prefix
    below 2^24 in magnitude, every prefix after a rounding step strictly
    inside one sign's top binade (2^23, 2^24)."""
    if key == KEY_NONE or k is None:
        return np.zeros(m.shape[:-1], bool)
    p = k & 1
    ok = (k + m[..., 2 + p] > -(1 << 24)) & (k + m[..., 4 + p] < (1 << 24))
    return ok & ((k + m[..., 6 + p] > (1 << 23)) | (k + m[..., 8 + p] < -(1 << 23)))


def _normalize(m: np.ndarray) -> np.ndarray:
    """A path whose prefix moved MAP_REACH or more is dead."""
    for p in (0, 1):
        dead = (m[..., 2 + p] <= -MAP_REACH) | (m[..., 4 + p] >= MAP_REACH)
        for col, v in ((p, 0), (2 + p, -MAP_INF), (4 + p, MAP_INF), (6 + p, MAP_INF),
                       (8 + p, -MAP_INF)):
            m[..., col] = np.where(dead, v, m[..., col])
    return m


def scan_compose(f: np.ndarray, g: np.ndarray) -> np.ndarray:
    """The map of f's steps then g's (rows of :data:`IDENTITY`'s layout).
    Associative."""
    out = np.empty(np.broadcast_shapes(f.shape, g.shape), np.int64)
    for p in (0, 1):
        fa = f[..., p]
        odd = ((p + fa) & 1).astype(bool)

        def pick(col):
            return np.where(odd, g[..., col + 1], g[..., col])

        out[..., p] = fa + pick(0)
        out[..., 2 + p] = np.minimum(f[..., 2 + p], fa + pick(2))
        out[..., 4 + p] = np.maximum(f[..., 4 + p], fa + pick(4))
        out[..., 6 + p] = np.minimum(f[..., 6 + p], fa + pick(6))
        out[..., 8 + p] = np.maximum(f[..., 8 + p], fa + pick(8))
    return _normalize(out)


def scan_run_maps(v: np.ndarray, valid: np.ndarray, key, q32: bool) -> np.ndarray:
    """Each run's map (a lane's work): ``v`` float64 [runs, R] the exact
    step values (x, or x * x), ``valid`` the positions that exist, ``key``
    the run's spacing.  ``q32``: the kernel scales v in float32 (v a float32
    value), else in float64."""
    key = np.broadcast_to(np.asarray(key, np.int64), v.shape[:1])
    scale = np.ldexp(1.0, 150 - np.where(key == KEY_NONE, 150, key))[:, None]
    with np.errstate(over="ignore", invalid="ignore"):
        q = v * scale                                  # v / u, exact but for overflow
        if q32:
            q = q.astype(np.float32).astype(np.float64)
        ne = np.rint(q)                                # half to even
        diff = q - ne
        rounds = diff != 0
        d = np.where(np.abs(diff) == 0.5, np.where(diff > 0, 1, -1), 0)
        qabs = np.where(valid, np.abs(q), 0.0)
        qsum = np.cumsum(qabs.astype(np.float32) if q32 else qabs, axis=1)[:, -1]
        t = np.where(valid & np.isfinite(ne) & (np.abs(ne) < 2 * Q_LIMIT), ne, 0).astype(np.int64)
    n = v.shape[0]
    m = np.tile(IDENTITY, (n, 1))
    for r in range(v.shape[1]):
        ok, rd = valid[:, r], valid[:, r] & rounds[:, r]
        for p in (0, 1):
            a = m[:, p]
            odd = ((p + a) & 1).astype(bool)
            a = np.where(ok, a + t[:, r] + np.where(odd, d[:, r], 0), a)
            m[:, p] = a
            m[:, 2 + p] = np.where(ok, np.minimum(m[:, 2 + p], a), m[:, 2 + p])
            m[:, 4 + p] = np.where(ok, np.maximum(m[:, 4 + p], a), m[:, 4 + p])
            m[:, 6 + p] = np.where(rd, np.minimum(m[:, 6 + p], a), m[:, 6 + p])
            m[:, 8 + p] = np.where(rd, np.maximum(m[:, 8 + p], a), m[:, 8 + p])
    m = _normalize(m)
    dead = (key == KEY_NONE) | ~(qsum < Q_LIMIT)
    return np.where(dead[:, None], DEAD, m)


def _fold(maps: np.ndarray) -> np.ndarray:
    """Inclusive prefix compositions of maps [n, 10] in order."""
    out = maps.copy()
    for i in range(1, len(maps)):
        out[i] = scan_compose(out[i - 1], maps[i])
    return out


def _step(s: np.float32, v: float) -> np.float32:
    """One chain step alone: float32(s + v) rounded once (v exact)."""
    return add_f32(np.array([v]), np.array([float(s)]))[0]


def scan_chain_model(v: np.ndarray, q32: bool, r: int, counts: dict) -> np.float32:
    """One chain, s = float32(s + v_p) for p in order from s = 0, as the
    kernel computes it; ``v`` float64 [P] exact step values."""
    p_len = len(v)
    seg_len = LANES * r
    k_segs = -(-p_len // seg_len)
    vv = np.zeros(k_segs * seg_len)
    vv[:p_len] = v
    valid = (np.arange(k_segs * seg_len) < p_len).reshape(k_segs, LANES, r)
    vv = vv.reshape(k_segs, LANES, r)
    # Phases 1-2: each run's sum and its prefixes' least and largest
    # (float32 where q32), each segment's in float64 over its runs; the
    # float64 prefix of the segments' sums, and the largest magnitude a
    # segment's sum is predicted to reach, give its key.
    pre = np.cumsum(vv.astype(np.float32) if q32 else vv, axis=2)
    run_sum = pre[..., -1].astype(np.float64)
    off = np.cumsum(run_sum, axis=1) - run_sum                    # runs' offsets in a segment
    mn = np.minimum((off + pre.min(axis=2)).min(axis=1), 0.0)
    mx = np.maximum((off + pre.max(axis=2)).max(axis=1), 0.0)
    agg = run_sum.sum(axis=1)
    start = np.concatenate([[0.0], np.cumsum(agg)[:-1]])
    keys = np.array([scan_key(max(abs(e + lo), abs(e + hi)))
                     for e, lo, hi in zip(start, mn, mx)])
    # Phase 3: every segment's map under its key.
    runs = scan_run_maps(vv.reshape(-1, r), valid.reshape(-1, r), np.repeat(keys, LANES), q32)
    seg_maps = _fold(runs.reshape(k_segs, LANES, 10).transpose(1, 0, 2))[-1]

    def slow(i: int, s: np.float32) -> np.float32:
        counts["segments"] += 1
        for x, ok in zip(vv[i].reshape(-1), valid[i].reshape(-1)):
            if ok:
                s = _step(s, x)
                counts["steps"] += 1
        return s

    # Phase 4: the segments in order, each applied from s in units of its
    # key, up to one that fails, which is stepped alone (the kernel loads
    # LANES segments a window; the order is the same).
    s = np.float32(0.0)
    for i in range(k_segs):
        k = _start(s, keys[i])
        if k is not None and _range_ok(seg_maps[i], k, keys[i]):
            s = _value(k + int(seg_maps[i][k & 1]), keys[i])
        else:
            s = slow(i, s)
    return s


def scan_sums_model(a: np.ndarray, bf16: bool, r: int = 0):
    """(s1, s2, counts): the statistics kernel's chains over float32 ``a``
    [N, P, C] (the values as the kernel reads them: bf16 values when
    ``bf16``), float32 [N, C] each, bit for bit the sequential chains
    ``s1 += x`` and ``s2 = fma(x, x, s2)`` (bf16: ``s2 += x * x``, as the
    plain version sums them); ``counts``: the segments stepped alone and
    their steps, over all chains."""
    n, p, c = a.shape
    r = r or scan_run_length(c)
    counts = {"chains": 0, "positions": 0, "segments": 0, "steps": 0}
    s1 = np.zeros((n, c), np.float32)
    s2 = np.zeros((n, c), np.float32)
    for i in range(n):
        for j in range(c):
            x = a[i, :, j]
            # bf16: x * x rounded to float32 (exact but below the normal
            # range), then added; float32: ATen's fma, the square exact.
            with np.errstate(over="ignore"):
                sq = (x * x).astype(np.float64) if bf16 else np.square(x.astype(np.float64))
                s1[i, j] = scan_chain_model(x.astype(np.float64), True, r, counts)
                s2[i, j] = scan_chain_model(sq, bf16, r, counts)
            counts["chains"] += 2
            counts["positions"] += 2 * p
    return s1, s2, counts


def group_sums_plain(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Each (sample, group)'s (S1, S2), float32 [N, G, 2] on ``x``'s device,
    of bf16 or float32 ``x`` (steps 1-2 of the module docstring)."""
    n, c = x.shape[:2]
    d = c // num_groups
    a = x.detach().movedim(1, -1).reshape(n, -1, c).float().cpu().numpy()   # [N, P, C]
    # np.cumsum's last element is a strict sequential float32 sum (np.sum is
    # pairwise, and torch.cumsum accumulates in float64 on the CPU); it runs
    # along contiguous rows, [N, C, P], several times faster than along P.
    rows = np.ascontiguousarray(a.transpose(0, 2, 1))
    s1 = np.cumsum(rows, axis=2, dtype=np.float32)[..., -1]
    if x.dtype == torch.bfloat16:                # x * x exact: fma(x, x, s) = s + x * x
        s2 = np.cumsum(rows * rows, axis=2, dtype=np.float32)[..., -1]
    else:
        s2 = _fma_square_sums(a)
    g1 = np.cumsum(s1.reshape(n, num_groups, d), axis=2, dtype=np.float32)[..., -1]
    g2 = np.cumsum(s2.reshape(n, num_groups, d), axis=2, dtype=np.float32)[..., -1]
    return torch.from_numpy(np.stack([g1, g2], -1)).to(x.device)


def statistics_from_sums(sums: torch.Tensor, count: int, eps: float):
    """Steps 3-5 of the module docstring: (mean, rstd), each float32 [N, G],
    from the group sums float32 [N, G, 2] of ``count`` (D * P) elements, on
    the sums' device, each rounding as the kernel's phase 5 makes it."""
    s = float(torch.tensor(1.0) / torch.tensor(float(count), dtype=torch.float32))
    mean = sums[..., 0] * s
    var = fma_f32(sums[..., 1].contiguous(), s, -(mean * mean)).clamp_min(0.0)
    rstd = (1.0 / torch.sqrt(var.double() + eps)).float()
    return mean, rstd


def statistics_plain(x: torch.Tensor, num_groups: int, eps: float):
    """(mean, rstd), each float32 [N, G], of bf16 or float32 ``x``
    (steps 1-5 of the module docstring)."""
    count = x.shape[1] // num_groups * math.prod(x.shape[2:])
    return statistics_from_sums(group_sums_plain(x, num_groups), count, eps)


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
    return normalize_plain(x, weight, bias, mean, rstd), mean, rstd


def normalize_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    mean: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    """Step 6 of the module docstring from given (mean, rstd) float32 [N, G]:
    ``fma(x, scale, shift)`` in ``x``'s dtype and memory format."""
    scale, shift = scale_bias(mean, rstd, weight.detach().float(), bias.detach().float())
    view = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    y = fma_f32(x.detach().float(), scale.view(view), shift.view(view))
    out = torch.empty_like(x, memory_format=torch.preserve_format)
    return out.copy_(y)


def workspace_bytes(n: int, c: int, p: int, r: int, sequential: bool) -> int:
    """Bytes of the kernel's scratch (csrc/group_norm.cu ``layout``): the
    segments' sums, their prefixes' extremes, keys and maps (none when the
    chains are walked in order), the chains, the (scale, shift) and the
    grid barrier, each 256-byte aligned."""
    k = 0 if sequential else -(-p // (LANES * r))
    chains = 2 * n * c * k

    def al(b):
        return -(-b // 256) * 256

    return (al(chains * 8) * 2 + al(chains * 4) + al(chains * 40) + al(2 * n * c * 4)
            + al(n * c * 8) + 256)


# (sample, channel) pairs from which the kernel walks each chain in order
# rather than scanning it.  The scan's maps cost grows with the batch; the
# walk's time does not (P dependent steps a chain, the chains side by side),
# and from here on it is the shorter at the networks' shapes on an H100
# (PERF.md, the GroupNorm per shape; scripts/torch_group_norm_modes.py).
# Below it the scan spreads each chain over the card.
SEQUENTIAL_CHAINS = 1024


def walks_in_order(n: int, c: int) -> bool:
    """Whether the kernel walks the chains of ``n`` samples of ``c``
    channels in order (else it scans them)."""
    return n * c >= SEQUENTIAL_CHAINS


def _group_norm_cuda(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, conv_bias: Optional[torch.Tensor] = None,
                     skip: Optional[torch.Tensor] = None, activate: bool = False):
    """The kernel: channels-last bf16 or float32 on the card -> (out, mean, rstd)."""
    return _launch(x, num_groups, weight, bias, eps, conv_bias, skip, activate)[:3]


# Modes of a launch (csrc/group_norm.cu): the fused one, the statistics'
# sums alone, the output from given statistics.
FUSED, STATS, APPLY = 0, 1, 2
_MODE_NAMES = {FUSED: NAME, STATS: NAME + "_stats", APPLY: NAME + "_apply"}


def _launch(x: torch.Tensor, num_groups: int, weight: torch.Tensor, bias: torch.Tensor,
            eps: float, conv_bias: Optional[torch.Tensor], skip: Optional[torch.Tensor],
            activate: bool, keep_r: bool = False, sequential: Optional[bool] = None,
            clock: Optional[torch.Tensor] = None, mode: int = FUSED,
            stats: Optional[tuple] = None):
    """One launch of the kernel -> (out, mean, rstd, r); r (the value
    before the activation) only with ``keep_r``.  ``sequential``: walk the
    chains in order (True) or scan them (False); None: :func:`walks_in_order`.
    ``clock``: None, or a CUDA int64 tensor of 9 (diagnostics): the launch
    overwrites its first 7 with the device time (ns) at its start and at the
    end of each of its six phases (block 0's view) and adds to the last 2
    its ordered walk's windows and the segments it stepped alone.

    ``mode=STATS`` -> (sums [N, G, 2] float32, the group's S1 and S2, None,
    None, None; no output is written, and ``weight`` and ``bias`` are not
    read: they may be None); ``mode=APPLY`` with ``stats`` = (mean, rstd) -> the
    output from them (steps 1-5 skipped).  Each counts its launch under its
    own name."""
    if mode == STATS:
        weight = bias = None
    _check(x, num_groups, weight, bias)
    fmt = _memory_format(x)
    if not x.is_contiguous(memory_format=fmt):
        raise ValueError(f"{NAME}: the kernel takes {fmt} input, got strides {x.stride()}")
    if mode != STATS and (weight.device != x.device or bias.device != x.device):
        raise ValueError(f"{NAME}: weight and bias must be on {x.device}")
    if conv_bias is not None and (conv_bias.dtype not in (torch.float32, torch.bfloat16)
                                  or conv_bias.shape != (x.shape[1],)
                                  or conv_bias.device != x.device):
        raise ValueError(f"{NAME}: conv_bias must be float32 or bf16 [{x.shape[1]}] on "
                         f"{x.device}, got {conv_bias.dtype} {tuple(conv_bias.shape)}")
    if skip is not None and (skip.dtype != x.dtype or skip.shape != x.shape
                             or not skip.is_contiguous(memory_format=fmt)):
        raise ValueError(f"{NAME}: skip must be {x.dtype} {tuple(x.shape)} in {fmt}, got "
                         f"{skip.dtype} {tuple(skip.shape)} strides {skip.stride()}")
    if clock is not None and (clock.dtype != torch.int64 or clock.numel() < 9
                              or clock.device != x.device):
        raise ValueError(f"{NAME}: clock must be int64 [9] on {x.device}")
    n, c = x.shape[:2]
    p = math.prod(x.shape[2:])
    r = scan_run_length(c)
    sequential = walks_in_order(n, c) if sequential is None else bool(sequential)
    if mode == APPLY:
        mean, rstd = (t.contiguous() for t in stats)
        if any(t.dtype != torch.float32 or t.shape != (n, num_groups) or t.device != x.device
               for t in (mean, rstd)):
            raise ValueError(f"{NAME}: mean and rstd must be float32 [{n}, {num_groups}] on "
                             f"{x.device}")
        sequential = True                  # no scan workspace: steps 1-5 are given
    elif mode == FUSED:
        mean = torch.empty((n, num_groups), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    else:                                  # the kernel writes neither in mode STATS
        mean = rstd = None
    sums = torch.empty((n, num_groups, 2), dtype=torch.float32, device=x.device) \
        if mode == STATS else None
    y = torch.empty_like(x, memory_format=fmt) if mode != STATS else x.new_empty(0)
    pre = torch.empty_like(x, memory_format=fmt) if keep_r else None
    if x.numel():
        work = torch.empty(workspace_bytes(n, c, p, r, sequential), dtype=torch.uint8,
                           device=x.device)
        err = build.library().hst_group_norm(
            x.data_ptr(), conv_bias.contiguous().data_ptr() if conv_bias is not None else None,
            int(conv_bias is not None and conv_bias.dtype == torch.bfloat16),
            skip.data_ptr() if skip is not None else None, int(activate),
            *(t.contiguous().data_ptr() if t is not None else None for t in (weight, bias)),
            y.data_ptr() if mode != STATS else None, pre.data_ptr() if keep_r else None,
            *(t.data_ptr() if t is not None else None for t in (mean, rstd)),
            work.data_ptr(), work.numel(),
            clock.data_ptr() if clock is not None else None, int(sequential), mode,
            sums.data_ptr() if sums is not None else None, n, c, p,
            num_groups, r, float(eps), int(x.dtype == torch.bfloat16), build.stream_handle(x))
        build.check(_MODE_NAMES[mode], err)
        build.launch_counts[_MODE_NAMES[mode]] += 1
    elif sums is not None:
        sums.zero_()
    if mode == STATS:
        return sums, mean, rstd, pre
    return y, mean, rstd, pre


# ---------------------------------------------------------------------------
# The fused entry: leaky_relu_0.2([skip +] GroupNorm(conv_out + bias))
# ---------------------------------------------------------------------------

NEGATIVE_SLOPE = 0.2


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """flax ``leaky_relu(x, 0.2)``: the slope is rounded to ``x``'s dtype."""
    return torch.where(x >= 0, x, x * torch.tensor(NEGATIVE_SLOPE, dtype=x.dtype))


def _channel_view(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.view((1, -1) + (1,) * (x.dim() - 2))


def group_norm_fused_plain(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                           bias: torch.Tensor, eps: float,
                           conv_bias: Optional[torch.Tensor] = None,
                           skip: Optional[torch.Tensor] = None, activate: bool = False):
    """The fused entry's function as the unfused ops compute it: ``a = x +
    conv_bias.to(x.dtype)``, ``r = [skip +] group_norm_plain(a)``, ``out =
    leaky_relu(r)`` with ``activate`` (else r).  Returns (out, r, mean, rstd)."""
    a = x if conv_bias is None else x + _channel_view(conv_bias.to(x.dtype), x)
    g, mean, rstd = group_norm_plain(a, num_groups, weight, bias, eps)
    r = g if skip is None else skip + g
    return (leaky_relu(r) if activate else r), r, mean, rstd


def _leaky_relu_backward(dout: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The gradient through :func:`leaky_relu` at its input ``r``: ``dout``
    where ``r >= 0``, else ``dout`` times the slope, in ``dout``'s dtype."""
    mask = r >= 0
    zero = torch.zeros((), dtype=dout.dtype, device=dout.device)
    return (torch.where(mask, dout, zero)
            + torch.where(mask, zero, dout) * torch.tensor(NEGATIVE_SLOPE, dtype=dout.dtype))


class _GroupNormFused(torch.autograd.Function):
    """The fused entry; its backward is the unfused ops' autograd: the
    LeakyReLU's two branches at the forward's r, the residual add, ATen's
    ``native_group_norm_backward`` on a (recomputed) with the forward's
    statistics (the backward ``F.group_norm`` runs), and the bias add's sum."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv_bias, skip, num_groups, eps, activate, keep):
        out, mean, rstd, r = torch.ops.hst.group_norm_fused(
            x, weight, bias, conv_bias, skip, num_groups, eps, activate, keep and activate)
        ctx.save_for_backward(x, weight, conv_bias, mean, rstd, r if keep and activate else None)
        ctx.num_groups, ctx.activate = num_groups, activate
        ctx.has_skip = skip is not None
        return out

    @staticmethod
    def backward(ctx, dout):
        x, weight, conv_bias, mean, rstd, r = ctx.saved_tensors
        need_x, need_w, need_b, need_cb, need_skip = ctx.needs_input_grad[:5]
        d_r = _leaky_relu_backward(dout, r) if ctx.activate else dout
        a = x if conv_bias is None else x + _channel_view(conv_bias.to(x.dtype), x)
        n, c = x.shape[:2]
        fmt = torch.contiguous_format
        if a.device.type == "cpu" and a.is_contiguous(memory_format=_memory_format(a)):
            fmt = _memory_format(a)
        need_a = need_x or need_cb
        da, dw, db = torch.ops.aten.native_group_norm_backward(
            d_r.float().contiguous(memory_format=fmt), a.float().contiguous(memory_format=fmt),
            mean, rstd, weight, n, c, math.prod(x.shape[2:]), ctx.num_groups,
            [need_a, need_w, need_b])
        dx = dcb = None
        if need_a:
            dx = da.to(x.dtype)
            if need_cb:
                dims = [0] + list(range(2, x.dim()))
                dcb = dx.sum(dims, keepdim=True).view(-1).to(conv_bias.dtype)
        return ((dx if need_x else None), dw, db, dcb, (d_r if need_skip else None), None, None,
                None, None)


def group_norm_fused(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, conv_bias: Optional[torch.Tensor] = None,
                     skip: Optional[torch.Tensor] = None, activate: bool = False) -> torch.Tensor:
    """``leaky_relu_0.2([skip +] GroupNorm(x + conv_bias))`` in one call, each
    rounding as the unfused ops make it: the kernel for a CUDA tensor (one
    launch: the bias add, the residual add and the activation ride in its
    passes), :func:`group_norm_fused_plain` for a CPU tensor; differentiable.
    ``x``: the conv's output without its bias (bf16 or float32, channels-last
    on the card); ``conv_bias``: float32 or bf16 [C], rounded to x's dtype
    before the add; ``skip``: like x."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, conv_bias, skip)):
        return _GroupNormFused.apply(x, weight, bias, conv_bias, skip, num_groups, eps,
                                     activate, True)
    return torch.ops.hst.group_norm_fused(x, weight, bias, conv_bias, skip, num_groups, eps,
                                          activate, False)[0]


@torch.library.custom_op("hst::group_norm_fused", mutates_args=(), device_types="cpu")
def _group_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   conv_bias: Optional[torch.Tensor], skip: Optional[torch.Tensor],
                   num_groups: int, eps: float, activate: bool, keep_r: bool
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``hst::group_norm_fused`` -> (out, mean, rstd, r): the plain version on
    the CPU (:func:`group_norm_fused_plain`), one kernel launch on CUDA
    (:func:`_group_norm_cuda_op`).  r (the value before the activation) only
    with ``keep_r`` (and ``activate``), else an empty tensor."""
    out, r, mean, rstd = group_norm_fused_plain(x, num_groups, weight, bias, eps, conv_bias,
                                                skip, activate)
    return out, mean, rstd, (r if keep_r else x.new_empty(0))


@_group_norm_op.register_fake
def _(x, weight, bias, conv_bias, skip, num_groups, eps, activate, keep_r):
    _check(x, num_groups, weight, bias)
    fmt = _memory_format(x) if x.is_contiguous(memory_format=_memory_format(x)) \
        else torch.preserve_format
    out = torch.empty_like(x, memory_format=fmt)
    mean = x.new_empty((x.shape[0], num_groups), dtype=torch.float32)
    r = torch.empty_like(out) if keep_r else x.new_empty(0)
    return out, mean, torch.empty_like(mean), r


@_group_norm_op.register_kernel("cuda")
def _group_norm_cuda_op(x, weight, bias, conv_bias, skip, num_groups, eps, activate, keep_r):
    out, mean, rstd, r = _launch(x, num_groups, weight, bias, eps, conv_bias, skip, activate,
                                 keep_r=keep_r)
    return out, mean, rstd, (r if keep_r else x.new_empty(0))


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """GroupNorm of bf16 or float32 ``x`` with float32 ``weight`` and
    ``bias``: :func:`group_norm_fused` with no conv bias, skip or
    activation (the kernel for a CUDA tensor in channels-last memory, the
    plain version for a CPU tensor); differentiable."""
    return group_norm_fused(x, num_groups, weight, bias, eps)


# ---------------------------------------------------------------------------
# The entries split at the statistics (row tiles across ranks)
# ---------------------------------------------------------------------------


def group_norm_stats(x: torch.Tensor, num_groups: int,
                     conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each (sample, group)'s (S1, S2) of ``a = x + conv_bias.to(x.dtype)``,
    float32 [N, G, 2] (steps 1-2 of the module docstring, the chains over
    ``x``'s positions in order): the kernel in mode STATS for a CUDA tensor
    (one launch), :func:`group_sums_plain` for a CPU tensor.  Combine
    ranks' sums with :func:`combine_sums`, then :func:`statistics_from_sums`."""
    return torch.ops.hst.group_norm_stats(x, conv_bias, num_groups)


def group_norm_apply(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     mean: torch.Tensor, rstd: torch.Tensor,
                     conv_bias: Optional[torch.Tensor] = None,
                     skip: Optional[torch.Tensor] = None, activate: bool = False,
                     keep_r: bool = False):
    """:func:`group_norm_fused`'s output from given (mean, rstd) float32
    [N, G]: the kernel in mode APPLY for a CUDA tensor (one launch), the
    unfused ops for a CPU tensor.  :func:`group_norm_stats`, then
    :func:`statistics_from_sums`, then this over one whole tensor give
    :func:`group_norm_fused`'s bits.  ``keep_r`` (with ``activate``):
    returns (output, r), r the value before the activation, written by the
    same launch."""
    out, r = torch.ops.hst.group_norm_apply(x, weight, bias, mean, rstd, conv_bias, skip,
                                            activate, keep_r and activate)
    return (out, r) if keep_r else out


def combine_sums(parts: "list[torch.Tensor]") -> torch.Tensor:
    """Ranks' group sums (each float32 [N, G, 2]) added in float64 in the
    order given (rank order), rounded once to float32: one part comes back
    as it is."""
    return add_in_order(parts).float()


def add_in_order(parts: "list[torch.Tensor]") -> torch.Tensor:
    """``parts`` added in float64 in the order given (float64)."""
    total = parts[0].double()
    for part in parts[1:]:
        total = total + part.double()
    return total


def _with_bias(x: torch.Tensor, conv_bias: Optional[torch.Tensor]) -> torch.Tensor:
    return x if conv_bias is None else x + _channel_view(conv_bias.to(x.dtype), x)


@torch.library.custom_op("hst::group_norm_stats", mutates_args=(), device_types="cpu")
def _group_norm_stats_op(x: torch.Tensor, conv_bias: Optional[torch.Tensor],
                         num_groups: int) -> torch.Tensor:
    """``hst::group_norm_stats``: :func:`group_norm_stats`."""
    return group_sums_plain(_with_bias(x, conv_bias), num_groups)


@_group_norm_stats_op.register_fake
def _(x, conv_bias, num_groups):
    return x.new_empty((x.shape[0], num_groups, 2), dtype=torch.float32)


@_group_norm_stats_op.register_kernel("cuda")
def _group_norm_stats_cuda(x, conv_bias, num_groups):
    return _launch(x, num_groups, None, None, 0.0, conv_bias, None, False, mode=STATS)[0]


@torch.library.custom_op("hst::group_norm_apply", mutates_args=(), device_types="cpu")
def _group_norm_apply_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         mean: torch.Tensor, rstd: torch.Tensor,
                         conv_bias: Optional[torch.Tensor], skip: Optional[torch.Tensor],
                         activate: bool, keep_r: bool
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``hst::group_norm_apply`` -> (out, r): :func:`group_norm_apply`; r only
    with ``keep_r``, else an empty tensor."""
    _check(x, mean.shape[1], weight, bias)
    g = normalize_plain(_with_bias(x, conv_bias), weight, bias, mean, rstd)
    r = g if skip is None else skip + g
    return (leaky_relu(r) if activate else r), (r if keep_r else x.new_empty(0))


@_group_norm_apply_op.register_fake
def _(x, weight, bias, mean, rstd, conv_bias, skip, activate, keep_r):
    fmt = _memory_format(x) if x.is_contiguous(memory_format=_memory_format(x)) \
        else torch.preserve_format
    out = torch.empty_like(x, memory_format=fmt)
    return out, (torch.empty_like(out) if keep_r else x.new_empty(0))


@_group_norm_apply_op.register_kernel("cuda")
def _group_norm_apply_cuda(x, weight, bias, mean, rstd, conv_bias, skip, activate, keep_r):
    out, _, _, r = _launch(x, mean.shape[1], weight, bias, 0.0, conv_bias, skip, activate,
                           keep_r=keep_r, mode=APPLY, stats=(mean, rstd))
    return out, (r if keep_r else x.new_empty(0))


# ---------------------------------------------------------------------------
# Row tiles across ranks: the whole image's statistics, with a backward
# ---------------------------------------------------------------------------


def tiled_group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, tiles,
                     conv_bias: Optional[torch.Tensor] = None,
                     skip: Optional[torch.Tensor] = None, activate: bool = False
                     ) -> torch.Tensor:
    """:func:`group_norm_fused` of this rank's row tile of an image split
    over the ranks of ``tiles`` (a ``parallel.tiling.RowTiles``): the
    statistics of the whole image, then this tile's output.  bf16 and
    float32: :func:`group_norm_stats` over the tile's rows, every rank's
    sums added in float64 in rank order (``tiles.group_statistics``), then
    :func:`group_norm_apply`; float64 (``weight`` and ``bias`` too): the
    same sums, statistics and output in float64 PyTorch.

    Differentiable (:class:`_TiledGroupNorm`): ATen's
    ``native_group_norm_backward`` with the whole image's sums.  The tile
    forms each (sample, group)'s ``Σ dy·γ·a`` and ``Σ dy·γ`` (float32, or
    float64 for float64 input), the tile group adds them in float64 in rank
    order, and ``dx = γ·rstd·dy + c2·a + c3`` with the whole image's
    element count; dγ, dβ and the conv bias's gradient are this tile's
    sums (the train step adds them over the ranks)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, conv_bias, skip)):
        return _TiledGroupNorm.apply(x, weight, bias, conv_bias, skip, tiles, num_groups, eps,
                                     activate)
    return _tiled_forward(x, num_groups, weight, bias, eps, tiles, conv_bias, skip, activate,
                          False)[0]


def _tiled_forward(x, num_groups, weight, bias, eps, tiles, conv_bias, skip, activate, keep_r):
    """-> (out, r or None, mean, rstd) of :func:`tiled_group_norm`."""
    count = x.shape[1] // num_groups * math.prod(x.shape[2:])
    if x.dtype != torch.float64:
        mean, rstd = tiles.group_statistics(group_norm_stats(x, num_groups, conv_bias), count,
                                            eps)
        out = group_norm_apply(x, weight, bias, mean, rstd, conv_bias=conv_bias, skip=skip,
                               activate=activate, keep_r=keep_r)
        return (out if keep_r else (out, None)) + (mean, rstd)
    a = _with_bias(x, conv_bias)
    v = a.reshape(a.shape[0], num_groups, -1)
    total = tiles.sum_in_rank_order(torch.stack([v.sum(-1), (v * v).sum(-1)], -1))
    m = tiles.image_count(count)
    mean = total[..., 0] / m
    rstd = 1.0 / torch.sqrt((total[..., 1] / m - mean * mean).clamp_min(0.0) + eps)
    y = ((v - mean[..., None]) * rstd[..., None]).view(a.shape)
    r = y * _channel_view(weight, x) + _channel_view(bias, x)
    r = r if skip is None else skip + r
    return (leaky_relu(r) if activate else r), r, mean, rstd


class _TiledGroupNorm(torch.autograd.Function):
    """:func:`tiled_group_norm` with its backward (the docstring there); the
    LeakyReLU, residual add and conv bias steps as :class:`_GroupNormFused`'s."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv_bias, skip, tiles, num_groups, eps, activate):
        out, r, mean, rstd = _tiled_forward(x, num_groups, weight, bias, eps, tiles, conv_bias,
                                            skip, activate, activate)
        ctx.save_for_backward(x, weight, conv_bias, mean, rstd, r if activate else None)
        ctx.tiles, ctx.num_groups, ctx.activate = tiles, num_groups, activate
        return out

    @staticmethod
    def backward(ctx, dout):
        x, weight, conv_bias, mean, rstd, r = ctx.saved_tensors
        need_x, need_w, need_b, need_cb, need_skip = ctx.needs_input_grad[:5]
        d_r = _leaky_relu_backward(dout, r) if ctx.activate else dout
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        a, dy, w = _with_bias(x, conv_bias).to(acc), d_r.to(acc), weight.to(acc)
        n, c = x.shape[:2]
        g, d = ctx.num_groups, c // ctx.num_groups
        dims = tuple(range(2, x.dim()))
        ds, db = (dy * a).sum(dims), dy.sum(dims)                     # [N, C], this tile's
        part = torch.stack([(ds * w).view(n, g, d).sum(2), (db * w).view(n, g, d).sum(2)], -1)
        total = ctx.tiles.sum_in_rank_order(part).to(acc)              # the whole image's
        ds_g, db_g = total[..., 0], total[..., 1]
        mean, rstd = mean.to(acc), rstd.to(acc)
        s = 1.0 / ctx.tiles.image_count(d * math.prod(x.shape[2:]))
        c2 = (db_g * mean - ds_g) * rstd * rstd * rstd * s
        c3 = -c2 * mean - db_g * rstd * s
        mean_c, rstd_c = mean.repeat_interleave(d, 1), rstd.repeat_interleave(d, 1)
        dx = dcb = None
        if need_x or need_cb:
            view = (n, c) + (1,) * len(dims)
            dx = ((rstd_c * w).view(view) * dy + c2.repeat_interleave(d, 1).view(view) * a
                  + c3.repeat_interleave(d, 1).view(view)).to(x.dtype)
            if need_cb:
                dcb = dx.sum((0,) + dims).to(conv_bias.dtype)
        dw = ((ds - db * mean_c) * rstd_c).sum(0).to(weight.dtype) if need_w else None
        dbeta = db.sum(0).to(weight.dtype) if need_b else None
        return ((dx if need_x else None), dw, dbeta, dcb, (d_r if need_skip else None), None,
                None, None, None)
