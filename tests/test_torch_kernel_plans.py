"""The addressing of the correlation backward's tensor-core kernel and the
launch plans of the D-leading soft-argmin, on the CPU.

``correlation_backward_tiles`` below computes the correlation's backward as
``csrc/correlation.cu``'s tensor-core kernel decomposes it: per 16-column
tile, the skewed band tiles of ``g`` built with the kernel's index formulas,
the fr / fl rows of the padded K axis, zeros outside [0, W), where x < d and
past the band.  Held here:

  * in float64 to :func:`correlation_volume_backward_plain` in float64, to
    1e-12 of the largest magnitude (the sums only run in another order);
  * in float32 to ``jax.vjp`` of the JAX package's
    ``build_correlation_volume``, to 1e-6 of the largest magnitude (the
    model sums in float64 and rounds once, XLA in float32);
  * in bf16 to the plain version within the card's bound for the kernel
    (``_bwd_check`` in tests/test_torch_cuda_kernels.py): at least 99.9 % of
    the values within one bf16 step, all within two.

``soft_argmin_cost_plan``, ``correlation_backward_route`` and
``soft_argmin_backward_plan`` are the routes the wrappers fix from the shape
and the addresses before launch; the card tests assert the launches of each
route.

``staged_softmax_vjp`` below computes the soft-argmin backward as
``csrc/soft_argmin.cu``'s staged route does: a pixel's 24 candidates over L
lanes (lane k holds k*C .. k*C + C - 1), each lane's max and tie count
combined over the group, the max probability as wmax / y and a division
only for the candidates within 2^-21 of wmax (the tie screen), gshare / y
once, and y, sum_d and sum_c summed as a prefix passed from lane to lane.
Held here bit for bit in float32 to ``_softmax_vjp`` (the plain version's
arithmetic, and the one-thread-a-pixel kernel's), with ties, near ties (one
and two float32 steps below the max) and without a confidence cotangent,
and to ``jax.vjp`` of the JAX package's ``soft_argmin`` and
``disparity_confidence`` within 1e-6 of the largest magnitude (the bound of
tests/test_torch_backward.py: XLA's exp and PyTorch's differ in their last
bits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.ops.cost_volume import build_correlation_volume
from hobot_stereonet_tpu.ops.soft_argmin import disparity_confidence, soft_argmin
from hobot_stereonet_tpu_torch.ops.kernels import build
from hobot_stereonet_tpu_torch.ops.kernels import correlation as kc

TILE = 16     # output columns a warp of the tensor-core backward


def ksteps(d_total):
    """k-steps of 16 band columns the kernel runs (``bwd_ksteps`` in
    csrc/correlation.cu): its K axis holds the D + 15 columns a tile touches."""
    return -(-(d_total + TILE - 1) // 16)


def correlation_backward_tiles(dcorr, feat_l, feat_r):
    """(dfl, dfr) as the tensor-core backward decomposes them.

    For each tile of ``TILE`` columns x0 .. x0+15 of a row, with K padded to
    ``16 * ksteps(D)`` and ``g = T(dcorr * f32(1 / divisor))`` as the kernel
    rounds it:
      dfl's band tile ``A1[r][k] = g[x0+r, r+D-1-k]`` against fr column
      ``x0-D+1+k``; dfr's ``A2[r][k] = g[x0+k, k-r]`` against fl column
      ``x0+k``;
    zero outside [0, W), where x < d, outside 0 <= d < D and past the D + 15
    band columns.  The products sum in float64 and round once to the
    features' dtype.
    """
    b, h, w, c = feat_l.shape
    d_total = dcorr.shape[-1]
    dt, f64 = feat_l.dtype, torch.float64
    inv = kc.reciprocal_f32(kc.correlation_divisor(c, dt))
    g = (dcorr.to(f64) * inv).to(dt).to(f64)
    fl, fr = feat_l.to(f64), feat_r.to(f64)
    krows = 16 * ksteps(d_total)
    band = d_total + TILE - 1
    r = torch.arange(TILE)[:, None]
    k = torch.arange(krows)[None]
    dfl, dfr = torch.zeros_like(fl), torch.zeros_like(fr)

    def gather_g(x, d):
        ok = (d >= 0) & (d < d_total) & (x >= d) & (x < w)
        return torch.where(ok, g[..., x.clamp(0, w - 1), d.clamp(0, d_total - 1)], 0.0)

    def gather_rows(f, x):
        ok = ((x >= 0) & (x < w) & (k[0] < band))[:, None]
        return torch.where(ok, f[..., x.clamp(0, w - 1), :], 0.0)

    for x0 in range(0, w, TILE):
        rows = min(TILE, w - x0)
        a1 = gather_g(x0 + r + 0 * k, r + d_total - 1 - k)
        a2 = gather_g(x0 + k + 0 * r, k - r)
        dfl[..., x0:x0 + rows, :] = (a1 @ gather_rows(fr, x0 - (d_total - 1) + k[0]))[..., :rows, :]
        dfr[..., x0:x0 + rows, :] = (a2 @ gather_rows(fl, x0 + k[0]))[..., :rows, :]
    return dfl.to(dt), dfr.to(dt)


# (B, H, W, C, D): W < D; W not a multiple of 16; the training shape; one
# serving row; another D and C.
BAND_SHAPES = [(1, 3, 17, 16, 24), (2, 3, 40, 32, 24), (8, 16, 32, 32, 24),
               (1, 1, 160, 32, 24), (1, 4, 70, 64, 5)]


def _inputs(shape, dtype, seed=3):
    b, h, w, c, d = shape
    rng = np.random.default_rng(seed + w)
    fl, fr = (rng.standard_normal((b, h, w, c)) for _ in range(2))
    dcorr = rng.standard_normal((b, h, w, d))
    return [torch.from_numpy(a).to(dtype) for a in (dcorr, fl, fr)]


@pytest.mark.parametrize("shape", BAND_SHAPES)
def test_tile_model_matches_the_plain_backward_in_float64(shape):
    dcorr, fl, fr = _inputs(shape, torch.float64)
    got = correlation_backward_tiles(dcorr, fl, fr)
    want = kc.correlation_volume_backward_plain(dcorr, fl, fr)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())


@pytest.mark.parametrize("shape", BAND_SHAPES)
def test_tile_model_matches_jax_vjp(shape):
    dcorr, fl, fr = _inputs(shape, torch.float32)
    d = shape[-1]
    _, vjp = jax.vjp(lambda a, b: build_correlation_volume(a, b, d),
                     jnp.asarray(fl.numpy()), jnp.asarray(fr.numpy()))
    want = vjp(jnp.asarray(dcorr.numpy()).transpose(0, 3, 1, 2))
    got = correlation_backward_tiles(dcorr, fl, fr)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        assert float(np.abs(g.numpy() - w).max()) <= 1e-6 * float(np.abs(w).max())


@pytest.mark.parametrize("shape", BAND_SHAPES)
def test_tile_model_in_bf16_is_within_the_kernels_bound(shape):
    dcorr, fl, fr = _inputs(shape, torch.bfloat16)
    got = correlation_backward_tiles(dcorr, fl, fr)
    want = kc.correlation_volume_backward_plain(dcorr, fl, fr)
    for g, w in zip(got, want):
        ulps = kc.bf16_ulp_distance(g, w)
        assert (ulps <= 1).float().mean().item() >= 0.999 and ulps.max().item() <= 2


def test_tile_model_zeroes_the_margin_and_the_halo():
    """Where every candidate of a column lies left of the image (x < d) its
    cotangent contributes nothing: a dcorr that is nonzero only there gives
    zero gradients."""
    b, h, w, c, d = 1, 2, 20, 16, 24
    dcorr, fl, fr = _inputs((b, h, w, c, d), torch.float64)
    x = torch.arange(w)[:, None]
    dcorr = torch.where(x < torch.arange(d)[None], dcorr, 0.0)
    for g in correlation_backward_tiles(dcorr, fl, fr):
        assert torch.equal(g, torch.zeros_like(g))


def test_correlation_backward_ksteps():
    assert [ksteps(d) for d in (1, 5, 17, 18, 24, 33, 34, 49)] == [1, 2, 2, 3, 3, 3, 4, 4]
    assert ksteps(kc.BWD_MAX_D) == 4 and ksteps(kc.BWD_MAX_D + 1) == 5


@pytest.mark.parametrize("dtype,c,d,ptrs,route", [
    (torch.bfloat16, 32, 24, (0, 256, 512, 4096), "mma"),      # the flagship
    (torch.bfloat16, 16, 24, (0, 16, 32, 48), "mma"),
    (torch.bfloat16, 64, 5, (0, 16, 32, 48), "mma"),
    (torch.bfloat16, 256, 49, (0, 16, 32, 48), "mma"),
    (torch.bfloat16, 24, 24, (0, 16, 32, 48), "simt"),         # C % 16 != 0
    (torch.bfloat16, 272, 24, (0, 16, 32, 48), "simt"),        # C > 256
    (torch.bfloat16, 32, 50, (0, 16, 32, 48), "simt"),         # D + 15 > 64
    (torch.bfloat16, 32, 24, (0, 16, 34, 48), "simt"),         # a misaligned output
    (torch.float32, 32, 24, (0, 16, 32, 48), "simt"),          # float32: SIMT always
])
def test_correlation_backward_route(dtype, c, d, ptrs, route):
    assert kc.correlation_backward_route(dtype, c, d, *ptrs) == route


# (B, D, plane, address, itemsize) -> (route, pixels, threads, grid)
COST_PLANS = [
    ((8, 24, 90 * 160, 0, 2), ("vector", 2, 128, (57, 8))),       # CLASSIC serving, B = 8
    ((32, 24, 90 * 160, 0, 2), ("vector", 2, 128, (57, 32))),
    ((8, 24, 45 * 160, 0, 2), ("vector", 2, 128, (29, 8))),       # a tile = 2 row tile
    ((8, 24, 16 * 32, 0, 2), ("vector", 2, 128, (2, 8))),         # the training shape
    ((3, 24, 13 * 9, 0, 2), ("scalar", 1, 256, (1, 3))),          # an odd plane
    ((8, 24, 90 * 160, 2, 2), ("scalar", 1, 256, (57, 8))),       # a view 2 bytes in
    ((8, 24, 90 * 160, 4, 2), ("vector", 2, 128, (57, 8))),       # 4 bytes in: 4-byte loads
    ((8, 24, 90 * 160 + 1, 0, 2), ("scalar", 1, 256, (57, 8))),   # an odd plane
    ((8, 7, 90 * 160, 0, 2), ("scalar", 1, 256, (57, 8))),        # another D
    ((8, 24, 90 * 160, 0, 4), ("vector", 2, 128, (57, 8))),       # float32: 8-byte loads
    ((2, 24, 45 * 160, 0, 4), ("vector", 2, 128, (29, 2))),
    ((8, 24, 16 * 32, 0, 4), ("vector", 2, 128, (2, 8))),
    ((3, 24, 13 * 9, 0, 4), ("scalar", 1, 256, (1, 3))),
    ((8, 24, 90 * 160, 4, 4), ("scalar", 1, 256, (57, 8))),       # not 8-byte aligned
    ((8, 24, 90 * 160, 8, 4), ("vector", 2, 128, (57, 8))),
    ((8, 24, 3 * 5, 0, 4), ("scalar", 1, 256, (1, 8))),           # plane % 2 != 0
]


@pytest.mark.parametrize("args,want", COST_PLANS)
def test_soft_argmin_cost_plan(args, want):
    plan = kc.soft_argmin_cost_plan(*args)
    assert tuple(plan) == want
    b, d, plane, ptr, itemsize = args
    # The grid covers every pixel of every sample, and no block lies wholly past
    # the plane.
    per_block = plan.pixels * plan.threads
    assert plan.grid[1] == b
    assert plan.grid[0] * per_block >= plane > (plan.grid[0] - 1) * per_block


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_soft_argmin_cost_plan_is_the_kernels(dtype):
    """The plan's vector route is the one csrc/soft_argmin.cu compiles: P =
    2 pixels a thread at 128 threads, one 4-byte (bf16) or 8-byte (float32)
    load a candidate; the scalar route one pixel a thread at 256."""
    size = torch.empty((), dtype=dtype).element_size()
    plan = kc.soft_argmin_cost_plan(8, 24, 90 * 160, 0, size)
    assert (plan.pixels, plan.threads) == (2, 128)
    assert plan.pixels * size == {2: 4, 4: 8}[size]
    src = (build.CSRC_DIR / "soft_argmin.cu").read_text()
    assert "#define HST_DLEAD_PIXELS 2\n" in src and "#define HST_DLEAD_THREADS 128\n" in src
    assert "constexpr int kThreads = 256;" in src
    assert kc.soft_argmin_cost_plan(8, 24, 90 * 160, size, size).threads == 256


def test_correlation_backward_on_the_cpu_takes_no_route():
    """CPU tensors go through the plain version and count no launch."""
    dcorr, fl, fr = _inputs((1, 2, 20, 16, 24), torch.bfloat16)
    n0 = dict(build.route_counts)
    got = kc.correlation_volume_backward(dcorr, fl, fr)
    want = kc.correlation_volume_backward_plain(dcorr, fl, fr)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dict(build.route_counts) == n0


def test_soft_argmin_cost_on_the_cpu_takes_no_route():
    """CPU tensors go through the plain version and count no launch."""
    cost = torch.randn(2, 24, 4, 8)
    n0 = dict(build.route_counts)
    disp, conf = kc.soft_argmin_cost(cost, 8.0)
    want = kc.soft_argmin_cost_plain(cost, 8.0)
    assert torch.equal(disp, want[0]) and torch.equal(conf, want[1])
    assert dict(build.route_counts) == n0


def staged_softmax_vjp(x, gd, gc, scale, lanes):
    """d(disp, conf)/dx . (gd, gc) for float32 logits x [..., D] as the staged
    route computes it with ``lanes`` lanes a pixel (D % lanes == 0); ``gd`` or
    ``gc`` None is a zero cotangent (the kernel's null pointer)."""
    d = x.shape[-1]
    c = d // lanes
    xs = x.reshape(-1, lanes, c)                          # [pixel, lane, candidate]
    n = xs.shape[0]

    def group(t):                                         # a value a lane to [n, 1, 1]
        return t[:, None, None]

    def prefix(t, take=None):
        """The sum of t's terms in index order from +0, lane k going on from
        lane k - 1's sum; a term whose ``take`` is False is skipped."""
        acc = torch.zeros(n, dtype=torch.float32)
        for k in range(lanes):
            for i in range(c):
                acc = acc + t[:, k, i] if take is None else torch.where(
                    take[:, k, i], acc + t[:, k, i], acc)
        return acc

    m = xs.amax(-1).amax(-1)                              # each lane's max, then the group's
    w = torch.exp(xs - group(m))
    y = prefix(w)
    r2 = 1.0 / (y * y)
    j = torch.arange(d, dtype=torch.float32).view(1, lanes, c)
    sgd = gd.reshape(-1) * scale if gd is not None else torch.zeros(n)
    ct = group(sgd) * j
    sum_d = prefix((ct * group(r2)) * w)
    dx = (ct / group(y) - group(sum_d)) * w
    if gc is not None:
        # max_j w_j / y is wmax / y (the division rounds monotonically); only a
        # w within 2^-21 of wmax can round to it, so only those are divided.
        wmax = w.amax(-1).amax(-1)
        pmax = (wmax / y).clamp_min(0.0)                  # fmaxf from +0
        near = group(wmax * (1.0 - 2.0 ** -21))
        tie = (w == group(wmax)) | ((w >= near) & (w / group(y) == group(pmax)))
        gshare = gc.reshape(-1) / tie.sum((-1, -2)).float()
        sum_c = prefix(group(gshare * r2) * w, tie)
        q, z = gshare / y, 0.0 / y                        # ci / y once a pixel
        dx = (torch.where(tie, group(q), group(z)) - group(sum_c)) * w + dx
    return dx.reshape(x.shape)


def _sa_inputs(shape, seed):
    """Logits with ties in the max (two candidates at every fourth pixel,
    three at every fifth), near ties (a max of 1 and candidates one and two
    float32 steps below it at every seventh: weights within the tie screen,
    some of whose probabilities round to the max's) and the two cotangents,
    float32, from numpy."""
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    flat = logits.reshape(-1, shape[-1])
    flat[::4, 5] = flat[::4, 11] = flat[::4].max(-1) + 1.0
    flat[1::5, 0] = flat[1::5, 3] = flat[1::5, 23] = flat[1::5].max(-1) + 0.5
    near = flat[2::7]
    near -= near.max(-1, keepdims=True) + np.float32(2.0)
    below = np.nextafter(np.float32(1.0), np.float32(-np.inf))
    near[:, 1], near[:, 4], near[:, 6] = 1.0, below, np.nextafter(below, np.float32(-np.inf))
    gd, gc = (rng.standard_normal(shape[:-1]).astype(np.float32) for _ in range(2))
    return torch.from_numpy(logits), torch.from_numpy(gd), torch.from_numpy(gc)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("with_gc", [False, True])
@pytest.mark.parametrize("lanes", kc.BWD_LANES)
@pytest.mark.parametrize("shape", [(2, 5, 7, 24), (8, 16, 32, 24), (1, 3, 4, 24)])
def test_staged_model_is_bit_equal_to_the_plain_arithmetic(shape, lanes, with_gc):
    logits, gd, gc = _sa_inputs(shape, lanes + shape[1])
    gc = gc if with_gc else None
    got = staged_softmax_vjp(logits, gd, gc, 8.0, lanes)
    want = kc._softmax_vjp(logits, gd, gc, 8.0)
    assert torch.equal(_bits(got), _bits(want))
    # and the wrappers' plain versions, in both layouts
    assert torch.equal(_bits(got), _bits(kc.soft_argmin_confidence_backward(logits, gd, gc, 8.0)))
    cost = (-logits).permute(0, 3, 1, 2).contiguous()
    got_cost = kc.soft_argmin_cost_backward(cost, gd, gc, 8.0)
    assert torch.equal(_bits(-got.permute(0, 3, 1, 2)), _bits(got_cost))


def test_near_ties_reach_both_outcomes_of_the_screen():
    """The inputs put weights inside the tie screen (w != wmax, w >= wmax (1 -
    2^-21)) whose probabilities round to the max's and others that do not."""
    x, _, _ = _sa_inputs((8, 16, 32, 24), 3)
    x = x.reshape(-1, 24)
    w = torch.exp(x - x.amax(-1, keepdim=True))
    y = kc._seq_sum(w)
    wmax = w.amax(-1, keepdim=True)
    screened = (w != wmax) & (w >= wmax * (1.0 - 2.0 ** -21))
    rounds_to_max = screened & (w / y == wmax / y)
    assert int(rounds_to_max.sum()) > 0 and int((screened & ~rounds_to_max).sum()) > 0


def test_staged_model_without_gd():
    """A confidence cotangent alone (gd None: the kernel's zero disparity cotangent)."""
    logits, _, gc = _sa_inputs((2, 3, 5, 24), 4)
    for lanes in kc.BWD_LANES:
        got = staged_softmax_vjp(logits, None, gc, 8.0, lanes)
        assert torch.equal(_bits(got), _bits(kc._softmax_vjp(logits, None, gc, 8.0)))


@pytest.mark.parametrize("with_gc", [False, True])
@pytest.mark.parametrize("lanes", [1, 4, 8])
def test_staged_model_matches_jax_vjp(lanes, with_gc):
    shape = (2, 5, 7, 24)
    logits, gd, gc = _sa_inputs(shape, 9)
    gcj = gc if with_gc else torch.zeros_like(gc)

    def heads(l):
        cst = -l
        return soft_argmin(cst, axis=-1) * 8.0, disparity_confidence(cst, axis=-1)

    _, vjp = jax.vjp(heads, jnp.asarray(logits.numpy()))
    (want,) = vjp((jnp.asarray(gd.numpy()), jnp.asarray(gcj.numpy())))
    want = np.asarray(want)
    got = staged_softmax_vjp(logits, gd, gc if with_gc else None, 8.0, lanes).numpy()
    assert float(np.abs(got - want).max()) <= 1e-6 * float(np.abs(want).max())


# (layout, B, D, plane, address, itemsize, has_gc) -> (route, lanes, threads, pixels, grid, smem)
CL, DL = kc.CHANNEL_LAST, kc.D_LEADING
BWD_PLANS = [
    ((CL, 8, 24, 90 * 160, 0, 2, True), ("staged", 2, 64, 32, (3600, 1), 1536)),   # serving
    ((CL, 8, 24, 90 * 160, 0, 2, False), ("staged", 1, 64, 64, (1800, 1), 3072)),
    ((CL, 32, 24, 90 * 160, 0, 2, False), ("staged", 1, 64, 64, (7200, 1), 3072)),
    ((CL, 1, 24, 90 * 160, 0, 2, True), ("staged", 4, 64, 16, (900, 1), 768)),     # one frame
    ((CL, 8, 24, 16 * 32, 0, 2, True), ("staged", 8, 64, 8, (512, 1), 384)),
    ((CL, 8, 24, 16 * 32, 0, 2, False), ("staged", 8, 64, 8, (512, 1), 384)),      # training
    ((CL, 2, 24, 16 * 32, 0, 2, False), ("staged", 8, 64, 8, (128, 1), 384)),      # sharded tiles
    ((CL, 4, 24, 8 * 32, 0, 2, False), ("staged", 8, 64, 8, (128, 1), 384)),
    ((CL, 8, 24, 90 * 160, 0, 4, True), ("staged", 2, 64, 32, (3600, 1), 3072)),   # float32
    ((CL, 3, 24, 35, 0, 2, True), ("staged", 8, 64, 8, (14, 1), 384)),             # a short tile
    ((DL, 8, 24, 90 * 160, 0, 2, True), ("staged", 2, 64, 32, (450, 8), 3456)),
    ((DL, 8, 24, 90 * 160, 0, 2, False), ("staged", 1, 64, 64, (225, 8), 3456)),
    ((DL, 32, 24, 90 * 160, 0, 2, False), ("staged", 1, 64, 64, (225, 32), 3456)),
    ((DL, 1, 24, 90 * 160, 0, 2, False), ("staged", 4, 64, 16, (900, 1), 3456)),
    ((DL, 8, 24, 45 * 160, 0, 2, False), ("staged", 1, 32, 32, (225, 8), 3456)),   # a tile = 2 tile
    ((DL, 8, 24, 16 * 32, 0, 2, False), ("staged", 8, 64, 8, (64, 8), 3456)),
    ((DL, 2, 24, 16 * 32, 0, 2, False), ("staged", 8, 64, 8, (64, 2), 3456)),
    ((DL, 4, 24, 8 * 32, 0, 2, False), ("staged", 8, 64, 8, (32, 4), 3456)),
    ((DL, 8, 24, 90 * 160, 0, 4, True), ("staged", 2, 64, 32, (450, 8), 6528)),
    ((DL, 32, 24, 90 * 160, 0, 4, False), ("staged", 1, 64, 64, (225, 32), 6528)),
    ((DL, 3, 24, 20, 0, 4, False), ("staged", 8, 32, 4, (5, 3), 6528)),            # 4-pixel tiles
    # misfits: another D; an address 2 (8) bytes in; a plane of no tile of whole 16-byte rows
    ((CL, 8, 7, 90 * 160, 0, 2, True), ("scalar", 1, 256, 256, (450, 1), 0)),
    ((CL, 8, 24, 90 * 160, 2, 2, True), ("scalar", 1, 256, 256, (450, 1), 0)),
    ((DL, 8, 24, 90 * 160, 8, 4, False), ("scalar", 1, 256, 256, (57, 8), 0)),
    ((DL, 3, 24, 13 * 9, 0, 2, False), ("scalar", 1, 256, 256, (1, 3), 0)),
    ((DL, 3, 24, 20, 0, 2, False), ("scalar", 1, 256, 256, (1, 3), 0)),
    ((DL, 8, 4, 16 * 32, 0, 2, True), ("scalar", 1, 256, 256, (2, 8), 0)),
]


@pytest.mark.parametrize("args,want", BWD_PLANS)
def test_soft_argmin_backward_plan(args, want):
    plan = kc.soft_argmin_backward_plan(*args)
    assert tuple(plan) == want
    layout, b, d, plane, ptr, itemsize, _ = args
    assert plan.threads == plan.pixels * plan.lanes and plan.threads % 32 == 0
    n = b * plane
    if plan.route == "scalar":
        blocks = -(-(plane if layout == DL else n) // 256)
        assert plan.grid == (blocks, b if layout == DL else 1) and plan.smem == 0
        return
    # The staged route as csrc/soft_argmin.cu checks it: D = 24, 16-byte
    # aligned, at most 256 threads; channel-last tiles cover every pixel and
    # no tile lies wholly past them; D-leading tiles of whole 16-byte rows
    # divide the plane.
    assert d == 24 and ptr % 16 == 0 and plan.threads <= kc.BWD_MAX_THREADS
    if layout == CL:
        assert plan.grid[1] == 1
        assert plan.grid[0] * plan.pixels >= n > (plan.grid[0] - 1) * plan.pixels
        assert plan.smem == plan.pixels * d * itemsize
    else:
        assert plane % plan.pixels == 0 and plan.pixels * itemsize % 16 == 0
        assert plan.pixels <= kc.BWD_DLEAD_MAX_TILE and plan.pixels & (plan.pixels - 1) == 0
        assert plan.grid == (plane // plan.pixels, b)
        assert plan.smem == d * (kc.BWD_DLEAD_MAX_TILE + 16 // itemsize) * itemsize


def test_soft_argmin_backward_plan_forced():
    """An explicit L and T: taken where they fit, else ValueError (never the
    scalar route in their place)."""
    plan = kc.soft_argmin_backward_plan(CL, 8, 24, 512, 0, 2, False, lanes=4, pixels=16)
    assert tuple(plan) == ("staged", 4, 64, 16, (256, 1), 768)
    for lanes, pixels in ((3, 16), (4, 12), (8, 64), (1, 16)):
        with pytest.raises(ValueError):
            kc.soft_argmin_backward_plan(CL, 8, 24, 512, 0, 2, False, lanes=lanes, pixels=pixels)
    with pytest.raises(ValueError):                  # T does not divide the plane
        kc.soft_argmin_backward_plan(DL, 8, 24, 520, 0, 2, False, lanes=4, pixels=16)
    with pytest.raises(ValueError):                  # a D-leading tile past 64 pixels
        kc.soft_argmin_backward_plan(DL, 8, 24, 512, 0, 2, False, lanes=2, pixels=128)
    with pytest.raises(ValueError):                  # D != 24
        kc.soft_argmin_backward_plan(DL, 8, 7, 512, 0, 2, False, lanes=4, pixels=16)


def test_soft_argmin_backward_plan_is_the_kernels():
    """The constants the plan uses are the ones csrc/soft_argmin.cu checks."""
    src = (build.CSRC_DIR / "soft_argmin.cu").read_text()
    assert f"constexpr int kBwdMaxThreads = {kc.BWD_MAX_THREADS};" in src
    assert f"constexpr int kDleadMaxTile = {kc.BWD_DLEAD_MAX_TILE};" in src
    assert "constexpr float kTieScreen = 1.0f - 0x1p-21f;" in src
    assert "!(L == 1 || L == 2 || L == 4 || L == 8)" in src and kc.BWD_LANES == (1, 2, 4, 8)
    assert f"constexpr int kThreads = {kc.SOFT_ARGMIN_COST_SCALAR_THREADS};" in src


def test_soft_argmin_backward_on_the_cpu_takes_no_route():
    """CPU tensors go through the plain version and count no launch."""
    logits, gd, gc = _sa_inputs((2, 3, 4, 24), 1)
    n0 = dict(build.route_counts), dict(build.launch_counts)
    got = kc.soft_argmin_confidence_backward(logits, gd, gc, 8.0)
    assert torch.equal(got, kc.soft_argmin_confidence_backward_plain(logits, gd, gc, 8.0))
    assert (dict(build.route_counts), dict(build.launch_counts)) == n0
