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

``soft_argmin_cost_plan`` and ``correlation_backward_route`` are the routes
the wrappers fix from the shape and the addresses before launch; the card
tests assert the launches of each route.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.ops.cost_volume import build_correlation_volume
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
