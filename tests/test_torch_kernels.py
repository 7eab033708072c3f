"""The port's three kernels (plain versions, which CPU tensors run) against
the JAX package: its jnp paths and its Pallas kernels in interpret mode.

Tolerances:
  * NV12 ingest: exact (every value is k/128 - 1, exact in bf16 and f32).
  * Correlation, f32: 1e-5 (sums of C products in another order).
    bf16: the port rounds where the reference does (the f32 Gram value to
    bf16, then the quotient by bf16(sqrt C) to bf16), so at least 99.9 %
    of the values are bit-equal to it and every value is within 1 bf16 ulp
    (one representable step): only an f32 summation-order tie can move one.
    The margin x < d is exactly 0.
  * Soft-argmin and confidence: f32 rounding (rtol 1e-5; atol 1e-4 px on
    disparities up to 8 * (D - 1)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.config import PreprocessConfig as JPreprocessConfig
from hobot_stereonet_tpu.ops import preprocess as jpp
from hobot_stereonet_tpu.ops.cost_volume import (
    build_correlation_volume as j_corr,
    build_correlation_volume_ref as j_corr_ref,
)
from hobot_stereonet_tpu.ops.pallas.correlation import (
    correlation_volume_pallas,
    soft_argmin_pallas,
)
from hobot_stereonet_tpu.ops.pallas.preprocess_kernel import nv12_sbs_preprocess_pallas
from hobot_stereonet_tpu.ops.soft_argmin import disparity_confidence, soft_argmin
from hobot_stereonet_tpu_torch.config import PreprocessConfig
from hobot_stereonet_tpu_torch.ops import preprocess as pp
from hobot_stereonet_tpu_torch.ops import soft_argmin as sa
from hobot_stereonet_tpu_torch.ops.cost_volume import build_correlation_volume
from hobot_stereonet_tpu_torch.ops.kernels import build
from hobot_stereonet_tpu_torch.ops.kernels.correlation import (
    SOFT_ARGMIN_VECTOR_D,
    bf16_step,
    bf16_ulp_distance,
    correlation_divisor,
    correlation_gram_band,
    correlation_volume,
    correlation_volume_plain,
    soft_argmin_confidence,
    soft_argmin_confidence_plain,
    uses_vector_kernel,
)
from hobot_stereonet_tpu_torch.ops.kernels.preprocess_kernel import (
    nv12_sbs_preprocess,
    nv12_sbs_preprocess_plain,
)

torch.set_num_threads(1)

YUV = JPreprocessConfig(color_space="yuv")


def _frames(rng, b, h, w):
    return rng.integers(0, 256, size=(b, 3 * h * w), dtype=np.uint8)


# ---------------------------------------------------------------------------
# NV12 ingest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,w", [(1, 32, 64), (3, 16, 128)])
def test_ingest_matches_jax_and_pallas(rng, b, h, w):
    frames = _frames(rng, b, h, w)
    ref = np.concatenate([
        np.asarray(jpp.side_by_side_nv12_to_model_input(jnp.asarray(f), h, 2 * w, YUV))
        for f in frames])
    pallas = np.concatenate([
        np.asarray(nv12_sbs_preprocess_pallas(jnp.asarray(f), h, w, row_tile=8,
                                              interpret=True)).astype(np.float32)
        for f in frames])
    port = pp.side_by_side_nv12_to_model_input(
        torch.from_numpy(frames), h, 2 * w, PreprocessConfig(color_space="yuv"))
    plain = nv12_sbs_preprocess_plain(torch.from_numpy(frames), h, w)
    assert port.shape == plain.shape == (b, h, w, 6)
    assert port.dtype == torch.float32 and plain.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.numpy(), ref)
    np.testing.assert_array_equal(plain.float().numpy(), ref)
    np.testing.assert_array_equal(pallas, ref)


def test_ingest_dispatch_on_cpu_runs_plain_without_counting(rng):
    frames = torch.from_numpy(_frames(rng, 2, 8, 16))
    build.reset_launch_counts()
    out = pp.nv12_ingest(frames, 8, 32, PreprocessConfig(color_space="yuv"))
    assert torch.equal(out, nv12_sbs_preprocess_plain(frames, 8, 16))
    assert torch.equal(nv12_sbs_preprocess(frames[0], 8, 16), out[:1])
    assert sum(build.launch_counts.values()) == 0


def test_ingest_rejects_what_it_does_not_serve(rng):
    """Every colour space and the input quantization are served (against
    JAX in tests/test_torch_ingest_modes.py); malformed frames are refused."""
    frames = torch.from_numpy(_frames(rng, 1, 8, 16))
    assert pp.nv12_ingest(frames, 8, 32, PreprocessConfig(color_space="rgb")).dtype == torch.float32
    assert pp.nv12_ingest(frames, 8, 32, PreprocessConfig(color_space="yuv", quantize=True)
                          ).dtype == torch.bfloat16
    with pytest.raises(TypeError):
        nv12_sbs_preprocess(frames.float(), 8, 16)
    with pytest.raises(ValueError):
        nv12_sbs_preprocess(frames[:, :-2], 8, 16)
    with pytest.raises(ValueError):
        nv12_sbs_preprocess(frames, 7, 16)


# ---------------------------------------------------------------------------
# Correlation volume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,w,c,d", [(2, 16, 32, 8, 6), (1, 8, 40, 32, 24)])
def test_correlation_f32_matches_jax_and_pallas(rng, b, h, w, c, d):
    fl = rng.standard_normal((b, h, w, c)).astype(np.float32)
    fr = rng.standard_normal((b, h, w, c)).astype(np.float32)
    port = correlation_volume_plain(torch.from_numpy(fl), torch.from_numpy(fr), d).numpy()
    assert port.shape == (b, h, w, d) and port.dtype == np.float32
    jl, jr = jnp.asarray(fl), jnp.asarray(fr)
    for ref in (j_corr(jl, jr, d), j_corr_ref(jl, jr, d)):
        np.testing.assert_allclose(port, np.transpose(np.asarray(ref), (0, 2, 3, 1)),
                                   rtol=1e-5, atol=1e-5)
    pallas = np.asarray(correlation_volume_pallas(jl, jr, d, row_tile=8, interpret=True))
    np.testing.assert_allclose(port, pallas, rtol=1e-5, atol=1e-5)
    # The reference's layout [B, D, H, W] is a view of the same volume.
    np.testing.assert_array_equal(
        build_correlation_volume(torch.from_numpy(fl), torch.from_numpy(fr), d).numpy(),
        np.transpose(port, (0, 3, 1, 2)))


def test_correlation_zero_margin():
    b, h, w, c, d = 1, 8, 16, 4, 5
    ones = torch.ones((b, h, w, c))
    out = correlation_volume_plain(ones, ones, d).numpy()
    pallas = np.asarray(correlation_volume_pallas(
        jnp.ones((b, h, w, c)), jnp.ones((b, h, w, c)), d, row_tile=8, interpret=True))
    for k in range(d):
        np.testing.assert_array_equal(out[0, :, :k, k], 0.0)
        np.testing.assert_allclose(out[0, :, k:, k], c / np.sqrt(c), rtol=1e-6)
    np.testing.assert_allclose(out, pallas, rtol=1e-6)


@pytest.mark.parametrize("b,h,w,c,d", [
    (2, 8, 160, 32, 24),        # the flagship's row width, C and D
    (2, 6, 48, 32, 24),
    (2, 16, 17, 32, 24),        # W < D
    (2, 16, 40, 16, 6),
])
def test_correlation_bf16_within_one_ulp_of_jax(rng, b, h, w, c, d):
    fl = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).bfloat16()
    fr = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).bfloat16()
    port = correlation_volume_plain(fl, fr, d)
    assert port.dtype == torch.bfloat16
    jl = jnp.asarray(fl.float().numpy()).astype(jnp.bfloat16)
    jr = jnp.asarray(fr.float().numpy()).astype(jnp.bfloat16)
    ref = torch.from_numpy(np.transpose(np.asarray(j_corr(jl, jr, d)).astype(np.float32),
                                        (0, 2, 3, 1))).bfloat16()
    assert (port == ref).float().mean().item() >= 0.999
    assert bf16_ulp_distance(port, ref).max().item() <= 1
    got = port.float().numpy()
    for k in range(min(d, w)):
        np.testing.assert_array_equal(got[:, :, :k, k], 0.0)


def test_correlation_divides_by_sqrt_c_rounded_to_the_dtype():
    assert correlation_divisor(32, torch.bfloat16) == 5.65625
    assert correlation_divisor(32, torch.float32) == np.float32(np.sqrt(np.float32(32)))
    # Two roundings, as the reference: bf16(bf16(g) / 5.65625), not bf16(g / sqrt(32)).
    fl = torch.zeros((1, 1, 1, 32), dtype=torch.bfloat16)
    fr = torch.zeros_like(fl)
    fl[..., 0], fr[..., 0] = 0.5078125, 0.58984375
    assert correlation_volume_plain(fl, fr, 1).item() == 0.052734375
    assert torch.tensor(0.5078125 * 0.58984375 / np.sqrt(32)).bfloat16().item() == 0.052978515625


def test_reciprocal_multiply_rounds_as_the_true_division():
    """The bf16 kernel multiplies by 1/bf16(sqrt C) where the reference
    divides by bf16(sqrt C); after the rounding to bf16 the two agree for
    every finite bf16 Gram value and every C up to 512."""
    g = torch.arange(-(2 ** 15), 2 ** 15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    g = g[torch.isfinite(g)].float()
    for c in range(1, 513):
        divisor = torch.tensor(correlation_divisor(c, torch.bfloat16))
        reciprocal = 1.0 / divisor
        assert torch.equal((g / divisor).bfloat16(), (g * reciprocal).bfloat16()), c


def test_bf16_ulp_distance_counts_representable_steps():
    a = torch.tensor([1.0, 1.0, -1.0, 0.0, -0.0, 2.0 ** -130], dtype=torch.bfloat16)
    b = torch.tensor([1.0, 1.0078125, -1.0078125, -0.0, 2.0 ** -133, -(2.0 ** -130)],
                     dtype=torch.bfloat16)
    assert bf16_ulp_distance(a, b).tolist() == [0, 1, 1, 0, 1, 16]
    for steps in (-3, -1, 1, 2):
        moved = bf16_step(a, steps)
        assert bf16_ulp_distance(a, moved).tolist() == [abs(steps)] * 6
        assert bool(((moved.float() > a.float()) == (steps > 0)).all())


def test_correlation_gram_band_brackets_the_plain_version(rng):
    b, h, w, c, d = 2, 4, 40, 32, 24
    fl = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).bfloat16()
    fr = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).bfloat16()
    lo, hi = correlation_gram_band(fl, fr, d)
    plain = correlation_volume_plain(fl, fr, d)
    assert bool((lo <= plain).all() and (plain <= hi).all())
    margin = torch.zeros(plain.shape, dtype=torch.bool)
    for k in range(d):
        margin[:, :, :k, k] = True
    assert bool((lo[margin] == 0).all() and (hi[margin] == 0).all())
    assert bool((lo[~margin] < hi[~margin]).all())
    assert bf16_ulp_distance(lo, hi).max().item() <= 4
    with pytest.raises(TypeError):
        correlation_gram_band(fl.float(), fr.float(), d)


def test_correlation_dispatch_and_checks(rng):
    fl = torch.from_numpy(rng.standard_normal((1, 2, 8, 4)).astype(np.float32))
    build.reset_launch_counts()
    assert torch.equal(correlation_volume(fl, fl, 3), correlation_volume_plain(fl, fl, 3))
    assert sum(build.launch_counts.values()) == 0
    with pytest.raises(TypeError):
        correlation_volume(fl, fl.double(), 3)
    with pytest.raises(ValueError):
        correlation_volume(fl, fl[:, :, :4], 3)


# ---------------------------------------------------------------------------
# Soft-argmin + confidence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,w,d", [(1, 8, 16, 12), (2, 8, 20, 24)])
def test_soft_argmin_matches_jax_and_pallas(rng, b, h, w, d):
    logits = (3.0 * rng.standard_normal((b, h, w, d))).astype(np.float32)
    disp, conf = soft_argmin_confidence_plain(torch.from_numpy(logits), scale=8.0)
    assert disp.shape == conf.shape == (b, h, w)
    cost = -jnp.asarray(logits)
    ref_disp = np.asarray(soft_argmin(cost, axis=-1)) * 8.0
    ref_conf = np.asarray(disparity_confidence(cost, axis=-1))
    p_disp, p_conf = soft_argmin_pallas(cost, scale=8.0, row_tile=8, interpret=True)
    for want_d, want_c in ((ref_disp, ref_conf), (np.asarray(p_disp), np.asarray(p_conf))):
        np.testing.assert_allclose(disp.numpy(), want_d, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(conf.numpy(), want_c, rtol=1e-5, atol=1e-6)
    # The port's unfused plain ops agree with the reference's as well.
    np.testing.assert_allclose(sa.soft_argmin(-torch.from_numpy(logits), dim=-1).numpy() * 8.0,
                               ref_disp, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sa.disparity_confidence(-torch.from_numpy(logits), dim=-1).numpy(),
                               ref_conf, rtol=1e-5, atol=1e-6)


def test_soft_argmin_bf16_logits_compute_in_f32(rng):
    logits = torch.from_numpy(rng.standard_normal((1, 4, 8, 24)).astype(np.float32)).bfloat16()
    disp, conf = soft_argmin_confidence(logits, scale=8.0)
    assert disp.dtype == conf.dtype == torch.float32
    d32, c32 = soft_argmin_confidence_plain(logits.float(), scale=8.0)
    assert torch.equal(disp, d32) and torch.equal(conf, c32)
    assert float(conf.min()) >= 1.0 / 24 - 1e-7 and float(conf.max()) <= 1.0
    with pytest.raises(ValueError):
        soft_argmin_confidence(logits[0], scale=8.0)


def test_soft_argmin_kernel_choice():
    """The one-pass kernel takes bf16 rows of D = 24 that start 16-byte aligned."""
    flat = torch.zeros(1 + 2 * 3 * 4 * SOFT_ARGMIN_VECTOR_D, dtype=torch.bfloat16)
    aligned = flat[:-1].view(2, 3, 4, SOFT_ARGMIN_VECTOR_D)
    offset = flat[1:].view(2, 3, 4, SOFT_ARGMIN_VECTOR_D)
    assert aligned.data_ptr() % 16 == 0 and offset.is_contiguous()
    assert uses_vector_kernel(aligned)
    assert not uses_vector_kernel(offset)
    assert not uses_vector_kernel(aligned.float())
    assert not uses_vector_kernel(torch.zeros((1, 2, 3, 7), dtype=torch.bfloat16))
