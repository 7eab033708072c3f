"""The port's three kernels (plain versions, which CPU tensors run) against
the JAX package: its jnp paths and its Pallas kernels in interpret mode.

Tolerances:
  * NV12 ingest: exact (every value is k/128 - 1, exact in bf16 and f32).
  * Correlation, f32: 1e-5 (sums of C products in another order).
    bf16: within 1 bf16 ulp (relative 2**-7) plus 1e-5 absolute.  The port
    accumulates in f32 and rounds once; the reference rounds the Gram
    matrix to bf16 before dividing by sqrt(C) and rounds again.  The
    absolute term covers sums near zero, whose f32 rounding depends on the
    order of summation.  The margin x < d is exactly 0.
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
    correlation_volume,
    correlation_volume_plain,
    soft_argmin_confidence,
    soft_argmin_confidence_plain,
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
    frames = torch.from_numpy(_frames(rng, 1, 8, 16))
    with pytest.raises(NotImplementedError):
        pp.nv12_ingest(frames, 8, 32, PreprocessConfig(color_space="rgb"))
    with pytest.raises(NotImplementedError):
        pp.nv12_ingest(frames, 8, 32, PreprocessConfig(color_space="yuv", quantize=True))
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


def test_correlation_bf16_within_one_ulp_of_jax(rng):
    b, h, w, c, d = 2, 6, 48, 32, 24
    fl = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).bfloat16()
    fr = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).bfloat16()
    port = correlation_volume_plain(fl, fr, d)
    assert port.dtype == torch.bfloat16
    jl = jnp.asarray(fl.float().numpy()).astype(jnp.bfloat16)
    jr = jnp.asarray(fr.float().numpy()).astype(jnp.bfloat16)
    ref = np.transpose(np.asarray(j_corr(jl, jr, d)).astype(np.float32), (0, 2, 3, 1))
    got = port.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-5)
    for k in range(d):
        np.testing.assert_array_equal(got[:, :, :k, k], 0.0)


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
