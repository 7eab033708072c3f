"""The port's NV12 ingest in every mode of ``PreprocessConfig`` against the
JAX package's (CPU).

Every comparison is bit for bit in float32: the port computes what XLA
compiles the JAX code into (``hobot_stereonet_tpu_torch/ops/kernels/numerics.py``:
a division by a constant becomes a multiplication by its float32
reciprocal, and a multiply followed by an add one fused multiply-add).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.config import PreprocessConfig as JPreprocessConfig
from hobot_stereonet_tpu.ops import colorspace as jcs
from hobot_stereonet_tpu.ops import preprocess as jpp
from hobot_stereonet_tpu_torch.config import PreprocessConfig
from hobot_stereonet_tpu_torch.ops import preprocess as pp
from hobot_stereonet_tpu_torch.ops.kernels import build
from hobot_stereonet_tpu_torch.ops.kernels.preprocess_kernel import yuv_bytes_to_rgb

torch.set_num_threads(1)

MODES = [dict(color_space="rgb"), dict(color_space="yuv", quantize=True),
         dict(color_space="rgb", quantize=True), dict(color_space="yuv")]
H, W = 16, 32          # one eye


def _frames(rng, b):
    return rng.integers(0, 256, (b, 3 * H * W), dtype=np.uint8)


def _jax_frames(frames, mode):
    cfg = JPreprocessConfig(**mode)
    return np.concatenate([np.asarray(jpp.side_by_side_nv12_to_model_input(
        jnp.asarray(f), H, 2 * W, cfg)) for f in frames])


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "+".join(
    [m["color_space"]] + (["quantize"] if m.get("quantize") else [])))
def test_ingest_mode_bit_equal_to_jax(rng, mode):
    """``nv12_ingest`` (the kernel's plain version on the CPU) and the plain
    ``side_by_side_nv12_to_model_input``, against JAX's ingest."""
    frames = _frames(rng, 3)
    want = _jax_frames(frames, mode)
    build.reset_launch_counts()
    got = pp.nv12_ingest(torch.from_numpy(frames), H, 2 * W, PreprocessConfig(**mode))
    assert sum(build.launch_counts.values()) == 0
    assert got.shape == want.shape == (3, H, W, 6)
    assert got.dtype == (torch.float32 if mode["color_space"] == "rgb" else torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)
    plain = pp.side_by_side_nv12_to_model_input(torch.from_numpy(frames), H, 2 * W,
                                                PreprocessConfig(**mode))
    np.testing.assert_array_equal(plain.numpy(), want)
    jingest = np.asarray(jpp.nv12_ingest(jnp.asarray(frames[0]), H, 2 * W,
                                         JPreprocessConfig(**mode), use_pallas=False))
    np.testing.assert_array_equal(got[:1].float().numpy(), jingest)


@pytest.mark.parametrize("mode", MODES[:3], ids=["rgb", "yuv+quantize", "rgb+quantize"])
def test_nv12_pair_to_model_input_bit_equal_to_jax(rng, mode):
    left, right = (rng.integers(0, 256, (H * W * 3 // 2,), dtype=np.uint8) for _ in range(2))
    cfg = PreprocessConfig(**mode)
    got = pp.nv12_pair_to_model_input(left, right, H, W, cfg, "cpu")
    want = np.asarray(jpp.nv12_pair_to_model_input(
        jnp.asarray(left), jnp.asarray(right), H, W, JPreprocessConfig(**mode)))
    assert got.shape == (1, H, W, 6) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_yuv_to_rgb_bit_equal_to_jax_on_every_byte_triple():
    """The RGB epilogue on all 2^24 (y, u, v) byte triples, against the
    JAX package's ``clip(yuv_to_rgb(.), 0, 255)`` compiled, as the ingest
    runs it (op by op, JAX divides and rounds each product instead)."""
    v = np.arange(256, dtype=np.float32)
    yuv = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
    want = np.asarray(jax.jit(lambda t: jnp.clip(jcs.yuv_to_rgb(t), 0.0, 255.0))(yuv))
    got = yuv_bytes_to_rgb(torch.from_numpy(yuv)).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_dequantize_bit_equal_to_jax(rng):
    """The reference's floor quantization, on values around each of its
    rounding points and beyond its clip range."""
    grid = np.arange(-130.0, 130.0, 0.5, dtype=np.float32) / 128.0
    x = np.concatenate([grid, np.nextafter(grid, np.float32(-2)), np.nextafter(grid, np.float32(2)),
                        rng.uniform(-1.5, 1.5, 4096).astype(np.float32)])
    q = pp.quantize_int8(torch.from_numpy(x))
    jq = np.asarray(jpp.quantize_int8(jnp.asarray(x)))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(pp.dequantize_int8(q).numpy(),
                                  np.asarray(jpp.dequantize_int8(jnp.asarray(jq))))


def test_other_normalization_takes_the_plain_route(rng):
    """Mean and std other than 128 (or another input quantization) are not
    the kernel's: the plain route, float32, bit-equal to JAX's."""
    frames = _frames(rng, 2)
    for mode in (dict(color_space="rgb", mean=100.0, std=50.0),
                 dict(color_space="yuv", quantize=True, quant_scale=0.01)):
        cfg = PreprocessConfig(**mode)
        assert not pp.uses_ingest_kernel(cfg)
        got = pp.nv12_ingest(torch.from_numpy(frames), H, 2 * W, cfg)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), _jax_frames(frames, mode))
    assert pp.uses_ingest_kernel(PreprocessConfig(color_space="rgb", quantize=True))

