"""The port's colour-space, preprocessing and disparity ops against the JAX
package's (CPU).

Tolerances: layout ops (plane packing, chroma decimation, the side-by-side
split) are exact.  The BT.601 conversions run the reference's float32
arithmetic op for op: rtol 1e-6 (XLA may fuse differently), and the NV12
encoding, which rounds them to bytes, is exact here.
``rgb_pair_to_model_input``: 1e-6 absolute (values in [-1, 1]).  EPE and
D1: rtol 1e-6 (f32 sums in another order).  The dequantization and the
depth-to-disparity map: rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.config import CameraConfig as JCameraConfig
from hobot_stereonet_tpu.config import PreprocessConfig as JPreprocessConfig
from hobot_stereonet_tpu.ops import colorspace as jcs
from hobot_stereonet_tpu.ops import disparity as jdp
from hobot_stereonet_tpu.ops import preprocess as jpp
from hobot_stereonet_tpu_torch.config import CameraConfig, PreprocessConfig
from hobot_stereonet_tpu_torch.ops import colorspace as cs
from hobot_stereonet_tpu_torch.ops import disparity as dp
from hobot_stereonet_tpu_torch.ops import preprocess as pp

torch.set_num_threads(1)


def _img(rng, h=16, w=24):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_layout_ops_exact(rng):
    h, w = 8, 12
    nv12 = rng.integers(0, 256, (h * w * 3 // 2,), dtype=np.uint8)
    y, uv = cs.nv12_to_planes(torch.from_numpy(nv12), h, w)
    np.testing.assert_array_equal(cs.planes_to_nv12(y, uv).numpy(),
                                  np.asarray(jcs.planes_to_nv12(*jcs.nv12_to_planes(jnp.asarray(nv12), h, w))))
    yuv = _img(rng, h, w)
    got = cs.yuv444_to_yuv420(torch.from_numpy(yuv))
    want = jcs.yuv444_to_yuv420(jnp.asarray(yuv))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(cs.yuv420_to_yuv444(y, uv).numpy(),
                                  np.asarray(jcs.nv12_to_yuv444(jnp.asarray(nv12), h, w)))
    sbs = rng.integers(0, 256, (h * 2 * w * 3 // 2,), dtype=np.uint8)
    for a, b in zip(cs.split_side_by_side_nv12(torch.from_numpy(sbs), h, 2 * w),
                    jcs.split_side_by_side_nv12(jnp.asarray(sbs), h, 2 * w)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("fn", ["bgr_to_yuv", "yuv_to_bgr", "yuv_to_rgb", "rgb_to_yuv"])
def test_colour_conversions(rng, fn):
    x = _img(rng)
    got = getattr(cs, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jcs, fn)(jnp.asarray(x)))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_bgr_to_nv12_exact(rng):
    x = _img(rng, 32, 48)
    np.testing.assert_array_equal(cs.bgr_to_nv12(torch.from_numpy(x)).numpy(),
                                  np.asarray(jcs.bgr_to_nv12(jnp.asarray(x))))


@pytest.mark.parametrize("space", ["yuv", "rgb"])
def test_rgb_pair_to_model_input(rng, space):
    l, r = _img(rng), _img(rng)
    got = pp.rgb_pair_to_model_input(l, r, PreprocessConfig(color_space=space), "cpu")
    want = np.asarray(jpp.rgb_pair_to_model_input(l, r, JPreprocessConfig(color_space=space)))
    assert got.shape == (1, 16, 24, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pp.normalize(torch.from_numpy(l)).numpy(),
                               np.asarray(jpp.normalize(jnp.asarray(l))), rtol=0, atol=0)
    # As the JAX package's, the dataset path does not quantize.
    quantized = pp.rgb_pair_to_model_input(l, r, PreprocessConfig(color_space=space,
                                                                  quantize=True), "cpu")
    assert torch.equal(quantized, got)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):        # cuda:0 unless told otherwise
            pp.rgb_pair_to_model_input(l, r)


def test_disparity_metrics(rng):
    pred = (40 * rng.random((2, 16, 24))).astype(np.float32)
    gt = (pred + rng.normal(0, 3, pred.shape)).astype(np.float32)
    valid = gt > 5
    for fn in ("end_point_error", "d1_all"):
        for v in (None, valid):
            got = float(getattr(dp, fn)(torch.from_numpy(pred), gt, v))
            want = float(getattr(jdp, fn)(jnp.asarray(pred), jnp.asarray(gt),
                                          None if v is None else jnp.asarray(v)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-7), fn


def test_dequantize_and_depth_to_disparity(rng):
    raw = rng.integers(-2**20, 2**20, (4, 5), dtype=np.int32)
    np.testing.assert_allclose(dp.dequantize_reference_output(raw).numpy(),
                               np.asarray(jdp.dequantize_reference_output(jnp.asarray(raw))),
                               rtol=1e-6)
    depth = (0.2 + 20 * rng.random((3, 7))).astype(np.float32)
    depth[0, 0] = 0.0
    cam, jcam = CameraConfig(), JCameraConfig()
    np.testing.assert_allclose(dp.depth_to_disparity_px(depth, cam).numpy(),
                               np.asarray(jdp.depth_to_disparity_px(jnp.asarray(depth), jcam)),
                               rtol=1e-6)
    d = torch.from_numpy(dp.depth_to_disparity_px(depth[1:], cam).numpy())
    np.testing.assert_allclose(dp.disparity_to_depth_m(d, cam).numpy(), depth[1:], rtol=1e-5)
