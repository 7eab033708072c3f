"""The port's data sources against the JAX package's (CPU).

Tolerances: the procedural generator is a numpy copy, so scenes are
bit-equal for the same seed.  The side-by-side NV12 encoding rounds float32
BT.601 values to bytes; the port's float32 arithmetic follows the
reference's op for op, so the bytes are equal.  The host-side left-eye
decode is a numpy copy: bit-equal.
"""

import numpy as np
import pytest
import torch

from hobot_stereonet_tpu.data import loader as jloader
from hobot_stereonet_tpu.data import stream as jstream
from hobot_stereonet_tpu.data import synthetic as jsyn
from hobot_stereonet_tpu_torch.data import loader, stream, synthetic

torch.set_num_threads(1)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 777])
def test_generate_pair_bit_equal(seed):
    cfg = dict(height=64, width=96)
    _equal(synthetic.generate_pair(np.random.default_rng(seed), synthetic.SyntheticConfig(**cfg)),
           jsyn.generate_pair(np.random.default_rng(seed), jsyn.SyntheticConfig(**cfg)))


def test_generate_batch_and_layered_bit_equal():
    _equal(synthetic.generate_batch(np.random.default_rng(3), 2,
                                    synthetic.SyntheticConfig(height=32, width=64)),
           jsyn.generate_batch(np.random.default_rng(3), 2, jsyn.SyntheticConfig(height=32, width=64)))
    _equal(synthetic.generate_layered_hard(np.random.default_rng(5), 48, 80),
           jsyn.generate_layered_hard(np.random.default_rng(5), 48, 80))
    a = synthetic.LayeredScene(np.random.default_rng(9), 40, 64, 320.0, 0.25)
    b = jsyn.LayeredScene(np.random.default_rng(9), 40, 64, 320.0, 0.25)
    _equal(a.render(0.1, -0.05), b.render(0.1, -0.05))


def test_synthetic_dataset_matches_jax():
    kw = dict(size=5, seed=777, height=32, width=64)
    ours, ref = loader.SyntheticStereoDataset(**kw), jloader.SyntheticStereoDataset(**kw)
    assert len(ours) == len(ref) == 5
    for i in (0, 4):
        a, b = ours[i], ref[i]
        _equal((a.left, a.right, a.disparity), (b.left, b.right, b.disparity))
        assert a.name == b.name
    assert ours[4] is ours[4]                     # cached


def test_rgb_pair_to_sbs_nv12_and_left_decode_match_jax():
    l, r, _ = synthetic.generate_pair(np.random.default_rng(1),
                                      synthetic.SyntheticConfig(height=32, width=48))
    sbs = stream.rgb_pair_to_sbs_nv12(l, r)
    want = jstream.rgb_pair_to_sbs_nv12(l, r)
    assert sbs.dtype == np.uint8 and sbs.shape == (32 * 96 * 3 // 2,)
    np.testing.assert_array_equal(sbs, want)
    np.testing.assert_array_equal(stream.sbs_nv12_to_left_rgb(sbs, 32, 96),
                                  jstream.sbs_nv12_to_left_rgb(want, 32, 96))


def test_synthetic_stream_source_matches_jax():
    kw = dict(height=32, width=48, num_frames=2, seed=4, paced=False)
    ours = list(stream.SyntheticStreamSource(**kw))
    ref = list(jstream.SyntheticStreamSource(**kw))
    assert [f.index for f in ours] == [0, 1]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.sbs_nv12, b.sbs_nv12)
        np.testing.assert_array_equal(a.gt_disparity, b.gt_disparity)
        assert (a.height, a.full_width) == (b.height, b.full_width) == (32, 96)


def test_device_frame_ring_on_the_cpu_matches_jax():
    ring = stream.DeviceFrameRing(height=32, width=48, ring_size=3, seed=2, with_gt=True,
                                  device="cpu")
    ref = jstream.DeviceFrameRing(height=32, width=48, ring_size=3, seed=2, with_gt=True)
    assert ring.data.dtype == torch.uint8 and ring.ready is None
    np.testing.assert_array_equal(ring.data.numpy(), np.asarray(ref.data))
    frames = list(ring.frames(5))
    assert [f.sbs_nv12.slot for f in frames] == [0, 1, 2, 0, 1]
    slot = frames[4].sbs_nv12
    assert slot.dtype == np.uint8 and slot.size == 32 * 96 * 3 // 2 and slot.shape == (slot.size,)
    np.testing.assert_array_equal(np.asarray(slot), np.asarray(ref.data[1]))
    assert slot.device_array().data_ptr() == ring.data[1].data_ptr()       # a view
    np.testing.assert_array_equal(frames[4].gt_disparity, list(ref.frames(5))[4].gt_disparity)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            stream.DeviceFrameRing(height=32, width=48, ring_size=1)
