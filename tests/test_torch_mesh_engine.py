"""``StereoEngine`` on a (data, tile) mesh of gloo ranks, against one rank and JAX.

The ranks are processes (``tests/torch_mesh_workers.py``, scenario
``serving``): for each network (the flagship and CLASSIC, the small
networks of the JAX package's multi-device tests, seeded weights) and
precision (float32, bf16, int8 dynamic and int8 static, int8 computing in
bf16 as served) at data = 2 x tile = 2 and at tile = 4 (40 rows: 5 at 1/8,
split 2 / 1 / 1 / 1), one dispatch of 4 frames through ``pipeline`` on
rank 0 while the others ``serve``; a data-parallel flagship at data = 4;
two streamed runs; ``device_microbatch``; the refusals.  This process runs
the same frames through a one-rank ``StereoEngine`` and, for float32, the
JAX engine.

Bounds against one rank (measured on this CPU in brackets):
  * float32: disparity within 5e-5 px [1.9e-5], confidence within 5e-6
    [9.5e-7]: the halo'd convs and the GroupNorm's statistics, combined
    over the tile group in float64, round differently;
  * bf16: C4's bf16 bounds (median 0.03 px, 0.05 % over 1 px, max 8 px)
    [median 0.019, none over 1 px, max 0.18]; a data rank's smaller batch
    also moves cuDNN's bf16 results on the CPU;
  * int8: C8's bounds (median 0.15 px, 1.5 % over 1 px, max 16 px)
    [median 0.047, none over 1 px, max 0.52], as CLASSIC int8 is held to
    JAX (a statistic one ulp off moves int8 codes downstream).
Against JAX's unsharded forward, float32: 5e-2, the JAX package's own
bound for its sharded forwards (tests/test_parallel.py:101,124).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu import config as jconfig
from hobot_stereonet_tpu.models import FastStereoNet as JFastStereoNet
from hobot_stereonet_tpu.models import StereoNet as JStereoNet
from hobot_stereonet_tpu.runtime.engine import StereoEngine as JStereoEngine
from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine
from hobot_stereonet_tpu_torch.runtime.weights import random_flax_params
from tests import torch_mesh_workers as w

torch.set_num_threads(1)

MESHES = [(2, 2), (1, 4)]
PRECISIONS = [("float32", None), ("bfloat16", None), ("bfloat16", "dynamic"),
              ("bfloat16", "static")]
CASES = [["fast", "float32", None, 4, 1, {}]] + [
    [model, dtype, scheme, d, t, {}] for model in ("fast", "classic")
    for dtype, scheme in PRECISIONS for d, t in MESHES]
MICRO = ["fast", "float32", None, 2, 2, {"device_microbatch": 2, "batch_buckets": [4],
                                         "max_batch": 4}]
BAD_M = ["fast", "float32", None, 2, 2, {"device_microbatch": 1}]
NO_BUCKET = ["fast", "float32", None, 4, 1, {"batch_buckets": [1, 2], "max_batch": 2}]
STREAMS = [["fast", "float32", None, 2, 2, {"inflight": 2}],
           ["classic", "bfloat16", "static", 1, 4, {"inflight": 2}]]

F32_PX, F32_CONF = 5e-5, 5e-6
BF16_BOUNDS = (0.03, 0.0005, 8.0)
INT8_BOUNDS = (0.15, 0.015, 16.0)
JAX_PX = 5e-2


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return w.spawn("serving", 4, tmp_path_factory.mktemp("serving"), timeout=240,
                   cases=CASES + [MICRO, BAD_M, NO_BUCKET], streams=STREAMS)[0]


@pytest.fixture(scope="module")
def frames():
    return torch.from_numpy(w._frames(4))


def _single(case, frames):
    model, dtype, scheme = case[:3]
    eng = StereoEngine(w.small_config(model, dtype), **w.engine_kwargs(model, dtype, scheme))
    assert eng.mesh is None
    with torch.inference_mode():
        return eng.pipeline(frames)


def _spread(got: torch.Tensor, want: torch.Tensor, bounds) -> tuple:
    err = (got - want).abs()
    stats = (float(err.median()), float((err > 1.0).float().mean()), float(err.max()))
    assert stats[0] <= bounds[0] and stats[1] <= bounds[1] and stats[2] <= bounds[2], stats
    return stats


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c[:5])))
def test_mesh_engine_matches_one_rank(served, frames, case):
    got = served[json.dumps(case)]
    want = _single(case, frames)
    assert got["disparity"].shape == want[0].shape == (4, w.H, w.W)
    assert got["confidence"].shape == want[2].shape == (4, w.H // 8, w.W // 8)
    assert torch.equal(got["flags"], torch.zeros(4))
    dtype, scheme = case[1:3]
    if dtype == "float32":
        torch.testing.assert_close(got["disparity"], want[0], rtol=0, atol=F32_PX)
        torch.testing.assert_close(got["confidence"], want[2], rtol=0, atol=F32_CONF)
        torch.testing.assert_close(got["depth"], want[1], rtol=1e-4, atol=0)
    else:
        _spread(got["disparity"], want[0], BF16_BOUNDS if scheme is None else INT8_BOUNDS)
    assert torch.isfinite(got["depth"]).all()


@pytest.fixture(scope="module")
def jax_outputs(frames):
    """JAX's unsharded engine on the same frames and weights, float32."""
    out = {}
    for model, jmodel in (("fast", JFastStereoNet), ("classic", JStereoNet)):
        jcfg = jconfig.Config(
            camera=jconfig.CameraConfig(width=w.W, height=w.H),
            model=jconfig.StereoNetConfig(compute_dtype=jnp.float32, **w.SMALL),
            preprocess=jconfig.PreprocessConfig(color_space="yuv"))
        params = random_flax_params(w.small_config(model, "float32").model, seed=0, model=model)
        eng = JStereoEngine(jcfg, model=jmodel(jcfg.model), params=params,
                            emit_confidence=True)
        disp, _, conf, _ = eng._pipeline(eng.params, jnp.asarray(frames.numpy()))
        out[model] = (np.asarray(disp), np.asarray(conf))
    return out


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "float32"],
                         ids=lambda c: "-".join(map(str, c[:5])))
def test_mesh_engine_matches_jax_unsharded(served, jax_outputs, case):
    got = served[json.dumps(case)]
    want_d, want_c = jax_outputs[case[0]]
    np.testing.assert_allclose(got["disparity"].numpy(), want_d, rtol=0, atol=JAX_PX)
    np.testing.assert_allclose(got["confidence"].numpy(), want_c, rtol=0, atol=JAX_PX)


def test_mesh_buckets_dropped(served):
    """Buckets that do not divide by ``data`` are dropped; none left raises."""
    by_mesh = {(2, 2): (2, 4, 8), (1, 4): (1, 2, 4, 8), (4, 1): (4, 8)}
    for case in CASES:
        assert served[json.dumps(case)]["buckets"] == by_mesh[tuple(case[3:5])]
    assert "no batch bucket divisible by mesh data=4" in served[json.dumps(NO_BUCKET)]["error"]


def test_mesh_device_microbatch_composes(served):
    """``device_microbatch=2`` over data = 2 (each chunk split 1 / 1) equals
    the unchunked mesh engine to 1e-5; an ``m`` the data axis cannot split
    raises at construction."""
    plain = served[json.dumps(CASES[1])]
    micro = served[json.dumps(MICRO)]
    assert micro["buckets"] == (4,)
    torch.testing.assert_close(micro["disparity"], plain["disparity"], rtol=0, atol=1e-5)
    assert "device_microbatch=1 must be a multiple of the mesh data axis (2)" in \
        served[json.dumps(BAD_M)]["error"]


@pytest.mark.parametrize("case", STREAMS, ids=lambda c: "-".join(map(str, c[:5])))
def test_mesh_engine_streams(served, frames, case):
    """Frames fed to rank 0 and polled from it: every frame once, each equal
    to the same mesh's synchronous dispatch of the batch."""
    got = served[json.dumps(case)]
    sync = served[json.dumps(case[:5] + [{}])]
    assert sorted(got["stream"]) == [0, 1, 2, 3]
    assert got["batches"]["n"] >= 1
    for i, disp in got["stream"].items():
        assert disp.shape == (w.H, w.W) and np.isfinite(disp).all()
        if got["batches"]["n"] == 1:        # one dispatch of all 4: the same batch
            np.testing.assert_array_equal(disp, sync["disparity"][i].numpy())


def test_mesh_refusals_without_ranks():
    """No process group holds one rank: a mesh of two refuses, as the JAX
    package's ``make_mesh`` with too few devices; a (1, 1) config serves on
    one device."""
    cfg = w.small_config("fast", "float32", data=2)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        StereoEngine(cfg, device="cpu")
    assert StereoEngine(w.small_config("fast", "float32"), device="cpu").mesh is None
