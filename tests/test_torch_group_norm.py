"""The port's GroupNorm (``ops/kernels/group_norm.py``) on the CPU, and the
float32 precision guard (``utils/precision.py``).

``group_norm_plain`` computes ATen's one-thread statistics of a
channels-last input.  Tolerances and why:

  * bf16 input, spatial size >= 1024 (where ATen's channels-last kernel
    sums each channel over the positions in order): equal to
    ``torch.ops.aten.native_group_norm`` at one thread, bit for bit, output
    and statistics;
  * float32 input: the statistics within float32 summation error of
    float64 ones (mean to 1e-5 of a standard deviation, rstd to 1e-4
    relative, as tests/test_torch_reference.py holds them against flax's;
    measured at most 1.8e-6 and 2e-6 here), and equal to ATen's one-thread
    ones at these sizes as well;
  * against flax's ``GroupNorm`` (the reference), float32: within 1e-5 of
    the output's scale, the two computing the same statistics in other
    orders;
  * the same bits at 1 and 4 threads and for a sample in any batch: each
    (sample, channel) sum is one chain in a fixed order;
  * the backward (ATen's, fed the forward's statistics) bit for bit
    ``F.group_norm``'s autograd where the statistics are ATen's too.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hobot_stereonet_tpu_torch import config as tconfig
from hobot_stereonet_tpu_torch.models import build_model
from hobot_stereonet_tpu_torch.models.layers import GN_EPS, GroupNorm, num_groups
from hobot_stereonet_tpu_torch.ops.kernels import build
from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg
from hobot_stereonet_tpu_torch.runtime import training
from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine
from hobot_stereonet_tpu_torch.utils import precision

SPATIAL = {  # spatial size -> (h, w), (d, h, w)
    1024: ((32, 32), (4, 16, 16)),
    3600: ((60, 60), (4, 30, 30)),
    14400: ((90, 160), (16, 30, 30)),
}


@pytest.fixture()
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _case(n, c, spatial, dtype, seed=0):
    rng = np.random.default_rng(seed)
    fmt = torch.channels_last_3d if len(spatial) == 3 else torch.channels_last
    x = torch.from_numpy((3 * rng.standard_normal((n, c) + spatial) + 5).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32))
    return x.to(dtype).contiguous(memory_format=fmt), num_groups(c), w, b


def _aten(x, g, w, b):
    n, c = x.shape[:2]
    return torch.ops.aten.native_group_norm(x.float(), w, b, n, c, x[0, 0].numel(), g, GN_EPS)


@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("size", sorted(SPATIAL))
@pytest.mark.parametrize("c", [12, 16, 32, 64])
def test_plain_equals_aten_at_one_thread_bf16(one_thread, c, size, rank):
    x, g, w, b = _case(2, c, SPATIAL[size][rank - 2], torch.bfloat16)
    y, mean, rstd = kg.group_norm_plain(x, g, w, b, GN_EPS)
    want, want_mean, want_rstd = _aten(x, g, w, b)
    assert torch.equal(mean, want_mean) and torch.equal(rstd, want_rstd)
    assert y.dtype == torch.bfloat16 and y.stride() == x.stride()
    assert torch.equal(y, want.bfloat16())


@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("c", [12, 32])
def test_plain_statistics_f32(one_thread, c, rank):
    x, g, w, b = _case(3, c, SPATIAL[3600][rank - 2], torch.float32, seed=1)
    _, mean, rstd = kg.group_norm_plain(x, g, w, b, GN_EPS)
    xs = x.double().reshape(3, g, -1)
    sd = xs.std(-1, unbiased=False)
    exact_rstd = 1.0 / torch.sqrt(xs.var(-1, unbiased=False) + GN_EPS)
    assert float(((mean - xs.mean(-1)).abs() / sd).max()) <= 1e-5
    assert float(((rstd - exact_rstd).abs() / exact_rstd).max()) <= 1e-4
    _, want_mean, want_rstd = _aten(x, g, w, b)
    assert torch.equal(mean, want_mean) and torch.equal(rstd, want_rstd)


def test_fma_sums_round_once():
    """The float32 chain's add rounds the exact sum once, also where the
    float64 sum lands half-way between two float32 values."""
    s = np.array([1.0, 1.0, 3.0, 5.0])
    y = np.array([2.0**-24 + 2.0**-60, 2.0**-24 - 2.0**-60, 2.0**-23 + 2.0**-70, 0.25])
    got = kg.add_f32(y, s)
    assert got.tolist() == [1 + 2.0**-23, 1.0, 3 + 2.0**-22, 5.25]


def _fma_chains_step_by_step(a):
    y = np.square(a.astype(np.float64))
    s = np.zeros((a.shape[0], a.shape[2]))
    with np.errstate(over="ignore", invalid="ignore"):
        for p in range(a.shape[1]):
            s = kg.add_f32(y[:, p], s).astype(np.float64)
    return s.astype(np.float32)


def _chain_inputs(kind, rng):
    if kind == "normal":
        return 3 * rng.standard_normal((2, 5000, 12)) + 5
    if kind == "ties":           # few-bit values: squares half-way between float32 values
        return rng.integers(-3000, 3001, (2, 9000, 4)) * 0.5
    if kind == "subnormal":
        return rng.standard_normal((2, 3000, 4)) * 1e-22
    if kind == "overflow":
        return rng.standard_normal((2, 3000, 4)) * 1e18
    if kind == "decaying":       # zeros, then magnitudes falling by 1e6
        a = rng.standard_normal((2, 5000, 4)) * np.logspace(3, -3, 5000)[None, :, None]
        a[:, :100] = 0
        return a
    a = rng.standard_normal((2, 3000, 4))        # "non-finite"
    a[0, 5, 1], a[1, 7, 2] = np.nan, np.inf
    return a


@pytest.mark.parametrize("kind", ["normal", "ties", "subnormal", "overflow", "decaying",
                                  "non-finite"])
def test_blocked_fma_sums_equal_the_step_by_step_chain(kind):
    """The vectorized runs of the float32 square sums give the bits of one
    once-rounded add a position."""
    a = _chain_inputs(kind, np.random.default_rng(5)).astype(np.float32)
    got, want = kg._fma_square_sums(a), _fma_chains_step_by_step(a)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_independent_of_threads(dtype):
    x, g, w, b = _case(2, 32, (45, 80), dtype, seed=2)
    saved = torch.get_num_threads()
    try:
        outs = []
        for threads in (1, 4):
            torch.set_num_threads(threads)
            outs.append(kg.group_norm_plain(x, g, w, b, GN_EPS))
    finally:
        torch.set_num_threads(saved)
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_independent_of_the_batch(dtype):
    x, g, w, b = _case(6, 16, (4, 12, 20), dtype, seed=3)
    whole = kg.group_norm_plain(x, g, w, b, GN_EPS)[0]
    half = torch.cat([kg.group_norm_plain(x[:3], g, w, b, GN_EPS)[0],
                      kg.group_norm_plain(x[3:], g, w, b, GN_EPS)[0]])
    alone = torch.cat([kg.group_norm_plain(x[i:i + 1], g, w, b, GN_EPS)[0] for i in range(6)])
    assert torch.equal(whole, half) and torch.equal(whole, alone)


@pytest.mark.parametrize("rank", [2, 3])
def test_plain_f32_matches_flax(rank):
    """The same inputs through flax's ``GroupNorm`` (the reference's, NHWC /
    NDHWC) and the port's."""
    import flax.linen as nn

    x, g, w, b = _case(2, 32, SPATIAL[1024][rank - 2], torch.float32, seed=4)
    xj = np.moveaxis(x.numpy(), 1, -1)
    gn = nn.GroupNorm(num_groups=g, dtype=jnp.float32)
    params = {"params": {"scale": jnp.asarray(w.numpy()), "bias": jnp.asarray(b.numpy())}}
    want = np.asarray(gn.apply(params, jnp.asarray(xj)))
    got = np.moveaxis(kg.group_norm_plain(x, g, w, b, GN_EPS)[0].numpy(), 1, -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_plain_takes_any_memory_format():
    """Positions in logical (h, w) order whatever the memory format; the
    output keeps the input's."""
    x, g, w, b = _case(2, 16, (40, 30), torch.bfloat16, seed=5)
    y, mean, rstd = kg.group_norm_plain(x, g, w, b, GN_EPS)
    y2, mean2, rstd2 = kg.group_norm_plain(x.contiguous(), g, w, b, GN_EPS)
    assert torch.equal(mean, mean2) and torch.equal(rstd, rstd2) and torch.equal(y, y2)
    assert y2.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_equals_f_group_norm(one_thread, dtype):
    """Given the same statistics (ATen's forward at one thread equals the
    port's here), the module's gradients are ``F.group_norm``'s, bit for bit."""
    x, g, w, b = _case(2, 32, (32, 48), dtype, seed=6)
    dy = torch.from_numpy(np.random.default_rng(7).standard_normal(x.shape).astype(np.float32))
    dy = dy.to(dtype).contiguous(memory_format=torch.channels_last)
    grads = []
    for fn in (lambda xi, wi, bi: kg.group_norm(xi, g, wi, bi, GN_EPS),
               lambda xi, wi, bi: F.group_norm(xi.float(), g, wi, bi, GN_EPS).to(dtype)):
        xi, wi, bi = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = fn(xi, wi, bi)
        y.backward(dy)
        grads.append((y, xi.grad, wi.grad, bi.grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_module_runs_the_plain_version_on_the_cpu():
    x, _, w, b = _case(2, 12, (40, 40), torch.bfloat16, seed=8)
    gn = GroupNorm(12)
    with torch.no_grad():
        gn.weight.copy_(w)
        gn.bias.copy_(b)
    n0 = dict(build.launch_counts)
    with torch.inference_mode():
        got = gn(x)
    assert torch.equal(got, kg.group_norm_plain(x, gn.num_groups, w, b, GN_EPS)[0])
    assert dict(build.launch_counts) == n0
    x64 = x.double()
    assert torch.equal(gn(x64), F.group_norm(x64, gn.num_groups, w.double(), b.double(), GN_EPS))


def test_refuses_what_it_does_not_take():
    x, g, w, b = _case(1, 32, (32, 32), torch.bfloat16)
    with pytest.raises(TypeError):
        kg.group_norm(x.half(), g, w, b, GN_EPS)
    with pytest.raises(ValueError, match="divide"):
        kg.group_norm(x, 5, w, b, GN_EPS)
    with pytest.raises(ValueError, match="unsupported device"):
        kg.group_norm(x.to("meta"), g, w.to("meta"), b.to("meta"), GN_EPS)


@pytest.mark.parametrize("model", ["fast", "classic"])
def test_every_groupnorm_input_is_channels_last(model):
    """On a 256x512 scene, every GroupNorm of both networks gets a
    channels-last (2-D) or channels_last_3d (3-D) input: an NCHW-contiguous
    one would send ATen down another path, and the kernel refuses it."""
    cfg = tconfig.StereoNetConfig(compute_dtype=torch.bfloat16)
    if model == "fast":
        cfg = tconfig.Config.from_json("checkpoints/flagship/config.json").model
    torch.manual_seed(0)
    net = build_model(model, cfg, "cpu").eval()
    seen = []
    for m in net.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    x = torch.rand((1, 256, 512, 3)) * 2 - 1
    with torch.inference_mode():
        net(x, torch.roll(x, -3, 2))
    assert len(seen) == {"fast": 25, "classic": 48}[model]
    for t in seen:
        fmt = torch.channels_last_3d if t.dim() == 5 else torch.channels_last
        assert t.is_contiguous(memory_format=fmt) and t.stride(1) == 1, tuple(t.shape)
        assert t.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# float32 without TF32 (utils/precision.py)
# ---------------------------------------------------------------------------

def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def test_float32_exact_sets_and_restores_both_flags():
    saved = _flags()
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
        with precision.float32_exact():
            assert _flags() == (False, False)
            with precision.float32_exact():
                assert _flags() == (False, False)
            assert _flags() == (False, False)
        assert _flags() == (True, True)
        with pytest.raises(RuntimeError):
            with precision.float32_exact():
                raise RuntimeError("restored on the way out")
        assert _flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_exact_float32_only_for_float32_on_the_card():
    assert isinstance(precision.exact_float32(torch.float32, "cpu"), type(
        precision.exact_float32(torch.bfloat16, "cuda:0")))
    assert not isinstance(precision.exact_float32(torch.float32, "cuda:0"),
                          type(precision.exact_float32(torch.float32, "cpu")))


SMALL = dict(feature_channels=8, num_feature_res_blocks=1, num_aggregation_layers=1,
             aggregation_channels=8, num_refinement_res_blocks=1, refinement_channels=8,
             max_disparity=32)


def _read_tf32(module):
    """Record the TF32 flags that ``module``'s first conv reads in its
    forward and in its backward."""
    seen = {}

    def hook(key):
        def read(*args):
            seen.setdefault(key, _flags())      # returns None: changes no argument
        return read

    conv = module.FeatureTower_0.ConvBlock_0.Conv_0
    conv.register_forward_pre_hook(hook("forward"))
    conv.register_full_backward_pre_hook(hook("backward"))
    return seen


@pytest.mark.parametrize("model", ["fast", "classic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_and_train_step_enter_float32_exact_on_the_card(monkeypatch, model, dtype):
    """With the device check answering "CUDA" for the CPU, the float32
    engine's network and the float32 train step's forward and backward run
    with TF32 off; bf16 leaves the flags as they are."""
    monkeypatch.setattr(precision, "on_card", lambda device: True)
    saved = _flags()
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
        h, w = 64, 128
        mcfg = tconfig.StereoNetConfig(compute_dtype=dtype, **SMALL)
        cfg = dataclasses.replace(
            tconfig.Config(), model=mcfg, camera=tconfig.CameraConfig(width=w, height=h),
            engine=tconfig.EngineConfig(max_batch=1, batch_buckets=(1,)))
        eng = StereoEngine(cfg, device="cpu", model=model)
        seen = _read_tf32(eng.model)
        frames = torch.from_numpy(np.random.default_rng(9).integers(
            0, 256, (1, 3 * h * w), dtype=np.uint8))
        eng.pipeline(frames)
        want = (False, False) if dtype == torch.float32 else (True, True)
        assert seen == {"forward": want} and _flags() == (True, True)

        net = build_model(model, mcfg, "cpu")
        opt = training.make_optimizer()
        state = training.create_train_state(net, torch.Generator().manual_seed(0), opt)
        seen = _read_tf32(net)
        rng = np.random.default_rng(10)
        left, right = (torch.from_numpy(rng.uniform(-1, 1, (1, 32, 64, 3)).astype(np.float32))
                       for _ in range(2))
        gt = torch.from_numpy(rng.uniform(1, 20, (1, 32, 64)).astype(np.float32))
        training.make_train_step(net, opt, 32.0)(state, left, right, gt)
        assert seen == {"forward": want, "backward": want} and _flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
