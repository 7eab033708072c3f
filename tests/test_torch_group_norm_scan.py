"""The GroupNorm kernel's exact parallel scan and its fused entry, on the CPU.

``ops/kernels/group_norm.py`` holds a numpy model of the statistics
kernel's algorithm (``scan_sums_model``: segments of 32 runs, the
predicted binades, the parity maps and their composition, the windows of
segments, the fallbacks run by run and step by step).  Tolerances and why:

  * the model's chains equal the step-by-step float32 chains bit for bit
    (``s1 += x``, ``s2 = fma(x, x, s2)``), in bf16 and float32, on the
    cases of ``tests/test_torch_group_norm.py``'s blocked-sum test, a
    random walk about zero, values over 16 octaves and the trained
    flagship's own GroupNorm inputs: the scan is exact by construction;
  * the map composition is associative (any combination tree of a warp's
    shuffles gives the sequential fold's maps);
  * the fused entry (``group_norm_fused``) equals the unfused ops, forward
    and gradients, bit for bit, bf16 and float32, with and without the
    conv bias and the skip, 2-D and 3-D: on the CPU it computes those ops,
    and its backward reproduces their autograd's;
  * the networks' blocks, now calling the fused entry, equal the unfused
    composition bit for bit, forward and gradients.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hobot_stereonet_tpu_torch import reference
from hobot_stereonet_tpu_torch.config import Config
from hobot_stereonet_tpu_torch.models import FastStereoNet
from hobot_stereonet_tpu_torch.models.layers import (
    GN_EPS, ConvBlock, ConvBlock3D, GroupNorm, ResBlock2D, cast_convs, num_groups)
from hobot_stereonet_tpu_torch.ops.kernels import build
from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg
from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params


def _step_by_step(a: np.ndarray, bf16: bool):
    """The one-thread chains over axis 1 of float32 a [N, P, C]."""
    s1 = np.cumsum(a, axis=1, dtype=np.float32)[:, -1]
    if bf16:                                   # x * x rounded to float32, then added
        with np.errstate(over="ignore", invalid="ignore"):
            return s1, np.cumsum(a * a, axis=1, dtype=np.float32)[:, -1]
    y = np.square(a.astype(np.float64))
    s = np.zeros((a.shape[0], a.shape[2]))
    with np.errstate(over="ignore", invalid="ignore"):
        for p in range(a.shape[1]):
            s = kg.add_f32(y[:, p], s).astype(np.float64)
    return s1, s.astype(np.float32)


def _inputs(kind: str, rng) -> np.ndarray:
    if kind == "normal":
        return 3 * rng.standard_normal((2, 5000, 12)) + 5
    if kind == "ties":           # few-bit values: steps half-way between float32 values
        return rng.integers(-3000, 3001, (2, 6000, 4)) * 0.5
    if kind == "subnormal":
        return rng.standard_normal((1, 1500, 4)) * 1e-22
    if kind == "overflow":
        return rng.standard_normal((1, 1500, 4)) * 1e18
    if kind == "decaying":       # zeros, then magnitudes falling by 1e6
        a = rng.standard_normal((2, 5000, 4)) * np.logspace(3, -3, 5000)[None, :, None]
        a[:, :100] = 0
        return a
    if kind == "walk":           # mean zero: the s1 chains wander about zero
        return rng.standard_normal((2, 12000, 4))
    if kind == "octaves":
        return rng.standard_normal((1, 6000, 4)) * 2.0 ** rng.integers(-8, 8, (1, 6000, 4))
    a = rng.standard_normal((1, 3000, 4))        # "non-finite"
    a[0, 5, 1], a[0, 2000, 2], a[0, 40, 3] = np.nan, np.inf, -np.inf
    return a


def _bits_equal(got, want) -> bool:
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.array_equal(np.isnan(g), np.isnan(w)) and np.array_equal(
        np.where(np.isnan(g), 0, g).view(np.int32), np.where(np.isnan(w), 0, w).view(np.int32))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("kind", ["normal", "ties", "subnormal", "overflow", "decaying",
                                  "non-finite", "walk", "octaves"])
def test_scan_model_equals_the_step_by_step_chains(kind, bf16):
    a = _inputs(kind, np.random.default_rng(5)).astype(np.float32)
    if bf16:
        a = torch.from_numpy(a).bfloat16().float().numpy()
    s1, s2, counts = kg.scan_sums_model(a, bf16)
    w1, w2 = _step_by_step(a, bf16)
    assert _bits_equal(s1, w1) and _bits_equal(s2, w2)
    assert counts["positions"] == 2 * a.size


def test_scan_model_short_runs_and_ragged_segments():
    """Run lengths other than the kernel's, and P not a multiple of a
    segment: the same bits."""
    a = (3 * np.random.default_rng(6).standard_normal((1, 1000, 3)) + 1).astype(np.float32)
    w1, w2 = _step_by_step(a, False)
    for r in (2, 6, 10):
        s1, s2, _ = kg.scan_sums_model(a, False, r=r)
        assert _bits_equal(s1, w1) and _bits_equal(s2, w2)


@pytest.fixture(scope="module")
def flagship_gn_inputs():
    """The trained flagship's GroupNorm inputs (conv output + bias, bf16)
    on a held-out scene at 128x256."""
    cfg = Config.from_json("checkpoints/flagship/config.json")
    mcfg = dataclasses.replace(cfg.model, compute_dtype=torch.bfloat16)
    net = FastStereoNet(mcfg, device="cpu")
    net.load_state_dict(from_flax_params(reference.load_params(), mcfg))
    net = cast_convs(net, torch.bfloat16).eval()
    seen = []

    def hook(mod, args, kwargs):
        x, cb = args[0], kwargs.get("conv_bias")
        a = x if cb is None else x + cb.to(x.dtype).view(1, -1, 1, 1)
        seen.append(a.movedim(1, -1).reshape(a.shape[0], -1, a.shape[1]).float().numpy())

    for m in net.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_pre_hook(hook, with_kwargs=True)
    scene = reference.heldout_dataset()[0]
    left = torch.from_numpy(np.asarray(scene.left[:128, :256], np.float32) / 127.5 - 1)[None]
    right = torch.from_numpy(np.asarray(scene.right[:128, :256], np.float32) / 127.5 - 1)[None]
    with torch.inference_mode():
        net(left, right)
    return seen


@pytest.mark.parametrize("index", [0, 1, 3, 24])
def test_scan_model_on_trained_activations(flagship_gn_inputs, index):
    a = flagship_gn_inputs[index][:1, :, :8]
    s1, s2, _ = kg.scan_sums_model(a, True)
    w1, w2 = _step_by_step(a, True)
    assert _bits_equal(s1, w1) and _bits_equal(s2, w2)


def _random_maps(rng, n):
    """Maps of runs of random steps under one binade."""
    v = rng.standard_normal((n, 16)) * 2.0 ** rng.integers(-3, 6, (n, 1))
    key = kg.scan_key(np.float32(1000.0))
    return kg.scan_run_maps(np.round(v * 4) / 4 * 2.0 ** -14, np.ones(v.shape, bool),
                            np.full(n, key), True)


def test_map_composition_is_associative():
    rng = np.random.default_rng(7)
    m = _random_maps(rng, 32)
    fold = kg._fold(m)[-1]
    tree = m.copy()                            # a warp's shuffle tree
    while len(tree) > 1:
        tree = np.stack([kg.scan_compose(tree[i], tree[i + 1]) for i in range(0, len(tree), 2)])
    assert np.array_equal(fold, tree[0])
    for f, g, h in rng.integers(0, 32, (50, 3)):
        left = kg.scan_compose(kg.scan_compose(m[f], m[g]), m[h])
        right = kg.scan_compose(m[f], kg.scan_compose(m[g], m[h]))
        assert np.array_equal(left, right)


def test_a_map_applied_is_the_chain():
    """A run's map applied to a start that is a multiple of its spacing gives
    the chain's bits wherever its check passes; the check passes for most
    runs that stay below 2^24 spacings, also across binades."""
    rng = np.random.default_rng(8)
    passed = 0
    for _ in range(300):
        s0 = np.float32(np.round(rng.uniform(1100, 1900) * 64) / 64 * rng.choice([-1, 1]))
        v = np.round(rng.standard_normal(16) * rng.choice([1, 8, 64]) * 16) / 32
        v[rng.random(16) < 0.2] *= 2.0 ** -18              # a few steps that round
        key = kg.scan_key(1500.0)                          # the binade [1024, 2048)
        k = kg._start(s0, key)
        m = kg.scan_run_maps(v[None], np.ones((1, 16), bool), np.array([key]), True)[0]
        s = s0
        for x in v:
            s = np.float32(s + np.float32(x))
        if kg._range_ok(m, k, key):
            passed += 1
            assert kg._value(k + int(m[k & 1]), key) == s
    assert passed >= 100


def test_workspace_and_run_length():
    for c in (1, 3, 8, 12, 16, 32, 64, 256):
        r = kg.scan_run_length(c)
        assert r % 2 == 0 and 2 <= r <= 128 and (r * c * 2) % 4 == 0
    assert kg.workspace_bytes(1, 12, 921600, 42, False) % 256 == 0
    assert kg.workspace_bytes(2, 12, 921600, 42, False) > kg.workspace_bytes(1, 12, 921600, 42,
                                                                             False)
    # The walk in order keeps no segment maps: the chains, (scale, shift), barrier.
    assert kg.workspace_bytes(64, 32, 230400, 16, True) == 64 * 32 * 8 + 64 * 32 * 8 + 256
    assert kg.walks_in_order(64, 32) and not kg.walks_in_order(2, 32)
    assert not kg.walks_in_order(16, 32) and not kg.walks_in_order(32, 12)


# ---------------------------------------------------------------------------
# The fused entry against the unfused ops
# ---------------------------------------------------------------------------

def _fused_case(shape, dtype, bias_dtype, skip, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[1]
    fmt = torch.channels_last_3d if len(shape) == 5 else torch.channels_last
    x = torch.from_numpy((3 * rng.standard_normal(shape)).astype(np.float32)).to(dtype)
    x = x.contiguous(memory_format=fmt)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32))
    cb = (torch.from_numpy(rng.uniform(-2, 2, c).astype(np.float32)).to(bias_dtype)
          if bias_dtype is not None else None)
    sk = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
          .contiguous(memory_format=fmt) if skip else None)
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return x, num_groups(c), w, b, cb, sk, dy.contiguous(memory_format=fmt)


def _unfused(x, g, w, b, cb, sk, activate):
    a = x if cb is None else x + cb.to(x.dtype).view((1, -1) + (1,) * (x.dim() - 2))
    h = kg.group_norm(a, g, w, b, GN_EPS)
    r = h if sk is None else sk + h
    return kg.leaky_relu(r) if activate else r


FUSED = [  # shape, dtype, conv bias dtype, skip, activate
    ((2, 16, 20, 24), torch.bfloat16, torch.float32, False, True),
    ((2, 16, 20, 24), torch.bfloat16, torch.float32, True, True),
    ((2, 16, 20, 24), torch.bfloat16, torch.bfloat16, True, True),
    ((2, 16, 20, 24), torch.bfloat16, None, True, True),
    ((2, 16, 20, 24), torch.bfloat16, None, False, True),
    ((2, 12, 3, 10, 12), torch.bfloat16, torch.float32, False, True),
    ((2, 16, 20, 24), torch.float32, torch.float32, False, True),
    ((2, 16, 20, 24), torch.float32, torch.float32, True, True),
    ((2, 12, 3, 10, 12), torch.float32, None, False, True),
    ((2, 16, 20, 24), torch.bfloat16, torch.float32, True, False),
]


@pytest.mark.parametrize("shape,dtype,bias_dtype,skip,activate", FUSED)
def test_fused_entry_equals_the_unfused_ops(shape, dtype, bias_dtype, skip, activate):
    x, g, w, b, cb, sk, dy = _fused_case(shape, dtype, bias_dtype, skip)
    grads = []
    for fused in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b, cb, sk) if t is not None]
        it = iter(leaves)
        xi, wi, bi = next(it), next(it), next(it)
        cbi = next(it) if cb is not None else None
        ski = next(it) if sk is not None else None
        if fused:
            out = kg.group_norm_fused(xi, g, wi, bi, GN_EPS, conv_bias=cbi, skip=ski,
                                      activate=activate)
        else:
            out = _unfused(xi, g, wi, bi, cbi, ski, activate)
        out.backward(dy)
        grads.append([out] + [t.grad for t in leaves])
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and got.stride() == want.stride()
        assert torch.equal(got, want)


def test_fused_entry_counts_no_launch_on_the_cpu():
    x, g, w, b, cb, sk, _ = _fused_case((1, 16, 8, 8), torch.bfloat16, torch.float32, True)
    n0 = dict(build.launch_counts)
    with torch.inference_mode():
        kg.group_norm_fused(x, g, w, b, GN_EPS, conv_bias=cb, skip=sk, activate=True)
    assert dict(build.launch_counts) == n0


def _old_block_forward(block, x):
    """The blocks' forward as written before the fusion: the conv with its
    bias, the GroupNorm, the residual add and LeakyReLU as separate ops."""
    if isinstance(block, ResBlock2D):
        h = block.GroupNorm_0(block.Conv_0(_old_block_forward(block.ConvBlock_0, x)))
        return kg.leaky_relu(x + h)
    return kg.leaky_relu(block.GroupNorm_0(block.Conv_0(x)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["conv", "res", "conv3d"])
def test_blocks_equal_the_unfused_composition(kind, dtype):
    torch.manual_seed(0)
    block, shape = {"conv": (ConvBlock(8, 16), (2, 8, 12, 20)),
                    "res": (ResBlock2D(16, dilation=2), (2, 16, 12, 20)),
                    "conv3d": (ConvBlock3D(8, 16), (1, 8, 4, 10, 12))}[kind]
    block = block.to(dtype)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, GroupNorm):
                m.float().weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
                m.bias.uniform_(-1, 1)
    fmt = torch.channels_last_3d if len(shape) == 5 else torch.channels_last
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    x = x.contiguous(memory_format=fmt)
    outs = []
    for fn in (block, lambda t: _old_block_forward(block, t)):
        block.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        out = fn(xi)
        out.float().square().sum().backward()
        outs.append([out, xi.grad] + [p.grad for p in block.parameters()])
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_module_unfused_call_is_unchanged():
    """``GroupNorm_0(x)`` alone is the plain GroupNorm; float64 takes ATen's."""
    gn = GroupNorm(16)
    x, g, w, b, cb, sk, _ = _fused_case((2, 16, 8, 8), torch.bfloat16, torch.float32, True)
    with torch.no_grad():
        gn.weight.copy_(w)
        gn.bias.copy_(b)
        assert torch.equal(gn(x), kg.group_norm_plain(x, g, w, b, GN_EPS)[0])
        x64, cb64, sk64 = x.double(), cb.double(), sk.double()
        want = kg.leaky_relu(sk64 + F.group_norm(x64 + cb64.view(1, -1, 1, 1), g, w.double(),
                                                 b.double(), GN_EPS))
        assert torch.equal(gn(x64, conv_bias=cb64, skip=sk64, activate=True), want)
