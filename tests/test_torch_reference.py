"""The port's bf16 network against the JAX package's, rounding for rounding,
and the reference data the port carries (``hobot_stereonet_tpu_torch/reference``).

The reference here is JAX on the CPU under
``XLA_FLAGS=--xla_allow_excess_precision=false``.  By default XLA keeps
bf16 values in float32 inside a fusion, so it skips roundings that the
flax code asks for; with the flag off it rounds where flax does, as the
port does.  The flag is read once per process and tests/conftest.py sets
``XLA_FLAGS`` for the whole suite, so the reference runs in a subprocess
(this file, run as a script) and hands its arrays back as an ``.npz``.

Tolerances:
  * Each bf16 block, fed the reference's own input to that block: a plain
    conv at least 99.9 % of its outputs bit-equal, a block with a
    GroupNorm (ConvBlock, ResBlock2D, the mask head's hidden layer) at
    least 99.5 %.  Both sides round at the same points; a conv alone is
    99.99 % bit-equal.  What holds the blocks with a GroupNorm below
    99.9 % is the GroupNorm's float32 statistics: flax sums them as
    E[x^2] - E[x]^2 in XLA's order, and its variance lies up to 7.3e-5
    (mean 9.6e-6) below the exact one, relative.  Any statistics computed
    another way move a whole group's outputs across bf16 rounding
    boundaries.  Measured on
    the CPU at one thread (the block share, least and mean over the 15
    blocks): ATen's ``group_norm`` (the port's) 99.56 % and 99.82 %;
    exact statistics (float64) 98.87 % and 99.63 %; flax's formula with
    float32 sums in PyTorch's order 98.81 % and 99.59 %, with sequential
    float32 sums or float64 sums rounded to float32 98.87 % and 99.63 %.
    ATen's share moves with the thread count (least 99.20 % at six
    threads), so this module runs at one.
    Fed the reference's own statistics, flax's normalization reproduces
    the reference's GroupNorm output to 99.99 %: the statistics are the
    whole difference, and
    :func:`test_groupnorm_matches_reference` holds the port's to within
    float32 summation error of flax's.  Blocks are not chained to each
    other: chained, the ties compound.
  * The committed weights: byte for byte what ``save_flax_npz`` writes from
    ``checkpoints/flagship/params``.  The committed two-scene outputs: what
    the reference computes now, to 1e-4 px and confidence 1e-5 (the same
    program on the same inputs; the margin covers another host CPU's
    vector width).
  * The whole network in float32 against the committed output: 1e-3 px
    and 1e-4 confidence, as tests/test_torch_model.py holds it.
  * The whole network in bf16 on the two 256x512 scenes and on the 720p
    frame: see :func:`test_bf16_network_on_trained_scenes` and
    :func:`test_bf16_network_at_720p`.

Regenerate the committed data (needs JAX, flax and orbax; about five
minutes on a CPU) with::

    python tests/test_torch_reference.py --write

Print the per-block shares above for each way of computing the GroupNorm's
statistics (about a minute) with::

    python tests/test_torch_reference.py --groupnorm-variants [--threads N]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hobot_stereonet_tpu_torch.reference import (  # noqa: E402
    CALIB_JSON, HELDOUT, INT8_OUTPUTS_NPZ, INT8_SCHEMES, OUTPUTS_NPZ, PARAMS_NPZ, REF_DIR, SCENES,
    frame_720p, heldout_dataset)
from hobot_stereonet_tpu_torch.reference import XLA_FLAGS as NO_EXCESS  # noqa: E402

CHECKPOINT = ROOT / "checkpoints" / "flagship" / "params"

TOWER = (["FeatureTower_0/ConvBlock_%d" % i for i in range(3)]
         + ["FeatureTower_0/ResBlock2D_%d" % i for i in range(6)]
         + ["FeatureTower_0/Conv_0"])
AGG = (["CorrelationAggregation2D_0/ConvBlock_0"]
       + ["CorrelationAggregation2D_0/ResBlock2D_%d" % i for i in range(4)]
       + ["CorrelationAggregation2D_0/Conv_0"])
MASK = ["upsample_mask_hidden", "upsample_mask"]
BLOCKS = TOWER + AGG + MASK
GROUPNORM_BLOCKS = [b for b in BLOCKS if not b.endswith("Conv_0") and b != "upsample_mask"]


def _block_inputs() -> dict:
    """Each block -> the block whose output is its input (None: the model
    input, "agg_input": the aggregation's input)."""
    prev = {}
    chain = [None] + TOWER
    for a, b in zip(chain, TOWER):
        prev[b] = a
    chain = ["agg_input"] + AGG[:-1]
    for a, b in zip(chain, AGG):
        prev[b] = a
    prev["upsample_mask_hidden"] = AGG[-2]
    prev["upsample_mask"] = "upsample_mask_hidden"
    return prev


# ---------------------------------------------------------------------------
# The reference (JAX), run as a script in a process of its own
# ---------------------------------------------------------------------------

def _jax_reference(out_path: str, full: bool) -> None:
    """Compute the reference arrays into ``out_path`` (an ``.npz``).

    Always: the two scenes' model input, disparity and confidence in f32
    and bf16, and every block's bf16 output (``inter/<block>``) with the
    aggregation's input; the two scenes' bf16 disparity run w8a8 in each
    scheme (``int8_<scheme>_disparity``).  With ``full``: the 720p frame's
    bf16 disparity and the per-scene EPE of the 120 held-out scenes, in
    bf16 and in each int8 scheme.
    """
    assert NO_EXCESS in os.environ.get("XLA_FLAGS", ""), "run under " + NO_EXCESS
    import jax
    import jax.numpy as jnp
    from flax.linen.normalization import _compute_stats

    from hobot_stereonet_tpu.config import Config, PreprocessConfig, StereoNetConfig
    from hobot_stereonet_tpu.data.loader import SyntheticStereoDataset
    from hobot_stereonet_tpu.models import FastStereoNet
    from hobot_stereonet_tpu.ops import preprocess as jpp
    from hobot_stereonet_tpu.ops import quant as jq
    from hobot_stereonet_tpu.ops.cost_volume import build_correlation_volume
    from hobot_stereonet_tpu.runtime.checkpoint import load_params

    params = jax.tree_util.tree_map(np.asarray, load_params(str(CHECKPOINT)))
    yuv = PreprocessConfig(color_space="yuv")
    ds = SyntheticStereoDataset(**HELDOUT)
    x = np.concatenate([np.asarray(jpp.rgb_pair_to_model_input(ds[i].left, ds[i].right, yuv))
                        for i in SCENES])
    left, right = jnp.asarray(x[..., :3]), jnp.asarray(x[..., 3:])
    out = {"xla_flags": np.array(os.environ["XLA_FLAGS"]), "jax_version": np.array(jax.__version__),
           "scenes": np.array(SCENES), "model_input": x}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        o = jax.jit(FastStereoNet(StereoNetConfig(compute_dtype=dt)).apply)(params, left, right)
        out[f"{name}_disparity"] = np.asarray(o["disparity"])
        out[f"{name}_confidence"] = np.asarray(o["confidence"])

    cfg = StereoNetConfig()
    _, inter = jax.jit(lambda p, l, r: FastStereoNet(cfg).apply(
        p, l, r, capture_intermediates=True))(params, left, right)
    inter = inter["intermediates"]
    for block in BLOCKS:
        node = inter
        for part in block.split("/"):
            node = node[part]
        out["inter/" + block] = np.asarray(node["__call__"][0].astype(jnp.float32))
        if "GroupNorm_0" in node:
            for sub in ("Conv_0", "GroupNorm_0"):
                out[f"inter/{block}/{sub}"] = np.asarray(
                    node[sub]["__call__"][0].astype(jnp.float32))
            # flax's own GroupNorm statistics of that conv output, [N, groups]
            x = node["Conv_0"]["__call__"][0]
            c = x.shape[-1]
            g = next(k for k in (8, 4, 2, 1) if c % k == 0)
            mean, var = jax.jit(lambda x: _compute_stats(
                x.reshape(x.shape[:-1] + (g, c // g)), [1, 2, 4], x.dtype))(x)
            out[f"stats/{block}/mean"] = np.asarray(mean)
            out[f"stats/{block}/var"] = np.asarray(var)
    feats = inter["FeatureTower_0"]["__call__"][0]
    b = len(SCENES)
    corr = jnp.transpose(jax.jit(build_correlation_volume, static_argnums=2)(
        feats[:b], feats[b:], cfg.num_disparities_coarse), (0, 2, 3, 1))
    agg_in = jnp.concatenate([corr.astype(jnp.bfloat16), feats[:b].astype(jnp.bfloat16)], -1)
    out["agg_input"] = np.asarray(agg_in.astype(jnp.float32))

    model = FastStereoNet(cfg)
    h, w = HELDOUT["height"], HELDOUT["width"]
    static = jq.make_static_quant(model, params, str(CALIB_JSON), h, w)
    int8 = {"dynamic": dict(int8=True), "static": dict(static_quant=static)}
    for scheme, kw in int8.items():
        fn = jq.make_apply_fn(model, **kw)
        out[f"int8_{scheme}_disparity"] = np.asarray(jax.jit(fn)(params, left, right)["disparity"])

    if full:
        sbs = frame_720p()
        x720 = jpp.side_by_side_nv12_to_model_input(jnp.asarray(sbs), 720, 2560, yuv)
        o = jax.jit(FastStereoNet(cfg).apply)(params, x720[..., :3], x720[..., 3:])
        out["bf16_720p_disparity"] = np.asarray(o["disparity"][0])
        from hobot_stereonet_tpu.runtime.evaluate import evaluate_dataset

        r = evaluate_dataset(FastStereoNet(cfg), params, ds,
                             dataclasses.replace(Config(), model=cfg, preprocess=yuv))
        out["heldout_epe"] = np.asarray(r.per_frame_epe, np.float64)
        out["heldout_d1"] = np.array(r.d1_all)
        for scheme, kw in int8.items():
            r = evaluate_dataset(model, params, ds, dataclasses.replace(
                Config(), model=cfg, preprocess=yuv), **kw)
            out[f"int8_{scheme}_heldout_epe"] = np.asarray(r.per_frame_epe, np.float64)
            out[f"int8_{scheme}_heldout_d1"] = np.array(r.d1_all)
    np.savez(out_path, **out)


def _run_reference(out_path: Path, full: bool = False) -> dict:
    env = dict(os.environ, XLA_FLAGS=NO_EXCESS, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    args = [sys.executable, __file__, "--reference", str(out_path)] + (["--full"] if full else [])
    proc = subprocess.run(args, env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=3000 if full else 600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with np.load(out_path) as data:
        return {k: data[k] for k in data.files}


def write_committed_data() -> None:
    """Regenerate ``reference/flagship_params.npz``, ``flagship_outputs.npz``
    and ``flagship_int8_outputs.npz``."""
    import tempfile

    import jax

    from hobot_stereonet_tpu.runtime.checkpoint import load_params
    from hobot_stereonet_tpu_torch.runtime.weights import save_flax_npz, write_npz

    REF_DIR.mkdir(exist_ok=True)
    save_flax_npz(jax.tree_util.tree_map(np.asarray, load_params(str(CHECKPOINT))), str(PARAMS_NPZ))
    with tempfile.TemporaryDirectory() as tmp:
        ref = _run_reference(Path(tmp) / "ref.npz", full=True)
    keep = ["xla_flags", "jax_version", "scenes", "f32_disparity", "f32_confidence",
            "bf16_disparity", "bf16_confidence", "bf16_720p_disparity", "heldout_epe",
            "heldout_d1"]
    write_npz(str(OUTPUTS_NPZ), {k: ref[k] for k in keep})
    write_npz(str(INT8_OUTPUTS_NPZ), {
        **{k: ref[k] for k in ("xla_flags", "jax_version", "scenes")},
        **{k.removeprefix("int8_"): ref[k] for k in ref if k.startswith("int8_")}})
    for p in (PARAMS_NPZ, OUTPUTS_NPZ, INT8_OUTPUTS_NPZ):
        print(f"wrote {p.relative_to(ROOT)}: {p.stat().st_size} bytes")


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _run_reference(tmp_path_factory.mktemp("reference") / "ref.npz")


@pytest.fixture(scope="module")
def committed():
    with np.load(OUTPUTS_NPZ) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def params():
    from hobot_stereonet_tpu_torch.runtime.weights import load_flax_npz

    return load_flax_npz(str(PARAMS_NPZ))


def _port_net(params, dtype):
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import FastStereoNet
    from hobot_stereonet_tpu_torch.models.layers import cast_convs
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params

    cfg = StereoNetConfig(compute_dtype=dtype)
    net = FastStereoNet(cfg, device="cpu")
    net.load_state_dict(from_flax_params(params, cfg))
    return cast_convs(net, dtype).eval()


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _submodule(net, block: str):
    mod = net
    for part in block.split("/"):
        mod = getattr(mod, part)
    return mod


@pytest.mark.parametrize("block", BLOCKS)
def test_bf16_block_bit_equal_to_reference(reference, params, block):
    net = _port_net(params, torch.bfloat16)
    src = _block_inputs()[block]
    if src is None:
        x = reference["model_input"]
        x = np.concatenate([x[..., :3], x[..., 3:]])      # both eyes, as the tower runs
    else:
        x = reference[src if src == "agg_input" else "inter/" + src]
    with torch.inference_mode():
        got = _submodule(net, block)(_nchw(x).bfloat16())
    got = got.permute(0, 2, 3, 1).float().numpy()
    want = reference["inter/" + block]
    assert got.shape == want.shape
    equal = float(np.mean(got == want))
    bound = 0.995 if block in GROUPNORM_BLOCKS else 0.999
    assert equal >= bound, (block, equal, float(np.abs(got - want).max()))


@pytest.mark.parametrize("block", GROUPNORM_BLOCKS)
def test_groupnorm_matches_reference(reference, params, block):
    """The port's GroupNorm (bf16 in and out), fed the reference's conv
    output: its float32 statistics within float32 summation error of
    flax's (|mean| to 1e-5 of a standard deviation, 1/std to 1e-4
    relative; measured at most 6.1e-7 and 2.8e-5), and at least 99.6 % of
    its outputs bit-equal to the reference's GroupNorm (measured least
    99.67 %, mean 99.89 %; ``--groupnorm-variants``)."""
    gn = _submodule(_port_net(params, torch.bfloat16), block).GroupNorm_0
    x = _nchw(reference[f"inter/{block}/Conv_0"]).bfloat16()
    b, c, h, w = x.shape
    with torch.inference_mode():
        got = gn(x)
        y, mean, rstd = torch.ops.aten.native_group_norm(       # what F.group_norm computes
            x.float(), gn.weight.float(), gn.bias.float(), b, c, h * w, gn.num_groups, gn.eps)
    assert torch.equal(got, y.bfloat16())
    ref_mean = torch.from_numpy(reference[f"stats/{block}/mean"]).view(b, -1)
    ref_rstd = torch.rsqrt(torch.from_numpy(reference[f"stats/{block}/var"]).view(b, -1) + gn.eps)
    d_mean = float(((mean.view(b, -1) - ref_mean).abs() * ref_rstd).max())
    d_rstd = float(((rstd.view(b, -1) - ref_rstd).abs() / ref_rstd).max())
    assert d_mean <= 1e-5 and d_rstd <= 1e-4, (block, d_mean, d_rstd)
    equal = float(np.mean(got.permute(0, 2, 3, 1).float().numpy()
                          == reference[f"inter/{block}/GroupNorm_0"]))
    assert equal >= 0.996, (block, equal)


def test_committed_weights_are_the_checkpoint(tmp_path):
    import jax

    from hobot_stereonet_tpu.runtime.checkpoint import load_params
    from hobot_stereonet_tpu_torch.runtime.weights import load_flax_npz, save_flax_npz

    tree = jax.tree_util.tree_map(np.asarray, load_params(str(CHECKPOINT)))
    save_flax_npz(tree, str(tmp_path / "p.npz"))
    assert (tmp_path / "p.npz").read_bytes() == PARAMS_NPZ.read_bytes()
    leaves = jax.tree_util.tree_leaves(load_flax_npz(str(PARAMS_NPZ)))
    assert len(leaves) == 106 and sum(a.size for a in leaves) == 887_032


def test_committed_outputs_are_current(reference, committed):
    assert str(committed["xla_flags"]) == NO_EXCESS
    assert tuple(committed["scenes"]) == SCENES
    for name in ("f32", "bf16"):
        np.testing.assert_allclose(committed[f"{name}_disparity"],
                                   reference[f"{name}_disparity"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(committed[f"{name}_confidence"],
                                   reference[f"{name}_confidence"], rtol=0, atol=1e-5)
    assert committed["bf16_720p_disparity"].shape == (720, 1280)
    assert committed["heldout_epe"].shape == (HELDOUT["size"],)


@pytest.fixture(scope="module")
def committed_int8():
    with np.load(INT8_OUTPUTS_NPZ) as data:
        return {k: data[k] for k in data.files}


def test_committed_int8_outputs_are_current(reference, committed_int8):
    """The committed JAX int8 outputs are what the reference computes now,
    to the tolerances of :func:`test_committed_outputs_are_current`."""
    assert str(committed_int8["xla_flags"]) == NO_EXCESS
    assert tuple(committed_int8["scenes"]) == SCENES
    for scheme in INT8_SCHEMES:
        np.testing.assert_allclose(committed_int8[f"{scheme}_disparity"],
                                   reference[f"int8_{scheme}_disparity"], rtol=0, atol=1e-4)
        assert committed_int8[f"{scheme}_heldout_epe"].shape == (HELDOUT["size"],)
    assert INT8_OUTPUTS_NPZ.stat().st_size < 2 << 20


def _scene_input():
    from hobot_stereonet_tpu_torch.config import PreprocessConfig
    from hobot_stereonet_tpu_torch.ops.preprocess import rgb_pair_to_model_input

    ds = heldout_dataset()
    yuv = PreprocessConfig(color_space="yuv")
    return torch.cat([rgb_pair_to_model_input(ds[i].left, ds[i].right, yuv, "cpu")
                      for i in SCENES])


def test_f32_network_on_trained_scenes(params, committed):
    x = _scene_input()
    with torch.inference_mode():
        out = _port_net(params, torch.float32)(x[..., :3], x[..., 3:])
    np.testing.assert_allclose(out["disparity"].numpy(), committed["f32_disparity"], atol=1e-3)
    np.testing.assert_allclose(out["confidence"].numpy(), committed["f32_confidence"], atol=1e-4)


def _bf16_agreement(got: np.ndarray, want: np.ndarray) -> None:
    err = np.abs(got - want)
    over = float(np.mean(err > 1.0))
    assert np.median(err) <= 0.03 and over <= 5e-4 and err.max() <= 8.0, (
        float(np.median(err)), over, float(err.max()))


def test_bf16_network_on_trained_scenes(params, committed):
    """The bf16 network on the two held-out scenes against the committed
    reference: median |error| <= 0.03 px, at most 0.05 % of pixels off by
    more than 1 px, none by more than 8 px; confidence within 0.03.

    Every block rounds where the reference does (the per-block test
    above), but chained through 23 blocks the f32 ties compound, and where
    the aggregation's logits are nearly flat (textureless or occluded
    pixels) a small change of a logit moves the soft-argmin far.  The same
    happens to the reference itself: JAX's default rounding against the
    no-excess reference on the 720p frame differs by a median 0.017 px,
    275 pixels over 1 px and at most 5.36 px (measured on the CPU).  8 px
    is one coarse disparity candidate at full resolution, the most a
    change between two neighbouring candidates can move a pixel.  Measured
    on the CPU at one thread: median 0.023 px, 42 of 262 144 pixels over
    1 px, max 2.29 px; on an H100 (chip_smoke.py): median 0.023 px, 40
    over 1 px, max 1.91 px.
    """
    x = _scene_input()
    with torch.inference_mode():
        out = _port_net(params, torch.bfloat16)(x[..., :3], x[..., 3:])
    _bf16_agreement(out["disparity"].numpy(), committed["bf16_disparity"])
    conf = np.abs(out["confidence"].numpy() - committed["bf16_confidence"])
    assert conf.max() <= 0.03, conf.max()


@pytest.mark.parametrize("scheme", INT8_SCHEMES)
def test_int8_network_on_trained_scenes(params, committed_int8, scheme):
    """The bf16 int8 network (``calib.json`` for the static scheme) on the
    two held-out scenes, ingested by the port, against the committed JAX
    int8 output: median |error| <= 0.06 px and at most 2 % of pixels off
    by more than 1 px, the bounds of tests/test_torch_quant.py and for its
    reasons; none by more than 16 px (two coarse candidates).  Measured on
    the CPU (median, share over 1 px, max): dynamic 0.050 px, 0.28 %,
    10.36 px (10 of 262 144 pixels over 8 px); static 0.055 px, 0.40 %,
    8.29 px; the same with JAX's own model input.  JAX against itself with
    its default rounding differs from this reference by a median 0.010 px
    and at most 0.43 px: in bf16 a GroupNorm output one ulp off (0.4 %
    relative) moves the next conv's int8 code in about half the cases,
    and the port's GroupNorm rounds up to 0.44 % of its outputs differently
    from XLA's (the module docstring), far more often than XLA's two
    rounding modes differ from each other."""
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import FastStereoNet
    from hobot_stereonet_tpu_torch.ops.quant import serving_model
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params

    cfg = StereoNetConfig()
    net = FastStereoNet(cfg, device="cpu")
    net.load_state_dict(from_flax_params(params, cfg))
    net = serving_model(net, int8=True,
                        static_quant=str(CALIB_JSON) if scheme == "static" else None)
    x = _scene_input()
    with torch.inference_mode():
        out = net(x[..., :3], x[..., 3:])
    err = np.abs(out["disparity"].numpy() - committed_int8[f"{scheme}_disparity"])
    stats = (float(np.median(err)), float(np.mean(err > 1.0)), float(err.max()))
    assert stats[0] <= 0.06 and stats[1] <= 0.02 and stats[2] <= 16.0, stats


def test_bf16_network_at_720p(params, committed):
    """The bf16 network on the committed 720p NV12 frame, ingested as the
    engine does, against the reference: the bounds and the reason for them
    of :func:`test_bf16_network_on_trained_scenes`.  Measured on the CPU
    at one thread: median 0.014 px, 222 of 921 600 pixels over 1 px, max
    3.11 px; on an H100 (chip_smoke.py): median 0.014 px, 201 over 1 px,
    max 3.34 px."""
    from hobot_stereonet_tpu_torch.config import PreprocessConfig
    from hobot_stereonet_tpu_torch.ops import preprocess as pp

    x = pp.nv12_ingest(torch.from_numpy(frame_720p())[None], 720, 2560,
                       PreprocessConfig(color_space="yuv"))
    with torch.inference_mode():
        out = _port_net(params, torch.bfloat16)(x[..., :3], x[..., 3:])
    assert out["disparity"].shape == (1, 720, 1280)
    _bf16_agreement(out["disparity"][0].numpy(), committed["bf16_720p_disparity"])


def _groupnorm_stats(x: torch.Tensor, g: int) -> dict:
    """A GroupNorm's statistics of ``x`` (bf16, NCHW), computed several
    ways: name -> (mean, var), each [N, g, 1, 1, 1] float32."""
    b, c, h, w = x.shape
    xg = x.float().unflatten(1, (g, c // g))
    dims, n = (2, 3, 4), c // g * h * w
    xd = xg.double()

    def flax_var(s1, s2):                  # float32 E[x^2] - E[x]^2, clamped at 0
        mu, mu2 = (s1 / n).float(), (s2 / n).float()
        return mu, torch.clamp(mu2 - mu * mu, min=0.0)

    seq = xg.permute(0, 1, 3, 4, 2).flatten(2)           # NHWC order within a group
    mean64 = xd.mean(dims, keepdim=True)
    return {
        "exact (float64)": (mean64.float(), ((xd - mean64) ** 2).mean(dims, keepdim=True).float()),
        "flax, float32 sums": flax_var(xg.sum(dims, keepdim=True), (xg * xg).sum(dims, keepdim=True)),
        "flax, sequential float32": flax_var(torch.cumsum(seq, -1)[..., -1:, None, None],
                                             torch.cumsum(seq * seq, -1)[..., -1:, None, None]),
        "flax, float64 sums": flax_var(xd.sum(dims, keepdim=True), (xd * xd).sum(dims, keepdim=True)),
    }


def _flax_normalize(x: torch.Tensor, gn, mean, var) -> torch.Tensor:
    """flax's ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, to bf16."""
    c, g = x.shape[1], gn.num_groups
    shape = (1, g, c // g, 1, 1)
    y = (x.float().unflatten(1, (g, c // g)) - mean) * (
        torch.rsqrt(var + gn.eps) * gn.weight.float().view(shape))
    return (y + gn.bias.float().view(shape)).flatten(1, 2).to(x.dtype)


def report_groupnorm_variants() -> None:
    """Print the bit-equal share of each block with a GroupNorm, fed the
    reference's input, with the GroupNorm's statistics computed each way;
    then the share of the GroupNorm alone, fed the reference's conv output,
    with the reference's own statistics among the ways; then how far the
    reference's variance lies from the exact one."""
    import tempfile

    from hobot_stereonet_tpu_torch.models import layers
    from hobot_stereonet_tpu_torch.runtime.weights import load_flax_npz

    with tempfile.TemporaryDirectory() as tmp:
        ref = _run_reference(Path(tmp) / "ref.npz")
    net = _port_net(load_flax_npz(str(PARAMS_NPZ)), torch.bfloat16)
    aten = "ATen (the port)"
    blocks, alone, offsets = {}, {}, []
    d_mean = d_rstd = 0.0
    aten_forward = layers.GroupNorm.forward
    with torch.inference_mode():
        for block in GROUPNORM_BLOCKS:
            src = _block_inputs()[block]
            if src is None:
                x = np.concatenate([ref["model_input"][..., :3], ref["model_input"][..., 3:]])
            else:
                x = ref[src if src == "agg_input" else "inter/" + src]
            for name in [aten, *_groupnorm_stats(torch.zeros(1, 1, 1, 1), 1)]:
                if name != aten:
                    layers.GroupNorm.forward = lambda gn, v, name=name: _flax_normalize(
                        v, gn, *_groupnorm_stats(v, gn.num_groups)[name])
                try:
                    got = _submodule(net, block)(_nchw(x).bfloat16())
                finally:
                    layers.GroupNorm.forward = aten_forward
                got = got.permute(0, 2, 3, 1).float().numpy()
                blocks.setdefault(name, []).append(float(np.mean(got == ref["inter/" + block])))

            gn = _submodule(net, block).GroupNorm_0
            conv = _nchw(ref[f"inter/{block}/Conv_0"]).bfloat16()
            b, g = conv.shape[0], gn.num_groups
            stats = _groupnorm_stats(conv, g)
            stats["the reference's own"] = (
                torch.from_numpy(ref[f"stats/{block}/mean"]).view(b, g, 1, 1, 1),
                torch.from_numpy(ref[f"stats/{block}/var"]).view(b, g, 1, 1, 1))
            outs = {aten: gn(conv)}
            outs.update({k: _flax_normalize(conv, gn, *v) for k, v in stats.items()})
            want = ref[f"inter/{block}/GroupNorm_0"]
            for name, y in outs.items():
                alone.setdefault(name, []).append(
                    float(np.mean(y.permute(0, 2, 3, 1).float().numpy() == want)))
            exact = stats["exact (float64)"][1]
            offsets.append(((stats["the reference's own"][1] - exact) / exact).flatten())
            _, mean, rstd = torch.ops.aten.native_group_norm(   # the port's statistics
                conv.float(), None, None, b, conv.shape[1], conv[0, 0].numel(), g, gn.eps)
            ref_mean, ref_var = (t.view(b, g) for t in stats["the reference's own"])
            ref_rstd = torch.rsqrt(ref_var + gn.eps)
            d_mean = max(d_mean, float(((mean.view(b, g) - ref_mean).abs() * ref_rstd).max()))
            d_rstd = max(d_rstd, float(((rstd.view(b, g) - ref_rstd).abs() / ref_rstd).max()))
    print(f"torch threads {torch.get_num_threads()}; bit-equal share (least / mean over "
          f"{len(GROUPNORM_BLOCKS)} blocks with a GroupNorm), the whole block fed the "
          "reference's input | the GroupNorm alone fed the reference's conv output:")
    for name in alone:
        whole = (f"{100 * min(blocks[name]):7.3f} % / {100 * np.mean(blocks[name]):7.3f} %"
                 if name in blocks else " " * 21)
        print(f"  {name:26s} {whole} | {100 * min(alone[name]):7.3f} % / "
              f"{100 * np.mean(alone[name]):7.3f} %")
    off = torch.cat(offsets)
    print(f"the reference's variance against the exact one, relative: {float(off.min()):.3g} "
          f"to {float(off.max()):.3g}, mean {float(off.mean()):.3g}")
    print(f"ATen's statistics against the reference's: |mean| {d_mean:.3g} of a standard "
          f"deviation, 1/std {d_rstd:.3g} relative (most over the blocks)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="regenerate the committed reference data")
    ap.add_argument("--reference", metavar="NPZ",
                    help="compute the reference arrays into NPZ (runs under " + NO_EXCESS + ")")
    ap.add_argument("--full", action="store_true",
                    help="with --reference: also the 720p frame and the 120 held-out EPEs")
    ap.add_argument("--groupnorm-variants", action="store_true",
                    help="print each block's bit-equal share with the GroupNorm's "
                         "statistics computed several ways")
    ap.add_argument("--threads", type=int, default=1,
                    help="with --groupnorm-variants: torch's CPU thread count")
    args = ap.parse_args()
    if args.groupnorm_variants:
        torch.set_num_threads(args.threads)
        report_groupnorm_variants()
    elif args.reference:
        _jax_reference(args.reference, args.full)
    elif args.write:
        write_committed_data()
    else:
        ap.error("give --write, --reference or --groupnorm-variants")
