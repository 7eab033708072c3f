"""The port's CLASSIC StereoNet with its trained weights against the JAX
package's, and the CLASSIC reference data the port carries
(``hobot_stereonet_tpu_torch/reference/classic_*.npz``).

The reference is JAX on the CPU under
``XLA_FLAGS=--xla_allow_excess_precision=false`` (XLA then rounds bf16
where the flax code does, as the port does), run in a subprocess because
the flag is read once per process and tests/conftest.py sets ``XLA_FLAGS``
for the suite (as in tests/test_torch_reference.py).  Preprocessing is the
default RGB one, as ``scripts/accuracy_stats.py`` evaluates CLASSIC.

Tolerances:
  * Each bf16 conv (2-D, dilated and 3-D), fed the reference's own input:
    at least 99.9 % of its outputs bit-equal, as the flagship's
    (tests/test_torch_reference.py); measured least 99.97 %.
  * Each GroupNorm, fed the reference's conv output: its float32
    statistics within 1e-6 of float64 ones (|mean| in standard deviations,
    1/std relative; measured at most 1.8e-7 and 1.2e-7), and within the
    reference's own float32 error of flax's: |mean| to 1e-5 of a standard
    deviation and 1/std to 5e-4 relative.  flax's E[x^2] - E[x]^2, summed
    by XLA in float32 over the 196 608 values of a 3-D group, lies up to
    2.2e-4 (1/std) from the float64 value (``--blocks`` prints all of
    these).  Given its own statistics, flax's normalization reproduces the
    reference's GroupNorm output to 99.98-100 %: the statistics are the
    whole difference, and the bit-equal share of a block with a GroupNorm
    is not held here.  It reaches 94.3 % at full resolution, where a
    group holds 393 216 values (fault C4 in ROADMAP.md, after C2).
  * The committed weights: byte for byte what ``save_flax_npz`` writes from
    ``checkpoints/frontier_CLASSIC``.  The committed two-scene outputs:
    what the reference computes now, to 1e-4 px and confidence 1e-5.
  * The whole network in float32: :func:`test_classic_f32_network_on_trained_scenes`.
  * The whole network in bf16, on the two scenes and at 720p:
    :func:`test_classic_bf16_network_on_trained_scenes`.

Regenerate the committed data (needs JAX, flax and orbax; about two
minutes on a CPU) with::

    python tests/test_torch_classic_reference.py --write

and print each bf16 block's, conv's and GroupNorm's bit-equal share, and
the GroupNorms' statistics against flax's and float64 ones, with::

    python tests/test_torch_classic_reference.py --blocks
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
    CLASSIC_OUTPUTS_NPZ, CLASSIC_PARAMS_NPZ, HELDOUT, REF_DIR, SCENES, frame_720p)
from hobot_stereonet_tpu_torch.reference import XLA_FLAGS as NO_EXCESS  # noqa: E402

CHECKPOINT = ROOT / "checkpoints" / "frontier_CLASSIC"

TOWER = (["FeatureTower_0/ConvBlock_%d" % i for i in range(3)]
         + ["FeatureTower_0/ResBlock2D_%d" % i for i in range(6)]
         + ["FeatureTower_0/Conv_0"])
AGG = ["CostAggregation_0/ConvBlock3D_%d" % i for i in range(4)] + ["CostAggregation_0/Conv_0"]
REFINE_BLOCKS = (6, 4, 3)
REFINE = [f"RefinementNet_{i}/{m}" for i, nb in enumerate(REFINE_BLOCKS)
          for m in ["ConvBlock_0"] + ["ResBlock2D_%d" % j for j in range(nb)] + ["Conv_0"]]
BLOCKS = TOWER + AGG + REFINE
# A block's layers whose outputs the reference keeps (those it has).
SUBLAYERS = ("Conv_0", "GroupNorm_0", "ConvBlock_0", "ConvBlock_0/Conv_0",
             "ConvBlock_0/GroupNorm_0")


def _block_input(block: str) -> str:
    """The key of the reference array that ``block`` takes as input."""
    if block == BLOCKS[0]:
        return "tower_input"
    group = block.split("/")[0]
    members = [b for b in BLOCKS if b.startswith(group + "/")]
    i = members.index(block)
    if i > 0:
        return "inter/" + members[i - 1]
    return "volume" if group == "CostAggregation_0" else f"refine_input/{group[-1]}"


def _convs():
    """Every conv of the network: (path, key of its input, key of its output)."""
    out = []
    for block in BLOCKS:
        name, inp = block.split("/")[1], _block_input(block)
        if name == "Conv_0":
            out.append((block, inp, "inter/" + block))
        elif name.startswith("ResBlock2D"):
            out += [(block + "/ConvBlock_0/Conv_0", inp, f"inter/{block}/ConvBlock_0/Conv_0"),
                    (block + "/Conv_0", f"inter/{block}/ConvBlock_0", f"inter/{block}/Conv_0")]
        else:
            out.append((block + "/Conv_0", inp, f"inter/{block}/Conv_0"))
    return out


def _groupnorms():
    """Every GroupNorm of the network, by path (its input is the output of
    the conv beside it, its statistics under ``stats/<path>``)."""
    out = []
    for block in BLOCKS:
        name = block.split("/")[1]
        if name.startswith("ResBlock2D"):
            out += [block + "/ConvBlock_0/GroupNorm_0", block + "/GroupNorm_0"]
        elif name != "Conv_0":
            out.append(block + "/GroupNorm_0")
    return out


CONVS = _convs()
GROUPNORMS = _groupnorms()
# The port's GroupNorm statistics (|mean| in standard deviations, 1/std
# relative) against float64 ones and against flax's (module docstring).
GN_EXACT_TOL = 1e-6
GN_MEAN_TOL, GN_RSTD_TOL = 1e-5, 5e-4


# ---------------------------------------------------------------------------
# The reference (JAX), run as a script in a process of its own
# ---------------------------------------------------------------------------

def _jax_reference(out_path: str, full: bool) -> None:
    """Compute the reference arrays into ``out_path`` (an ``.npz``).

    Always: the two scenes' model input, disparity and confidence in f32
    and bf16; in bf16, every block's output and its layers' (``inter/<block>``,
    ``inter/<block>/<layer>``) with the inputs of the aggregation
    (``volume``) and of each refinement (``refine_input/<i>``), and flax's
    statistics of each GroupNorm (``stats/<path>/mean``, ``/var``).  With ``full``: the 720p frame's bf16
    disparity and the per-scene EPE of the 120 held-out scenes in bf16.
    """
    assert NO_EXCESS in os.environ.get("XLA_FLAGS", ""), "run under " + NO_EXCESS
    import jax
    import jax.numpy as jnp
    from flax.linen.normalization import _compute_stats

    from hobot_stereonet_tpu.config import Config, StereoNetConfig
    from hobot_stereonet_tpu.data.loader import SyntheticStereoDataset
    from hobot_stereonet_tpu.models import StereoNet
    from hobot_stereonet_tpu.ops import preprocess as jpp
    from hobot_stereonet_tpu.ops.cost_volume import build_cost_volume
    from hobot_stereonet_tpu.ops.upsample import downsample_avg, upsample2x_bilinear
    from hobot_stereonet_tpu.runtime.checkpoint import load_params

    params = jax.tree_util.tree_map(np.asarray, load_params(str(CHECKPOINT)))
    rgb = Config().preprocess
    ds = SyntheticStereoDataset(**HELDOUT)
    x = np.concatenate([np.asarray(jpp.rgb_pair_to_model_input(ds[i].left, ds[i].right, rgb))
                        for i in SCENES])
    left, right = jnp.asarray(x[..., :3]), jnp.asarray(x[..., 3:])
    out = {"xla_flags": np.array(os.environ["XLA_FLAGS"]), "jax_version": np.array(jax.__version__),
           "scenes": np.array(SCENES), "model_input": x}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        o = jax.jit(StereoNet(StereoNetConfig(compute_dtype=dt)).apply)(params, left, right)
        out[f"{name}_disparity"] = np.asarray(o["disparity"])
        out[f"{name}_confidence"] = np.asarray(o["confidence"])

    cfg = StereoNetConfig()
    o, inter = jax.jit(lambda p, l, r: StereoNet(cfg).apply(
        p, l, r, capture_intermediates=True))(params, left, right)
    inter = inter["intermediates"]
    for block in BLOCKS:
        node = inter
        for part in block.split("/"):
            node = node[part]
        out["inter/" + block] = np.asarray(node["__call__"][0].astype(jnp.float32))
        for sub in SUBLAYERS:
            leaf = node
            for part in sub.split("/"):
                leaf = leaf.get(part, {})
            if leaf:
                out[f"inter/{block}/{sub}"] = np.asarray(leaf["__call__"][0].astype(jnp.float32))
    for gn in GROUPNORMS:
        node = inter
        for part in gn.replace("GroupNorm_0", "Conv_0").split("/"):
            node = node[part]
        y = node["__call__"][0]                 # the GroupNorm's input, bf16
        c = y.shape[-1]
        g = next(k for k in (8, 4, 2, 1) if c % k == 0)
        axes = list(range(1, y.ndim - 1)) + [y.ndim]
        mean, var = jax.jit(lambda v: _compute_stats(
            v.reshape(v.shape[:-1] + (g, c // g)), axes, v.dtype))(y)
        out[f"stats/{gn}/mean"] = np.asarray(mean)
        out[f"stats/{gn}/var"] = np.asarray(var)
    out["tower_input"] = np.concatenate([x[..., :3], x[..., 3:]])
    feats = inter["FeatureTower_0"]["__call__"][0]
    b = len(SCENES)
    volume = jax.jit(build_cost_volume, static_argnums=2)(
        feats[:b], feats[b:], cfg.num_disparities_coarse)
    out["volume"] = np.asarray(volume.astype(jnp.float32))
    h = left.shape[1]
    for i, s in enumerate([4, 2, 1]):
        disp = o["pyramid"][i][..., None]
        while disp.shape[1] < h // s:
            disp = upsample2x_bilinear(disp)
        guide = left if s == 1 else downsample_avg(left, s)
        cat = jnp.concatenate([disp.astype(jnp.bfloat16), guide.astype(jnp.bfloat16)], -1)
        out[f"refine_input/{i}"] = np.asarray(cat.astype(jnp.float32))

    if full:
        sbs = frame_720p()
        x720 = jpp.side_by_side_nv12_to_model_input(jnp.asarray(sbs), 720, 2560, rgb)
        o = jax.jit(StereoNet(cfg).apply)(params, x720[..., :3], x720[..., 3:])
        out["bf16_720p_disparity"] = np.asarray(o["disparity"][0])
        from hobot_stereonet_tpu.runtime.evaluate import evaluate_dataset

        r = evaluate_dataset(StereoNet(cfg), params, ds, dataclasses.replace(Config(), model=cfg))
        out["heldout_epe"] = np.asarray(r.per_frame_epe, np.float64)
        out["heldout_d1"] = np.array(r.d1_all)
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
    """Regenerate ``reference/classic_params.npz`` and ``classic_outputs.npz``."""
    import tempfile

    import jax

    from hobot_stereonet_tpu.runtime.checkpoint import load_params
    from hobot_stereonet_tpu_torch.runtime.weights import save_flax_npz, write_npz

    REF_DIR.mkdir(exist_ok=True)
    save_flax_npz(jax.tree_util.tree_map(np.asarray, load_params(str(CHECKPOINT))),
                  str(CLASSIC_PARAMS_NPZ))
    with tempfile.TemporaryDirectory() as tmp:
        ref = _run_reference(Path(tmp) / "ref.npz", full=True)
    keep = ["xla_flags", "jax_version", "scenes", "f32_disparity", "f32_confidence",
            "bf16_disparity", "bf16_confidence", "bf16_720p_disparity", "heldout_epe",
            "heldout_d1"]
    write_npz(str(CLASSIC_OUTPUTS_NPZ), {k: ref[k] for k in keep})
    for p in (CLASSIC_PARAMS_NPZ, CLASSIC_OUTPUTS_NPZ):
        print(f"wrote {p.relative_to(ROOT)}: {p.stat().st_size} bytes")


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _run_reference(tmp_path_factory.mktemp("reference") / "ref.npz")


@pytest.fixture(scope="module")
def committed():
    with np.load(CLASSIC_OUTPUTS_NPZ) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def params():
    from hobot_stereonet_tpu_torch.runtime.weights import load_flax_npz

    return load_flax_npz(str(CLASSIC_PARAMS_NPZ))


def _port_net(params, dtype):
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import StereoNet
    from hobot_stereonet_tpu_torch.models.layers import cast_convs
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params

    cfg = StereoNetConfig(compute_dtype=dtype)
    net = StereoNet(cfg, device="cpu")
    net.load_state_dict(from_flax_params(params, cfg, model="classic"))
    return cast_convs(net, dtype).eval()


def _channels_first(x: np.ndarray) -> torch.Tensor:
    """[N, *spatial, C] -> N C *spatial, channel-last memory."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.movedim(-1, 1)


def _submodule(net, block: str):
    mod = net
    for part in block.split("/"):
        mod = getattr(mod, part)
    return mod


def _share(net, ref: dict, path: str, inp: str, out: str) -> float:
    """Bit-equal share of the bf16 layer or block at ``path``, fed the
    reference's array ``inp``, against the reference's ``out``."""
    x = _channels_first(ref[inp]).bfloat16()
    with torch.inference_mode():
        got = _submodule(net, path)(x)
    got = got.movedim(1, -1).float().numpy()
    assert got.shape == ref[out].shape, (path, got.shape, ref[out].shape)
    return float(np.mean(got == ref[out]))


def _gn_errors(gn, x: torch.Tensor, ref: dict, path: str) -> dict:
    """How far GroupNorm statistics of bf16 ``x`` lie from each other,
    as (|mean| in standard deviations, 1/std relative): the port's
    (``F.group_norm``'s) and flax's (``ref["stats/<path>/..."]``) against
    float64 ones, and the port's against flax's."""
    n, c = x.shape[:2]
    _, mean, rstd = torch.ops.aten.native_group_norm(
        x.float().contiguous(), None, None, n, c, x[0, 0].numel(), gn.num_groups, gn.eps)
    xd = x.double().contiguous().view(n, gn.num_groups, -1)
    exact = (xd.mean(-1), torch.rsqrt(xd.var(-1, unbiased=False) + gn.eps))
    port = (mean.view(n, -1).double(), rstd.view(n, -1).double())
    flax = (torch.from_numpy(ref[f"stats/{path}/mean"]).view(n, -1).double(),
            torch.rsqrt(torch.from_numpy(ref[f"stats/{path}/var"]).view(n, -1).double() + gn.eps))

    def dist(a, b):
        return (float(((a[0] - b[0]).abs() * b[1]).max()),
                float(((a[1] - b[1]).abs() / b[1]).max()))

    return {"port-exact": dist(port, exact), "flax-exact": dist(flax, exact),
            "port-flax": dist(port, flax)}


def _flax_normalize_share(gn, x: torch.Tensor, ref: dict, path: str) -> float:
    """Bit-equal share of flax's normalization, ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias`` in float32, given the reference's statistics."""
    n, c = x.shape[:2]
    g = gn.num_groups
    stat = (n, g) + (1,) * (x.dim() - 1)
    mean = torch.from_numpy(ref[f"stats/{path}/mean"]).view(stat)
    var = torch.from_numpy(ref[f"stats/{path}/var"]).view(stat)
    param = (1, g, c // g) + (1,) * (x.dim() - 2)
    with torch.inference_mode():
        y = (x.float().unflatten(1, (g, c // g)) - mean) * (
            torch.rsqrt(var + gn.eps) * gn.weight.float().view(param)) + gn.bias.float().view(param)
    y = y.flatten(1, 2).bfloat16().movedim(1, -1).float().numpy()
    return float(np.mean(y == ref["inter/" + path]))


@pytest.mark.parametrize("conv", [c[0] for c in CONVS])
def test_classic_bf16_conv_bit_equal_to_reference(reference, params, conv):
    """Every conv, 2-D, dilated and 3-D, fed the reference's input: at least
    99.9 % of its bf16 outputs bit-equal (measured least 99.97 %)."""
    _, inp, out = next(c for c in CONVS if c[0] == conv)
    equal = _share(_port_net(params, torch.bfloat16), reference, conv, inp, out)
    assert equal >= 0.999, (conv, equal)


@pytest.mark.parametrize("gn", GROUPNORMS)
def test_classic_groupnorm_statistics_match_reference(reference, params, gn):
    """Every GroupNorm, fed the reference's conv output: the port's float32
    statistics within :data:`GN_EXACT_TOL` of float64 ones and within
    (:data:`GN_MEAN_TOL`, :data:`GN_RSTD_TOL`) of flax's (module docstring)."""
    mod = _submodule(_port_net(params, torch.bfloat16), gn)
    x = _channels_first(reference["inter/" + gn.replace("GroupNorm_0", "Conv_0")]).bfloat16()
    err = _gn_errors(mod, x, reference, gn)
    assert max(err["port-exact"]) <= GN_EXACT_TOL, (gn, err)
    assert err["port-flax"][0] <= GN_MEAN_TOL and err["port-flax"][1] <= GN_RSTD_TOL, (gn, err)


def test_committed_classic_weights_are_the_checkpoint(tmp_path):
    import jax

    from hobot_stereonet_tpu.runtime.checkpoint import load_params
    from hobot_stereonet_tpu_torch.runtime.weights import load_flax_npz, save_flax_npz

    tree = jax.tree_util.tree_map(np.asarray, load_params(str(CHECKPOINT)))
    save_flax_npz(tree, str(tmp_path / "p.npz"))
    assert (tmp_path / "p.npz").read_bytes() == CLASSIC_PARAMS_NPZ.read_bytes()
    leaves = jax.tree_util.tree_leaves(load_flax_npz(str(CLASSIC_PARAMS_NPZ)))
    assert len(leaves) == 202 and sum(a.size for a in leaves) == 428_156


def test_committed_classic_outputs_are_current(reference, committed):
    assert str(committed["xla_flags"]) == NO_EXCESS
    assert tuple(committed["scenes"]) == SCENES
    for name in ("f32", "bf16"):
        np.testing.assert_allclose(committed[f"{name}_disparity"],
                                   reference[f"{name}_disparity"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(committed[f"{name}_confidence"],
                                   reference[f"{name}_confidence"], rtol=0, atol=1e-5)
    assert committed["bf16_720p_disparity"].shape == (720, 1280)
    assert committed["heldout_epe"].shape == (HELDOUT["size"],)
    assert CLASSIC_OUTPUTS_NPZ.stat().st_size < 6 << 20


def _scene_input():
    from hobot_stereonet_tpu_torch.config import Config
    from hobot_stereonet_tpu_torch.ops.preprocess import rgb_pair_to_model_input
    from hobot_stereonet_tpu_torch.reference import heldout_dataset

    ds = heldout_dataset()
    return torch.cat([rgb_pair_to_model_input(ds[i].left, ds[i].right, Config().preprocess, "cpu")
                      for i in SCENES])


def test_classic_model_input_is_the_reference_s(reference):
    np.testing.assert_array_equal(_scene_input().numpy(), reference["model_input"])


def _f64_net(params):
    """The port's network in float64 throughout (GroupNorm and soft-argmin
    too): the float32 networks' common yardstick."""
    return _port_net(params, torch.float32).double()


def test_classic_f32_network_on_trained_scenes(params, committed):
    """The float32 network on the two scenes: against the committed JAX
    float32 output, median |error| <= 1e-4 px, max <= 3e-3 px, confidence
    within 1e-4 (measured 1.3e-5 px, 2.33e-3 px on 54 of 262 144 pixels
    over 1e-3, 3.2e-5); against the same network in float64, max <= 1.5e-3
    px (measured 1.18e-3).  The 1e-3 px of the flagship's test is not met
    (fault C5): JAX's float32 output is itself 2.08e-3 px from the float64
    one (``--blocks``), the float32 rounding of three full-resolution
    refinements after a 3-D aggregation."""
    x = _scene_input()
    with torch.inference_mode():
        out = _port_net(params, torch.float32)(x[..., :3], x[..., 3:])
        exact = _f64_net(params)(x[..., :3].double(), x[..., 3:].double())
    err = np.abs(out["disparity"].numpy() - committed["f32_disparity"])
    assert np.median(err) <= 1e-4 and err.max() <= 3e-3, (float(np.median(err)), float(err.max()))
    np.testing.assert_allclose(out["confidence"].numpy(), committed["f32_confidence"], atol=1e-4)
    np.testing.assert_allclose(out["disparity"].numpy(), exact["disparity"].numpy(), atol=1.5e-3)


def _bf16_agreement(got: np.ndarray, want: np.ndarray) -> None:
    err = np.abs(got - want)
    over = float(np.mean(err > 1.0))
    assert np.median(err) <= 0.03 and over <= 5e-4 and err.max() <= 8.0, (
        float(np.median(err)), over, float(err.max()))


def test_classic_bf16_network_on_trained_scenes(params, committed):
    """The bf16 network on the two held-out scenes against the committed
    reference: median |error| <= 0.03 px, at most 0.05 % of pixels off by
    more than 1 px, none by more than 8 px (the flagship's bounds and
    reasons, tests/test_torch_reference.py); confidence within 0.03.
    Measured on the CPU at one thread: median 0.0113 px, 41 of 262 144
    pixels over 1 px, max 1.42 px; confidence 0.0283."""
    x = _scene_input()
    with torch.inference_mode():
        out = _port_net(params, torch.bfloat16)(x[..., :3], x[..., 3:])
    _bf16_agreement(out["disparity"].numpy(), committed["bf16_disparity"])
    conf = np.abs(out["confidence"].numpy() - committed["bf16_confidence"])
    assert conf.max() <= 0.03, conf.max()


def test_classic_bf16_network_at_720p(params, committed):
    """The bf16 network on the committed 720p NV12 frame, ingested as the
    engine does (RGB), against the reference, to the bounds of
    :func:`test_classic_bf16_network_on_trained_scenes`.  Measured on the
    CPU at one thread: median 0.0082 px, 45 of 921 600 pixels over 1 px,
    max 1.36 px."""
    from hobot_stereonet_tpu_torch.config import Config
    from hobot_stereonet_tpu_torch.ops import preprocess as pp

    x = pp.nv12_ingest(torch.from_numpy(frame_720p())[None], 720, 2560, Config().preprocess)
    with torch.inference_mode():
        out = _port_net(params, torch.bfloat16)(x[..., :3], x[..., 3:])
    assert out["disparity"].shape == (1, 720, 1280)
    _bf16_agreement(out["disparity"][0].numpy(), committed["bf16_720p_disparity"])


def report_blocks() -> None:
    """Print, against the reference on the two scenes: the bit-equal share
    of each bf16 block and conv fed the reference's input; for each
    GroupNorm fed the reference's conv output, its share, the share of
    flax's normalization given the reference's statistics, and how far the
    port's and flax's statistics lie from float64 ones; then the float32
    networks' disparity against the port's float64 network."""
    import tempfile

    from hobot_stereonet_tpu_torch.runtime.weights import load_flax_npz

    with tempfile.TemporaryDirectory() as tmp:
        ref = _run_reference(Path(tmp) / "ref.npz")
    params = load_flax_npz(str(CLASSIC_PARAMS_NPZ))
    net = _port_net(params, torch.bfloat16)
    print(f"torch threads {torch.get_num_threads()}; bit-equal share of each bf16 block, "
          "fed the reference's input:")
    for block in BLOCKS:
        share = _share(net, ref, block, _block_input(block), "inter/" + block)
        print(f"  {block:45s} {100 * share:8.4f} %")
    shares = [_share(net, ref, *c) for c in CONVS]
    print(f"convs ({len(CONVS)}): least {100 * min(shares):.4f} % "
          f"({CONVS[int(np.argmin(shares))][0]}), mean {100 * np.mean(shares):.4f} %")
    print("GroupNorms fed the reference's conv output: the port's bit-equal share | flax's "
          "normalization given the reference's statistics | statistics (|mean| in standard "
          "deviations, 1/std relative) port vs float64, flax vs float64 | values a group")
    for gn in GROUPNORMS:
        conv = "inter/" + gn.replace("GroupNorm_0", "Conv_0")
        mod = _submodule(net, gn)
        x = _channels_first(ref[conv]).bfloat16()
        err = _gn_errors(mod, x, ref, gn)
        print(f"  {gn:53s} {100 * _share(net, ref, gn, conv, 'inter/' + gn):8.4f} % | "
              f"{100 * _flax_normalize_share(mod, x, ref, gn):8.4f} % | "
              f"{err['port-exact'][0]:.2g} {err['port-exact'][1]:.2g}, "
              f"{err['flax-exact'][0]:.2g} {err['flax-exact'][1]:.2g} | "
              f"{x[0].numel() // mod.num_groups}")
    x = torch.from_numpy(ref["model_input"])
    with torch.inference_mode():
        f32 = _port_net(params, torch.float32)(x[..., :3], x[..., 3:])["disparity"].numpy()
        f64 = _f64_net(params)(x[..., :3].double(), x[..., 3:].double())["disparity"].numpy()
    jax32 = ref["f32_disparity"]
    print(f"float32 disparity, max |error| against the port's float64 network: port "
          f"{np.abs(f32 - f64).max():.3g} px, JAX {np.abs(jax32 - f64).max():.3g} px; port "
          f"against JAX {np.abs(f32 - jax32).max():.3g} px")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="regenerate the committed CLASSIC reference data")
    ap.add_argument("--reference", metavar="NPZ",
                    help="compute the reference arrays into NPZ (runs under " + NO_EXCESS + ")")
    ap.add_argument("--full", action="store_true",
                    help="with --reference: also the 720p frame and the 120 held-out EPEs")
    ap.add_argument("--blocks", action="store_true",
                    help="print each bf16 block's bit-equal share against the reference")
    args = ap.parse_args()
    if args.blocks:
        report_blocks()
    elif args.reference:
        _jax_reference(args.reference, args.full)
    elif args.write:
        write_committed_data()
    else:
        ap.error("give --write, --reference or --blocks")
