"""``make_sharded_train_step`` on (data, tile) gloo meshes, and what it differentiates through.

The ranks are 4 processes (``tests/torch_mesh_workers.py``, scenario
``training``, spawned once for the module); this process computes the
references: whole-image autograd, the port's one-rank step, the stored JAX
steps and the JAX package's own sharded step.

Cases and tolerances:
  * ``exchange_rows``' gradient, "zero" edges at every kernel, stride,
    dilation and split of tests/test_torch_parallel.py's conv_rows test and
    "replicate" edges (one row; three rows over tiles of one): equal to
    autograd of the whole image's halo'd slices, exactly (small integers
    in float64, so that no sum rounds);
  * the row-tiled conv (same kernels, strides, dilations, splits; one 3-D
    conv), float64: input, weight and bias gradients within 1e-10 of the
    whole image's (only the order of float64 sums differs);
  * the row-tiled GroupNorm, float64 (x, skip, weight, bias, conv bias;
    with and without the LeakyReLU; 4-D and 5-D, 4 uneven tiles): within
    1e-10 of ``F.group_norm``'s autograd on the whole image (the variance
    from float64 sums of squares against ATen's two-pass one);
  * the sharded float32 step of both networks at full width on the stored
    batch, on a (2, 1) mesh (ranks 0-1) beside a (1, 2) mesh (ranks 2-3),
    then (2, 2) on all four: loss within ``reference.TRAIN_F32_RTOL``, the
    gradients' norm within ``TRAIN_F32_NORM_RTOL`` and each gradient within
    ``TRAIN_F32_GRAD_RTOL`` of the stored JAX step, the bounds the one-rank
    step meets (a LeakyReLU input near zero may flip branch: the tiles'
    statistics round differently, ROADMAP C7), and all gradients together
    within ``TRAIN_F32_GRAD_RTOL`` (``reference.grad_distance``; the card
    holds its tiled steps to ``TRAIN_F32_TILE_GRAD_RTOL`` per tensor, the
    reason is there);
  * every rank's parameters, moments and metrics bit-equal after two steps;
  * the (2, 1) step: its gradients bit-equal to the float64 rank-order sum
    of the two half batches' gradients (computed here), and each within
    ``DATA_MESH_RTOL`` relative L2 of the one-rank ``make_train_step``:
    1e-5 for the flagship; 1e-4 for CLASSIC, whose full-resolution
    refinement convs' kernel gradients carry the float32 summation order's
    error (the one-rank step's own gradient of
    RefinementNet_2/ResBlock2D_0/ConvBlock_0/Conv_0 lies 7.9e-5 from the
    float64 sum of its per-sample gradients, the (2, 1) step's 3.9e-5, at
    one thread: ``--accuracy`` below);
  * the (2, 2) step of the small flagship (tests/test_training.py's batch
    and optimizer, seeded weights) against the JAX package's
    ``make_sharded_train_step`` on a ``MeshConfig(data=2, tile=2)`` mesh of
    the suite's host devices: loss and EPE within 1e-4 relative, the bound
    tests/test_training.py holds JAX's own sharded step to; the gradient
    norm within 1e-4 of JAX's unsharded step, since JAX's sharded step
    returns every gradient that reaches a GroupNorm doubled at tile = 2
    (ROADMAP C11: norm 95.66 against its unsharded 60.04, ``--accuracy``;
    the parameters after the last GroupNorm agree);
  * ``tile_rows=False`` on the (2, 2) mesh (the small flagship): loss, EPE
    and gradient norm within 1e-5 relative of the one-rank step (only the
    order of float32 sums differs);
  * the refusals: a tile count the coarse rows cannot take, a batch that
    does not split over data.
About 90 s of one worker (the full-width steps dominate).

The measurements behind the CLASSIC bounds and ROADMAP C11 (about 4
minutes on a CPU)::

    python tests/test_torch_sharded_training.py --accuracy
"""

import json
import os
import sys
from pathlib import Path

if __name__ == "__main__":      # the suite's host devices (tests/conftest.py sets them)
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hobot_stereonet_tpu.config import MeshConfig as JMeshConfig
from hobot_stereonet_tpu.config import StereoNetConfig as JStereoNetConfig
from hobot_stereonet_tpu.models import FastStereoNet as JFastStereoNet
from hobot_stereonet_tpu.parallel import mesh as jmesh
from hobot_stereonet_tpu.runtime import training as jtraining
from hobot_stereonet_tpu_torch import reference
from hobot_stereonet_tpu_torch.config import StereoNetConfig
from hobot_stereonet_tpu_torch.models import build_model
from hobot_stereonet_tpu_torch.models.layers import GroupNorm, SameConv2d, SameConv3d
from hobot_stereonet_tpu_torch.ops.kernels.group_norm import add_in_order
from hobot_stereonet_tpu_torch.runtime import training
from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params, random_flax_params
from tests import torch_mesh_workers as w

torch.set_num_threads(1)

HALO = ([list(s) + list(c) + ["zero"] for s in w.SPLITS for c in w.CONVS]
        + [list(s) + [1, 1, 1, "replicate"] for s in w.SPLITS]
        + [[40, 4, 1, 3, 1, 1, "replicate"]])
CONVS = ([list(s) + list(c) + [False] for s in w.SPLITS for c in w.CONVS]
         + [[40, 2, 2, 3, 1, 1, True]])
GROUP_NORMS = [list(c) for c in w.GN_CASES]
MODELS = ["fast", "classic"]
MESHES = [(2, 1), (1, 2), (2, 2)]
FLOAT64_RTOL = 1e-10
DATA_MESH_RTOL = {"fast": 1e-5, "classic": 1e-4}
JAX_SHARDED_RTOL = 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.spawn("training", 4, tmp_path_factory.mktemp("training"), timeout=300,
                   halo=HALO, convs=CONVS, group_norms=GROUP_NORMS, models=MODELS,
                   small=["fast"], refusals=True)


def _key(case) -> str:
    return json.dumps([list(c) if isinstance(c, tuple) else c for c in case])


def _ids(case) -> str:
    return "-".join(map(str, (c if not isinstance(c, list) else "x".join(map(str, c))
                              for c in case)))


@pytest.mark.parametrize("case", HALO, ids=_ids)
def test_exchange_rows_gradient_is_exact(ranks, case):
    starts, counts, tops, bottoms = w.halo_case(*case)
    total, tiles, edge = starts[-1] + counts[-1], case[1], case[-1]
    key = _key(case)
    x = w.grad_inputs(key, (2, total, 3), integer=True)[0].requires_grad_()
    loss = 0.0
    for t in range(tiles):
        idx = torch.arange(starts[t] - tops[t], starts[t] + counts[t] + bottoms[t])
        inside = (idx >= 0) & (idx < total)
        ext = x.index_select(1, idx.clamp(0, total - 1))
        if edge == "zero":
            ext = ext * inside.double()[None, :, None]
        loss = loss + (ext * w.grad_inputs(f"{key}/{t}", tuple(ext.shape), integer=True)[0]).sum()
    loss.backward()
    for t in range(tiles):
        got = ranks[t]["halo"][key]
        assert torch.equal(got, x.grad[:, starts[t]:starts[t] + counts[t]]), t


@pytest.mark.parametrize("case", CONVS, ids=_ids)
def test_tiled_conv_gradient_matches_whole_image(ranks, case):
    height, tiles, scale, kernel, stride, dilation, three_d = case
    key = _key(case)
    rows = height // scale
    shape = (1, 2, 3, rows, 4) if three_d else (1, 2, rows, 6)
    x = w.grad_inputs(key, shape)[0].requires_grad_()
    torch.manual_seed(w.GRAD_SEED)
    conv = (SameConv3d(2, 3, kernel) if three_d else
            SameConv2d(2, 3, kernel, stride, dilation)).double()
    y = conv(x)
    (y * w.grad_inputs(key + "/w", tuple(y.shape))[0]).sum().backward()
    got = [ranks[t]["convs"][key] for t in range(tiles)]
    tol = dict(rtol=FLOAT64_RTOL, atol=FLOAT64_RTOL)
    torch.testing.assert_close(torch.cat([g["x"] for g in got], -2), x.grad, **tol)
    for name in ("weight", "bias"):
        torch.testing.assert_close(add_in_order([g[name] for g in got]),
                                   getattr(conv, name).grad, **tol)


@pytest.mark.parametrize("case", GROUP_NORMS, ids=_ids)
def test_tiled_group_norm_gradient_matches_whole_image(ranks, case):
    shape, with_bias, with_skip, activate = case
    key = _key(case)
    x, skip, wts = (t.requires_grad_() for t in w.grad_inputs(key, tuple(shape), 2))
    gn = GroupNorm(shape[1]).double()
    with torch.no_grad():
        gn.weight.copy_(1.0 + 0.5 * torch.linspace(-1, 1, shape[1], dtype=torch.float64))
        gn.bias.copy_(0.25 * torch.linspace(1, -1, shape[1], dtype=torch.float64))
    cb = torch.linspace(-0.5, 0.5, shape[1], dtype=torch.float64).requires_grad_()
    a = x + cb.view((1, -1) + (1,) * (len(shape) - 2)) if with_bias else x
    r = F.group_norm(a, gn.num_groups, gn.weight, gn.bias, gn.eps)
    r = skip + r if with_skip else r
    out = torch.where(r >= 0, r, 0.2 * r) if activate else r
    (out * wts.detach()).sum().backward()
    got = [ranks[t]["group_norm"][key] for t in range(4)]
    tol = dict(rtol=FLOAT64_RTOL, atol=FLOAT64_RTOL)
    torch.testing.assert_close(torch.cat([g["x"] for g in got], -2), x.grad, **tol)
    want = {"skip": skip.grad if with_skip else None, "conv_bias": cb.grad if with_bias else None}
    if with_skip:
        torch.testing.assert_close(torch.cat([g["skip"] for g in got], -2), want["skip"], **tol)
    else:
        assert all(g["skip"] is None for g in got)
    for name, ref in (("weight", gn.weight.grad), ("bias", gn.bias.grad),
                      ("conv_bias", want["conv_bias"])):
        if ref is None:
            assert all(g[name] is None for g in got)
        else:
            torch.testing.assert_close(add_in_order([g[name] for g in got]), ref, **tol)


def _mesh_ranks(ranks, model, mesh) -> list:
    return [r[("steps")][(model, mesh)] for r in ranks if (model, mesh) in r["steps"]]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("model", MODELS)
def test_sharded_step_within_stored_jax_step(ranks, model, mesh):
    first = _mesh_ranks(ranks, model, mesh)[0][0]
    want = reference.load_train_step(model)["f32"]
    m = first["metrics"]
    assert abs(m["loss"] - want["loss"]) <= reference.TRAIN_F32_RTOL * abs(want["loss"]), \
        (m["loss"], want["loss"])
    assert abs(m["grad_norm"] - want["grad_norm"]) <= reference.TRAIN_F32_NORM_RTOL[model] * \
        want["grad_norm"], (m["grad_norm"], want["grad_norm"])
    bad = reference.grad_mismatches(first["grads"], want["grads"],
                                    reference.TRAIN_F32_GRAD_RTOL)
    assert not bad, bad
    assert reference.grad_distance(first["grads"], want["grads"]) <= \
        reference.TRAIN_F32_GRAD_RTOL
    assert np.isfinite(m["epe"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("model", MODELS)
def test_ranks_bit_equal_after_two_steps(ranks, model, mesh):
    recs = _mesh_ranks(ranks, model, mesh)
    assert len(recs) == mesh[0] * mesh[1]
    for rec in recs[1:]:
        for i in range(2):
            assert rec[i]["digests"] == recs[0][i]["digests"], i
            assert rec[i]["metrics"] == recs[0][i]["metrics"], i
        for path, g in rec[0]["grads"].items():
            np.testing.assert_array_equal(g, recs[0][0]["grads"][path])
    assert recs[0][0]["digests"] != recs[0][1]["digests"]      # the second step moved them


def _network(model):
    cfg = StereoNetConfig(compute_dtype=torch.float32)
    net = build_model(model, cfg, "cpu")
    npz = reference.PARAMS_NPZ if model == "fast" else reference.CLASSIC_PARAMS_NPZ
    net.load_state_dict(from_flax_params(reference.load_params(npz), cfg, model))
    return net, cfg


@pytest.fixture(scope="module")
def one_rank():
    """Per network: the one-rank step's gradients, and the float64 rank-order
    sum of the two half batches' gradients (each with the whole batch's
    valid-pixel counts), rounded once: what the (2, 1) mesh's ranks add."""
    out = {}
    for model in MODELS:
        net, cfg = _network(model)
        batch = w.stored_batch(model)
        opt = training.make_optimizer()
        params = dict(net.named_parameters())
        training.make_train_step(net, opt, cfg.max_disparity)(
            training.TrainState(params, opt.init(params), 0), *batch)
        whole = w.flax_grads(params)
        halves = [slice(0, 2), slice(2, 4)]
        outs = [net(*(t[h] for t in batch[:2]))["pyramid"] for h in halves]
        counts = []
        for pyr, h in zip(outs, halves):
            training._loss_terms(pyr, batch[2][h], None, cfg.max_disparity, None,
                                 total_counts=lambda c: counts.append(c) or c)
        total = add_in_order(counts).float()
        parts = []
        for pyr, h in zip(outs, halves):
            for p in params.values():
                p.grad = None
            loss, _ = training._loss_terms(pyr, batch[2][h], None, cfg.max_disparity, None,
                                           total_counts=lambda c: total)
            loss.backward()
            parts.append({k: p.grad.clone() for k, p in params.items()})
        for k, p in params.items():
            p.grad = add_in_order([q[k] for q in parts]).float()
        out[model] = whole, w.flax_grads(params)
    return out


@pytest.mark.parametrize("model", MODELS)
def test_data_mesh_sums_the_halves_in_rank_order(ranks, one_rank, model):
    got = _mesh_ranks(ranks, model, (2, 1))[0][0]["grads"]
    whole, halves = one_rank[model]
    for path, g in halves.items():
        np.testing.assert_array_equal(got[path], g, err_msg=path)
    bad = reference.grad_mismatches(got, whole, DATA_MESH_RTOL[model])
    assert not bad, bad


def test_sharded_step_matches_jax_sharded_step(ranks, eight_devices):
    jcfg = JStereoNetConfig(compute_dtype=jnp.float32, **w.SMALL)
    params = random_flax_params(w.small_config("fast", "float32").model, seed=0, model="fast")
    batch = [jnp.asarray(t.numpy()) for t in w.small_batch()]
    batch.append(jnp.ones(batch[2].shape, jnp.float32))    # the port's default mask: 0 < 4 < 32
    opt = jtraining.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=100)
    net = JFastStereoNet(jcfg)

    def fresh():
        return jtraining.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))

    mesh = jmesh.make_mesh(JMeshConfig(data=2, tile=2))
    step = jtraining.make_sharded_train_step(net, opt, mesh, max_disparity=32.0)
    _, sharded = step(jmesh.replicate(mesh, fresh()), *(jmesh.shard_batch(mesh, t) for t in batch))
    _, whole = jax.jit(jtraining.make_train_step(net, opt, 32.0))(fresh(), *batch)
    got = ranks[0]["small"]["fast", True]
    for name in ("loss", "epe"):
        np.testing.assert_allclose(got[name], float(sharded[name]), rtol=JAX_SHARDED_RTOL,
                                   err_msg=name)
    # JAX's sharded step doubles every gradient that reaches a GroupNorm at
    # tile = 2 (ROADMAP C11): its norm is held to its unsharded step's
    np.testing.assert_allclose(got["grad_norm"], float(whole["grad_norm"]),
                               rtol=JAX_SHARDED_RTOL)
    assert all(r["small"]["fast", True] == got for r in ranks)


def test_sharded_step_without_row_tiles_matches_one_rank(ranks):
    """``tile_rows=False``: each tile rank runs its data slice's whole rows and
    takes tile rank 0's sums; the metrics are the one-rank step's (the
    gradients summed over data only, in another order)."""
    cfg = StereoNetConfig(compute_dtype=torch.float32, **w.SMALL)
    net = build_model("fast", cfg, "cpu")
    params = random_flax_params(w.small_config("fast", "float32").model, seed=0, model="fast")
    net.load_state_dict(from_flax_params(params, cfg, "fast"))
    opt = training.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=100)
    p = dict(net.named_parameters())
    _, want = training.make_train_step(net, opt, 32.0)(training.TrainState(p, opt.init(p), 0),
                                                        *w.small_batch())
    got = ranks[0]["small"]["fast", False]
    for name in ("loss", "epe", "grad_norm"):
        np.testing.assert_allclose(got[name], float(want[name]), rtol=1e-5, err_msg=name)
    assert all(r["small"]["fast", False] == got for r in ranks)


def test_sharded_step_refuses_what_the_mesh_cannot_split(ranks):
    for r in ranks:
        assert "cannot split 2 rows over 4 tiles" in r["refused"]["tiles"]
        assert r["refused"]["batch"] == "a batch of 5 does not split over data=4"


# ---------------------------------------------------------------------------
# The measurements behind the bounds (``--accuracy``)
# ---------------------------------------------------------------------------


def _step_grads(net, cfg, batch, total_counts=None) -> dict:
    """{flax path: gradient} of one loss on ``batch`` (``total_counts`` as
    ``training._loss_terms`` takes it)."""
    for p in net.parameters():
        p.grad = None
    loss, _ = training._loss_terms(net(*batch[:2])["pyramid"], batch[2], None,
                                   cfg.max_disparity, None, total_counts=total_counts)
    loss.backward()
    return w.flax_grads(dict(net.named_parameters()))


def _relative(got: dict, want: dict) -> dict:
    """Each gradient's relative L2 distance from ``want``'s, the tensors that
    cancel to zero (``reference.ZERO_GRAD_SHARE``) left out."""
    g = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64))) for v in want.values()))
    out = {}
    for k, v in want.items():
        ref = float(np.linalg.norm(np.asarray(v, np.float64)))
        if ref > reference.ZERO_GRAD_SHARE * g:
            out[k] = float(np.linalg.norm(np.asarray(got[k], np.float64) - v)) / ref
    return out


def accuracy_report() -> None:
    """Prints: JAX's sharded step's gradients over its unsharded step's
    (ROADMAP C11); CLASSIC's float32 gradients (JAX's, the one-rank step's,
    the (1, 2) mesh's) against a float64 run of the port; the one-rank
    step's worst gradient against JAX under one-ulp changes of 1 % of the
    input; the one-rank step's gradient of CLASSIC's full-resolution conv
    against the float64 sum of its per-sample gradients."""
    import tempfile

    import optax

    torch.set_num_threads(1)                       # as the tests run (sums' order)
    # 1. JAX's sharded small flagship against its unsharded step
    jcfg = JStereoNetConfig(compute_dtype=jnp.float32, **w.SMALL)
    params = random_flax_params(w.small_config("fast", "float32").model, seed=0, model="fast")
    batch = [jnp.asarray(t.numpy()) for t in w.small_batch()]
    batch.append(jnp.ones(batch[2].shape, jnp.float32))
    net = JFastStereoNet(jcfg)

    def loss(p, left, right, gt, valid):
        return jtraining.multiscale_loss(net.apply(p, left, right), gt, valid, 32.0)[0]

    mesh = jmesh.make_mesh(JMeshConfig(data=2, tile=2))
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    img = jax.sharding.NamedSharding(mesh, jmesh.batch_image_spec(True))
    dmap = jax.sharding.NamedSharding(mesh, jmesh.batch_map_spec(True))
    whole = jax.jit(jax.grad(loss))(params, *batch)
    sharded = jax.jit(jax.grad(loss), in_shardings=(repl, img, img, dmap, dmap),
                      out_shardings=repl)(params, *batch)
    ratios = sorted({round(float(jnp.linalg.norm(b) / jnp.linalg.norm(a)), 4)
                     for a, b in zip(jax.tree_util.tree_leaves(whole),
                                     jax.tree_util.tree_leaves(sharded))
                     if float(jnp.linalg.norm(a)) > 1e-3})
    print(f"JAX sharded (2, 2) / unsharded gradient norms per tensor: {ratios}; global norms "
          f"{float(optax.global_norm(sharded)):.4f} / {float(optax.global_norm(whole)):.4f}")

    # 2. CLASSIC float32 against float64
    stored = reference.load_train_step("classic")["f32"]["grads"]
    net32, cfg32 = _network("classic")
    batch = w.stored_batch("classic")
    one = _step_grads(net32, cfg32, batch)
    cfg64 = StereoNetConfig(compute_dtype=torch.float64)
    net64 = build_model("classic", cfg64, "cpu")
    net64.load_state_dict(from_flax_params(reference.load_params(reference.CLASSIC_PARAMS_NPZ),
                                           cfg64, "classic"))
    f64 = _step_grads(net64.double(), cfg64, [t.double() for t in batch])
    with tempfile.TemporaryDirectory() as tmp:
        ranks = w.spawn("training", 4, Path(tmp), timeout=600, models=["classic"])
    tiled = ranks[2]["steps"]["classic", (1, 2)][0]["grads"]
    key = "RefinementNet_0/ConvBlock_0/Conv_0/kernel"
    for name, g in (("JAX float32", stored), ("one rank", one), ("(1, 2) mesh", tiled)):
        e = _relative(g, f64)
        v = sorted(e.values())
        print(f"CLASSIC {name} against float64: median per tensor {v[len(v) // 2]:.3g}, worst "
              f"{max(e, key=e.get)} {max(v):.3g}, {key} {e[key]:.3g}; worst against JAX "
              f"{max(_relative(g, stored).values()):.4g}")

    # 3. the one-rank step under one-ulp input changes
    for seed in range(1, 6):
        mask = torch.from_numpy(np.random.default_rng(seed).random(batch[0].shape) < 0.01)
        left = torch.where(mask, torch.nextafter(batch[0], torch.full_like(batch[0], 2.0)),
                           batch[0])
        e = _relative(_step_grads(net32, cfg32, [left] + list(batch[1:])), stored)
        print(f"CLASSIC one rank, 1 % of the left input one ulp up (seed {seed}): worst against "
              f"JAX {max(e, key=e.get)} {max(e.values()):.4g}")

    # 4. the one-rank step against the float64 sum of its per-sample gradients
    counts = []
    training._loss_terms(net32(*batch[:2])["pyramid"], batch[2], None, cfg32.max_disparity,
                         None, total_counts=lambda c: counts.append(c) or c)
    parts = [_step_grads(net32, cfg32, [t[i:i + 1] for t in batch], lambda c: counts[0])
             for i in range(batch[0].shape[0])]
    key = "RefinementNet_2/ResBlock2D_0/ConvBlock_0/Conv_0/kernel"
    total = sum(np.asarray(p[key], np.float64) for p in parts)
    data = ranks[0]["steps"]["classic", (2, 1)][0]["grads"][key]
    dist = lambda a, b: np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b)  # noqa
    print(f"CLASSIC {key} against the float64 sum of the per-sample gradients: one rank "
          f"{dist(one[key], total):.3g}, the (2, 1) mesh {dist(data, total):.3g}; the (2, 1) "
          f"mesh against one rank {dist(data, np.asarray(one[key], np.float64)):.3g}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--accuracy"]:
        sys.exit(__doc__)
    accuracy_report()
