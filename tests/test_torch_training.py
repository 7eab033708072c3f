"""The port's training path (``runtime/training.py``, ``train_loop.py``,
``checkpoint.py``, ``data/loader.py``, ``runtime/weights.py``, ``cli.py``)
against the JAX package's, on the CPU at small sizes.

The one-step references (float32 and bf16) run in a subprocess (this
file as a script) under ``XLA_FLAGS=--xla_allow_excess_precision=false``,
as tests/test_torch_reference.py runs its own, beside the module's other
tests; the rest run JAX in this process.

Tolerances:
  * loss pieces, the schedule and AdamW over 5 steps: 1e-6 relative;
  * one float32 step on the SMALL config (tests/test_model.py) and on a
    32-channel one: the loss within 1e-5 relative, every gradient within
    1e-4 relative L2 (CLASSIC 1e-3: its float32 forward is already 2.3e-3
    px off JAX's, ROADMAP C5), the global norm within 1e-5; a gradient that
    cancels to zero in exact arithmetic is held within 1e-6 of the global
    norm (``reference.grad_mismatches``); after 3 steps the parameters
    not initialized to zero within 1e-5 relative L2, and every change
    within 1e-3;
  * one bf16 step: ``reference.bf16_grad_check``, and the loss at most
    four times as far from JAX's float32 loss as JAX's bf16 loss is;
  * batches bit for bit; ``init_params``' per-tensor mean and standard
    deviation within five standard errors of flax's ``lecun_normal``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hobot_stereonet_tpu_torch import reference  # noqa: E402
from hobot_stereonet_tpu_torch.config import StereoNetConfig  # noqa: E402
from hobot_stereonet_tpu_torch.models import FastStereoNet, StereoNet, build_model  # noqa: E402
from hobot_stereonet_tpu_torch.models.layers import cast_convs  # noqa: E402
from hobot_stereonet_tpu_torch.reference import XLA_FLAGS as NO_EXCESS  # noqa: E402
from hobot_stereonet_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from hobot_stereonet_tpu_torch.runtime import training  # noqa: E402
from hobot_stereonet_tpu_torch.runtime.weights import (  # noqa: E402
    _flatten, _unwrap, from_flax_params, init_params, random_flax_params, to_flax_params)

SMALL = dict(feature_channels=8, num_feature_res_blocks=1, num_aggregation_layers=1,
             aggregation_channels=8, num_refinement_res_blocks=1, refinement_channels=8,
             max_disparity=32)
WIDE = dict(SMALL, feature_channels=32, aggregation_channels=32, max_disparity=192)
CONFIGS = {"small": SMALL, "w32": WIDE}
F32_GRAD_RTOL = {"fast": 1e-4, "classic": 1e-3}


def _jax():
    import jax
    import jax.numpy as jnp

    from hobot_stereonet_tpu.config import StereoNetConfig as JConfig
    from hobot_stereonet_tpu.models import FastStereoNet as JFast
    from hobot_stereonet_tpu.models import StereoNet as JClassic
    from hobot_stereonet_tpu.runtime import training as jtraining

    return jax, jnp, JConfig, {"fast": JFast, "classic": JClassic}, jtraining


def _batch(seed: int = 0, b: int = 2, h: int = 32, w: int = 64):
    rng = np.random.default_rng(seed)
    left = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    right = np.roll(left, -4, axis=2) + 0.05 * rng.standard_normal(left.shape).astype(np.float32)
    gt = rng.uniform(1, 20, (b, h, w)).astype(np.float32)
    return left, right, gt


def _jax_case(model: str, cfg_name: str, dtype_name: str):
    """(params, loss, grads tree, global norm) of one JAX step from
    ``PRNGKey(1)`` weights on :func:`_batch`."""
    jax, jnp, JConfig, nets, jtraining = _jax()
    import optax

    kw = CONFIGS[cfg_name]
    left, right, gt = _batch()
    init = nets[model](JConfig(compute_dtype=jnp.float32, **kw)).init
    params = jax.tree_util.tree_map(np.asarray, jax.jit(init)(jax.random.PRNGKey(1),
                                                              left[:1], left[:1]))
    net = nets[model](JConfig(compute_dtype=getattr(jnp, dtype_name), **kw))

    def loss_fn(p):
        return jtraining.multiscale_loss(net.apply(p, left, right), gt, None,
                                         float(kw["max_disparity"]))

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return params, float(loss), jax.tree_util.tree_map(np.asarray, grads), \
        float(optax.global_norm(grads))


def _flat(tree) -> dict:
    return {"/".join(k): np.asarray(v) for k, v in _flatten(_unwrap(tree))}


def _port_net(model, cfg_name, dtype, params):
    cfg = StereoNetConfig(compute_dtype=dtype, **CONFIGS[cfg_name])
    net = build_model(model, cfg, "cpu")
    net.load_state_dict(from_flax_params(params, cfg, model))
    return net


def _port_grads(net, cfg_name):
    left, right, gt = (torch.from_numpy(a) for a in _batch())
    loss, _ = training.multiscale_loss(net(left, right), gt, None,
                                       float(CONFIGS[cfg_name]["max_disparity"]))
    loss.backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])))
    return float(loss.detach()), _flat(to_flax_params(grads)), norm


# ---------------------------------------------------------------------------
# Loss and optimizer pieces
# ---------------------------------------------------------------------------

def test_loss_pieces_match_jax():
    jax, jnp, _, _, jtraining = _jax()
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 3, (2, 16, 32)).astype(np.float32)
    np.testing.assert_allclose(training.smooth_l1(torch.from_numpy(x)).numpy(),
                               np.asarray(jtraining.smooth_l1(jnp.asarray(x))), rtol=1e-6)
    gt = rng.uniform(0, 60, (2, 64, 128)).astype(np.float32)
    for h, w in ((32, 64), (16, 32), (8, 16)):
        got = training._downsample_disparity(torch.from_numpy(gt), h, w).numpy()
        want = np.asarray(jtraining._downsample_disparity(jnp.asarray(gt), h, w))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 60)
    gt[0, :5] = 0.0                       # invalid rows
    gt[1, :, :7] = 250.0                  # beyond max_disparity
    pyramid = [rng.uniform(0, 60, (2, 64 // s, 128 // s)).astype(np.float32) for s in (8, 4, 1)]
    for valid in (None, (rng.uniform(size=gt.shape) > 0.3).astype(np.float32)):
        got = training.multiscale_loss(
            {"pyramid": [torch.from_numpy(p) for p in pyramid]}, torch.from_numpy(gt),
            None if valid is None else torch.from_numpy(valid))
        want = jtraining.multiscale_loss({"pyramid": [jnp.asarray(p) for p in pyramid]},
                                         jnp.asarray(gt), None if valid is None else
                                         jnp.asarray(valid))
        for k in ("loss", "epe"):
            np.testing.assert_allclose(float(got[1][k]), float(want[1][k]), rtol=1e-6)


def test_optimizer_matches_optax():
    """The schedule at every step, then clip + AdamW over 5 steps with fixed
    gradients (some above the clip's norm, some below), parameters to 1e-6."""
    import optax

    jax, jnp, _, _, jtraining = _jax()
    opt = training.make_optimizer(lr=3e-3, weight_decay=1e-2, warmup_steps=3, total_steps=9)
    jopt = jtraining.make_optimizer(lr=3e-3, weight_decay=1e-2, warmup_steps=3, total_steps=9)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 3, 9)
    for count in range(12):
        np.testing.assert_allclose(opt.schedule(count), float(sched(count)), rtol=1e-6,
                                   atol=1e-12)
    assert opt.schedule(0) == 0.0
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (s * rng.standard_normal(v.shape)).astype(np.float32) for k, v in params.items()}
             for s in (2.0, 0.05, 1.0, 0.1, 3.0)]
    jp, js = params, jopt.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts, norm = opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# Batches and initialization
# ---------------------------------------------------------------------------

def test_batch_iterator_bit_equal_to_jax():
    from hobot_stereonet_tpu.data.loader import BatchIterator as JBatchIterator
    from hobot_stereonet_tpu.data.loader import SyntheticStereoDataset as JDataset
    from hobot_stereonet_tpu_torch.data.loader import BatchIterator, SyntheticStereoDataset

    kw = dict(size=5, seed=3, height=48, width=96)
    for bkw in (dict(batch_size=2, crop_hw=(32, 64), seed=4),
                dict(batch_size=1, crop_hw=(64, 128), seed=1, augment=False)):
        port = iter(BatchIterator(SyntheticStereoDataset(**kw), **bkw))
        ref = iter(JBatchIterator(JDataset(**kw), **bkw))
        for _ in range(4):                  # past the first epoch's end
            for a, b in zip(next(port), next(ref)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", ["fast", "classic"])
def test_init_params_follow_flax_lecun_normal(model):
    """Each tensor's mean and standard deviation within five standard errors
    of what flax's initializers draw (kernels: truncated normal of variance
    1/fan_in; biases 0; GroupNorm scales 1)."""
    jax, jnp, JConfig, nets, _ = _jax()
    cfg = StereoNetConfig(compute_dtype=torch.float32, **WIDE)
    state = init_params(cfg, model, torch.Generator().manual_seed(0))
    x = np.zeros((1, 32, 64, 3), np.float32)
    flax = _flat(jax.jit(nets[model](JConfig(compute_dtype=jnp.float32, **WIDE)).init)(
        jax.random.PRNGKey(0), x, x))
    port = _flat(to_flax_params(state))
    assert sorted(port) == sorted(flax)
    for k, want in flax.items():
        got = port[k]
        assert got.shape == want.shape and got.dtype == np.float32
        if not k.endswith("kernel"):
            np.testing.assert_array_equal(got, want)
            continue
        n, sd = got.size, 1.0 / np.sqrt(np.prod(got.shape[:-1]))      # fan_in = all but O
        assert abs(got.mean() - want.mean()) <= 5 * sd * np.sqrt(2.0 / n), k
        # the sample variance's standard error, with the truncated normal's kurtosis (2.6)
        assert abs(got.var() - want.var()) <= 5 * sd ** 2 * np.sqrt(1.6 / n) * np.sqrt(2), k
        assert np.abs(got).max() <= 2 * sd / 0.87962566 * (1 + 1e-6), k


# ---------------------------------------------------------------------------
# One training step against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["fast", "classic"])
def test_three_f32_steps_match_jax(model):
    """``make_train_step`` three times against the JAX package's jitted
    step: parameters within 1e-5 relative L2 (those not initialized to
    zero), their change within 1e-3.
    A parameter whose gradient cancels to zero in exact arithmetic
    (``reference.grad_mismatches``) gets Adam steps of float32 noise's sign
    on both sides: it is held to Adam's step size instead."""
    jax, jnp, JConfig, nets, jtraining = _jax()
    kw = SMALL
    left, right, gt = _batch(seed=1)
    jnet = nets[model](JConfig(compute_dtype=jnp.float32, **kw))
    jopt = jtraining.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=100)
    state = jtraining.create_train_state(jnet, jax.random.PRNGKey(2), jopt, left[:1], right[:1])
    init = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    g0 = _flat(jax.jit(jax.grad(lambda p: jtraining.multiscale_loss(
        jnet.apply(p, left, right), gt, None, 32.0)[0]))(state.params))
    g_norm = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64))) for v in g0.values()))
    noise = {k for k, v in g0.items() if np.linalg.norm(v) <= reference.ZERO_GRAD_SHARE * g_norm}
    net = _port_net(model, "small", torch.float32, jax.tree_util.tree_map(np.asarray,
                                                                          state.params))
    opt = training.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=100)
    params = dict(net.named_parameters())
    tstate = training.TrainState(params, opt.init(params), 0)
    jstep = jax.jit(jtraining.make_train_step(jnet, jopt, max_disparity=32.0))
    tstep = training.make_train_step(net, opt, max_disparity=32.0)
    for _ in range(3):
        state, jm = jstep(state, left, right, gt)
        tstate, tm = tstep(tstate, *(torch.from_numpy(a) for a in (left, right, gt)))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=F32_GRAD_RTOL[model])
    assert tstate.step == 3
    want = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    got = _flat(to_flax_params(tstate.params))
    for k, w in want.items():
        if k in noise:          # |Adam step| <= lr (1 - b1) / sqrt(1 - b2), 3 steps
            assert np.abs(got[k] - init[k]).max() <= 3 * 1e-3 * 0.1 / np.sqrt(1e-3), k
            continue
        if np.linalg.norm(init[k]) > 0:     # zero-initialized: all of it is the change
            assert np.linalg.norm(got[k] - w) <= 1e-5 * np.linalg.norm(w), k
        moved = w - init[k]
        if np.linalg.norm(moved) > 0:
            assert np.linalg.norm((got[k] - init[k]) - moved) <= 1e-3 * np.linalg.norm(moved), k


def _jax_steps(out_path: str) -> None:
    """JAX's weights and its float32 and bf16 losses and gradients of every
    case into ``out_path``."""
    assert NO_EXCESS in os.environ.get("XLA_FLAGS", ""), "run under " + NO_EXCESS
    out = {}
    for model in ("fast", "classic"):
        for cfg_name in CONFIGS:
            for dt in ("float32", "bfloat16"):
                params, loss, grads, _ = _jax_case(model, cfg_name, dt)
                tag = f"{model}/{cfg_name}/{dt}"
                out[f"{tag}/loss"] = np.array(loss)
                out.update({f"{tag}/grad/{k}": v for k, v in _flat(grads).items()})
            out.update({f"{model}/{cfg_name}/params/{k}": v for k, v in _flat(params).items()})
    np.savez(out_path, **out)


@pytest.fixture(scope="module", autouse=True)
def jax_steps_job(tmp_path_factory):
    """The reference steps' subprocess, started with the module's first test
    so that it runs beside the tests that need no reference step."""
    out_path = tmp_path_factory.mktemp("jax_steps") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS=NO_EXCESS, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, __file__, "--jax-steps", str(out_path)],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, out_path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_steps(jax_steps_job):
    proc, out_path = jax_steps_job
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out[-3000:]
    with np.load(out_path) as data:
        return {k: data[k] for k in data.files}


def _sub(arrays: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def _unflat(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        *mods, leaf = k.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return {"params": tree}


@pytest.mark.parametrize("model", ["fast", "classic"])
def test_remat_recomputes_the_tower_and_changes_no_gradient(model):
    """``cfg.remat`` (the reference's ``nn.remat(FeatureTower)``) gives the
    same loss and gradients, bit for bit."""
    params = random_flax_params(StereoNetConfig(**SMALL), seed=5, model=model)
    out = []
    for remat in (False, True):
        cfg = StereoNetConfig(compute_dtype=torch.float32, remat=remat, **SMALL)
        net = build_model(model, cfg, "cpu")
        net.load_state_dict(from_flax_params(params, cfg, model))
        out.append(_port_grads(net, "small"))
    (l0, g0, _), (l1, g1, _) = out
    assert l0 == l1 and all(np.array_equal(g0[k], g1[k]) for k in g0)


# ---------------------------------------------------------------------------
# Checkpoints, the loop and the CLI
# ---------------------------------------------------------------------------

def test_flax_round_trip_and_structure_check(tmp_path):
    params = reference.load_params()
    back = to_flax_params(from_flax_params(params))
    a, b = _flat(params), _flat(back)
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    ckpt.save_params(str(tmp_path / "p"), from_flax_params(params))
    restored = ckpt.load_params(str(tmp_path / "p"), like=params)
    assert all(np.array_equal(_flat(restored)[k], a[k]) for k in a)
    small = FastStereoNet(StereoNetConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.load_params(str(tmp_path / "p"), like=small)


def test_port_trained_checkpoint_serves_in_jax(tmp_path):
    """Train two steps, save, load the ``.npz`` into the JAX package's
    ``FastStereoNet``: its float32 forward matches the port's."""
    jax, jnp, JConfig, nets, _ = _jax()
    from hobot_stereonet_tpu_torch.runtime.train_loop import train_synthetic

    cfg = StereoNetConfig(compute_dtype=torch.float32, **SMALL)
    net = FastStereoNet(cfg, device="cpu")
    train_synthetic(steps=2, batch_size=1, crop_hw=(32, 64), log_every=0, model=net,
                    model_cfg=cfg, checkpoint_dir=str(tmp_path / "ck"), device="cpu")
    params = ckpt.load_params(str(tmp_path / "ck"), like=net)
    left, right, _ = _batch(seed=2, h=64, w=128)
    with torch.inference_mode():
        got = net(torch.from_numpy(left), torch.from_numpy(right))["disparity"].numpy()
    want = jax.jit(nets["fast"](JConfig(compute_dtype=jnp.float32, **SMALL)).apply)(
        params, left, right)["disparity"]
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3)


def test_train_synthetic_resumes_and_saves(tmp_path):
    from hobot_stereonet_tpu_torch.runtime.train_loop import train_synthetic

    cfg = StereoNetConfig(compute_dtype=torch.float32, **SMALL)
    kw = dict(steps=2, batch_size=1, crop_hw=(32, 64), log_every=1, model_cfg=cfg,
              device="cpu", color_space="yuv")
    first = train_synthetic(checkpoint_dir=str(tmp_path / "a"), **kw)
    assert first["steps"] == 2 and len(first["history"]) == 2 and first["steps_per_sec"] > 0
    assert np.isfinite(first["final_loss"])
    saved = ckpt.load_params(str(tmp_path / "a"))
    second = train_synthetic(checkpoint_dir=str(tmp_path / "b"), resume_from=str(tmp_path / "a"),
                             **kw)
    assert np.isfinite(second["final_loss"])
    # the resumed run starts from the saved weights, not from a fresh draw
    net = FastStereoNet(cfg, device="cpu")
    state = training.TrainState(dict(net.named_parameters()), {}, 0)
    opt = training.make_optimizer()
    state.opt_state = opt.init(state.params)
    restored = ckpt.load_train_state(str(tmp_path / "a"), state)
    assert restored.step == 2 and restored.opt_state["count"] == 2
    for k, v in _flat(to_flax_params(restored.params)).items():
        np.testing.assert_array_equal(v, _flat(saved)[k])
    classic = train_synthetic(steps=1, batch_size=1, crop_hw=(32, 64), log_every=0,
                              model="classic", model_cfg=cfg, device="cpu")
    assert np.isfinite(classic["final_loss"])


def test_cli_train_on_the_cpu(tmp_path):
    cfg_path = tmp_path / "config.json"
    with open(ROOT / "checkpoints" / "flagship" / "config.json") as f:
        cfg = json.load(f)
    cfg["model"].update(SMALL, compute_dtype="float32")
    cfg_path.write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "hobot_stereonet_tpu_torch.cli", "train", "--config",
         str(cfg_path), "--steps", "2", "--batch", "1", "--log-every", "1", "--device", "cpu",
         "--checkpoint", str(tmp_path / "ck")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert metrics["steps"] == 2 and np.isfinite(metrics["final_loss"])
    assert (tmp_path / "ck" / "params.npz").is_file()


# ---------------------------------------------------------------------------
# Serving is unchanged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["fast", "classic"])
def test_master_weights_serve_the_bits_of_cast_convs(model):
    """float32 master weights computing in bf16 give, under
    ``inference_mode``, the bits of the network whose convs were cast to
    bf16 (the serving path)."""
    cfg = StereoNetConfig(**SMALL)
    params = from_flax_params(random_flax_params(cfg, seed=4, model=model), cfg, model)
    master = build_model(model, cfg, "cpu")
    master.load_state_dict(params)
    served = cast_convs(build_model(model, cfg, "cpu"), torch.bfloat16)
    served.load_state_dict(params)
    assert master.FeatureTower_0.Conv_0.weight.dtype == torch.float32
    assert served.FeatureTower_0.Conv_0.weight.dtype == torch.bfloat16
    left, right, _ = _batch(seed=6, h=64, w=128)
    with torch.inference_mode():
        a = master(torch.from_numpy(left), torch.from_numpy(right))
        b = served(torch.from_numpy(left), torch.from_numpy(right))
    for k in ("disparity", "confidence"):
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# One step against the reference subprocess's (last, so that the tests above
# run while it computes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("model", ["fast", "classic"])
def test_f32_step_matches_jax(jax_steps, model, cfg_name):
    tag = f"{model}/{cfg_name}"
    params = _unflat(_sub(jax_steps, f"{tag}/params/"))
    jloss = float(jax_steps[f"{tag}/float32/loss"])
    jgrads = _sub(jax_steps, f"{tag}/float32/grad/")
    jnorm = float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64)) for g in jgrads.values())))
    loss, grads, norm = _port_grads(_port_net(model, cfg_name, torch.float32, params), cfg_name)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    assert abs(norm - jnorm) <= 1e-5 * jnorm, (norm, jnorm)
    bad = reference.grad_mismatches(grads, jgrads, F32_GRAD_RTOL[model])
    assert not bad, bad


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("model", ["fast", "classic"])
def test_bf16_step_within_jax_bf16_error(jax_steps, model, cfg_name):
    tag = f"{model}/{cfg_name}"
    params = _unflat(_sub(jax_steps, f"{tag}/params/"))
    loss, grads, _ = _port_grads(_port_net(model, cfg_name, torch.bfloat16, params), cfg_name)
    l16, l32 = (float(jax_steps[f"{tag}/{dt}/loss"]) for dt in ("bfloat16", "float32"))
    assert abs(loss - l32) <= reference.BF16_LOSS_FACTOR * abs(l16 - l32), (loss, l16, l32)
    res = reference.bf16_grad_check(grads, _sub(jax_steps, f"{tag}/bfloat16/grad/"),
                                    _sub(jax_steps, f"{tag}/float32/grad/"))
    assert res["ok"], res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax-steps", metavar="NPZ", required=True,
                    help="JAX's float32 and bf16 steps into NPZ (runs under " + NO_EXCESS + ")")
    _jax_steps(ap.parse_args().jax_steps)
