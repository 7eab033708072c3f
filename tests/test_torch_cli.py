"""The port's command line (``hobot_stereonet_tpu_torch/cli.py``) on the CPU.

Each command runs in-process through ``main([...])`` with ``--device cpu``
at a small size and prints one JSON line.  Where the JAX package's CLI
computes the same thing on the same weights, the lines are compared:

  * ``eval --dataset layered``: the flagship's EPE and D1 within the bf16
    bounds the flagship's tests hold (median 0.03 px; measured EPE 0.0009 px
    apart on two frames);
  * ``calibrate``: the float32 flagship's scales within 1e-5 relative, as
    ``test_calibrate_activation_scales_matches_jax``;
  * ``dump``: a float32 dump of each package on the same pair, diffed by the
    port's ``compare`` to the float32 tolerance of
    ``tests/test_torch_reference.py`` (1e-3), key by key;
  * ``infer`` on a raw ``.nv12`` pair: the JAX CLI's RGB decode bit for bit.

Within the port: ``infer --input-bin`` equals ``StereoEngine.infer_preprocessed``
on the same tensor, ``infer`` on images equals ``StereoEngine.infer``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from hobot_stereonet_tpu_torch import cli
from hobot_stereonet_tpu_torch.reference import CALIB_JSON, PARAMS_NPZ

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_CONFIG = os.path.join(ROOT, "checkpoints", "flagship", "config.json")
FLAGSHIP_ORBAX = os.path.join(ROOT, "checkpoints", "flagship", "params")
H, W = 64, 128
TINY_MODEL = dict(feature_channels=8, num_feature_res_blocks=1, num_aggregation_layers=1,
                  aggregation_channels=8, max_disparity=32, compute_dtype="float32")


def _run(main, argv):
    """(exit code, the last stdout line as JSON) of ``main(argv)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return rc, json.loads(lines[-1])


def port(*argv):
    return _run(cli.main, list(argv))


def jax_cli(*argv):
    from hobot_stereonet_tpu import cli as jcli

    return _run(jcli.main, list(argv))


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    """A config at 64x128 with a tiny float32 FastStereoNet."""
    path = tmp_path_factory.mktemp("cfg") / "tiny.json"
    path.write_text(json.dumps({"camera": {"width": W, "height": H}, "model": TINY_MODEL,
                                "engine": {"max_batch": 4, "batch_buckets": [1, 2, 4]}}))
    return str(path)


@pytest.fixture(scope="module")
def f32_flagship_config(tmp_path_factory):
    """The flagship's config with float32 compute."""
    cfg = json.loads(open(FLAGSHIP_CONFIG).read())
    cfg["model"]["compute_dtype"] = "float32"
    path = tmp_path_factory.mktemp("cfg") / "flagship_f32.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A rendered stereo pair at 64x128 as two PNG files."""
    from hobot_stereonet_tpu_torch.data.synthetic import SyntheticConfig, generate_pair

    left, right, _ = generate_pair(np.random.default_rng(3), SyntheticConfig(height=H, width=W))
    d = tmp_path_factory.mktemp("pair")
    paths = []
    for name, img in (("left.png", left), ("right.png", right)):
        Image.fromarray(img).save(d / name)
        paths.append(str(d / name))
    return left, right, paths


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _args(**kw):
    import argparse

    return argparse.Namespace(**{"checkpoint": None, "config": None, "model": "fast", **kw})


def test_checkpoint_resolution_follows_the_jax_cli():
    """The crowned flagship by default (its config's model, the weights of
    ``reference/flagship_params.npz``); ``none`` random; ``--config`` and
    ``--model classic`` without ``--checkpoint`` random, as in the JAX CLI."""
    from hobot_stereonet_tpu_torch.config import Config

    cfg, path = cli._resolve_checkpoint(_args(), Config())
    assert path == str(PARAMS_NPZ)
    assert cfg.model == Config.from_json(FLAGSHIP_CONFIG).model
    assert cfg.preprocess == Config().preprocess            # the model alone, as JAX's
    for kw in (dict(checkpoint="none"), dict(config=FLAGSHIP_CONFIG), dict(model="classic")):
        assert cli._resolve_checkpoint(_args(**kw), Config())[1] is None
    assert cli._resolve_checkpoint(_args(checkpoint="x.npz"), Config())[1] == "x.npz"


def test_orbax_directory_is_refused(capsys):
    rc = cli.main(["eval", "--dataset", "layered", "--frames", "1", "--checkpoint",
                   FLAGSHIP_ORBAX, "--device", "cpu"])
    assert rc == 2 and "params.npz" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# eval, calibrate, dump and compare against the JAX CLI
# ---------------------------------------------------------------------------

def test_eval_layered_matches_jax_cli():
    """The flagship (default checkpoint) on 4 layered scenes: EPE and D1
    within the flagship's bf16 bounds of the JAX CLI's; the determinism
    check passes."""
    rc, got = port("eval", "--dataset", "layered", "--frames", "4", "--check-determinism",
                   "--device", "cpu")
    jrc, want = jax_cli("eval", "--dataset", "layered", "--frames", "4")
    assert rc == jrc == 0 and got["deterministic"] is True
    assert got["n_frames"] == want["n_frames"] == 4
    assert abs(got["epe_px"] - want["epe_px"]) <= 0.03, (got, want)
    assert abs(got["d1_all"] - want["d1_all"]) <= 0.01, (got, want)


def test_eval_int8_schemes_run_the_served_network(tmp_path, tiny_config):
    """``eval`` evaluates the network the engine serves: bf16 (here float32),
    int8 dynamic and int8 static with a calibration ``calibrate`` wrote,
    each equal to ``evaluate_dataset`` in that scheme on the same weights.
    (The JAX CLI evaluates the float network under ``--int8-calib``; the
    port honours the flag.)"""
    from hobot_stereonet_tpu_torch.config import Config
    from hobot_stereonet_tpu_torch.data.loader import SyntheticStereoDataset
    from hobot_stereonet_tpu_torch.runtime.evaluate import evaluate_dataset
    from hobot_stereonet_tpu_torch.runtime.weights import random_flax_params

    calib = str(tmp_path / "calib.json")
    rc, got = port("calibrate", "--out", calib, "--frames", "1", "--height", str(H), "--width",
                   str(W), "--config", tiny_config, "--checkpoint", "none", "--device", "cpu")
    assert rc == 0 and got["convs"] == 12
    common = ["eval", "--dataset", "synthetic", "--frames", "1", "--checkpoint", "none",
              "--config", tiny_config, "--device", "cpu"]
    cfg = Config.from_json(tiny_config)
    params = random_flax_params(cfg.model, seed=0)
    ds = SyntheticStereoDataset(size=1, height=256, width=512, seed=777)
    epes = set()
    for extra, kw in (([], {}), (["--int8"], dict(int8=True)),
                      (["--int8-calib", calib], dict(static_quant=calib))):
        rc, got = port(*common, *extra)
        want = evaluate_dataset("fast", params, ds, cfg, device="cpu", **kw)
        assert rc == 0 and got["epe_px"] == round(want.epe, 4), (extra, got, want.epe)
        epes.add(want.epe)
    assert len(epes) == 3


def test_calibrate_matches_jax_cli(tmp_path, f32_flagship_config):
    """One 64x128 frame through the float32 flagship: the same convs, each
    scale within 1e-5 relative of the JAX CLI's."""
    common = ["--frames", "1", "--height", str(H), "--width", str(W), "--config",
              f32_flagship_config]
    rc, got = port("calibrate", "--out", str(tmp_path / "port.json"), *common, "--checkpoint",
                   str(PARAMS_NPZ), "--device", "cpu")
    jrc, want = jax_cli("calibrate", "--out", str(tmp_path / "jax.json"), *common,
                        "--checkpoint", FLAGSHIP_ORBAX)
    assert rc == jrc == 0 and got["convs"] == want["convs"] == 28 and got["frames"] == 1
    a = json.loads((tmp_path / "port.json").read_text())
    b = json.loads((tmp_path / "jax.json").read_text())
    assert sorted(a) == sorted(b)
    for k in b:
        assert abs(a[k] - b[k]) <= 1e-5 * b[k], (k, a[k], b[k])


def test_dump_and_compare_against_the_jax_cli(tmp_path, pair, f32_flagship_config):
    """float32 dumps of the flagship by both CLIs on the same PNG pair, and
    their raw ``--bin-out`` sets: the port's ``compare`` finds every tensor
    of both within 1e-3; a dump against a perturbed copy exits 1."""
    _, _, (lp, rp) = pair
    common = ["--left", lp, "--right", rp, "--config", f32_flagship_config]
    rc, got = port("dump", *common, "--out", str(tmp_path / "port.npz"), "--bin-out",
                   str(tmp_path / "port_bin"), "--checkpoint", str(PARAMS_NPZ), "--device", "cpu")
    jrc, want = jax_cli("dump", *common, "--out", str(tmp_path / "jax.npz"), "--bin-out",
                        str(tmp_path / "jax_bin"), "--checkpoint", FLAGSHIP_ORBAX)
    assert rc == jrc == 0 and got["bin_out"] == str(tmp_path / "port_bin")
    for a, b in (("port.npz", "jax.npz"), ("port_bin", "jax_bin")):
        rc, res = port("compare", str(tmp_path / a), str(tmp_path / b), "--rtol", "1e-3",
                       "--atol", "1e-3")
        assert rc == 0 and res["match"] is True and not res["mismatches"], res
    assert res["tensors"] == 2
    assert got["tensors"] == want["tensors"]
    for raw in ("input_float_nchw.raw", "input_quant_nchw.raw"):
        assert (tmp_path / "port_bin" / raw).read_bytes() == (tmp_path / "jax_bin" / raw
                                                              ).read_bytes()
    with np.load(tmp_path / "port.npz") as d:
        bad = {k: d[k] for k in d.files}
    bad["disparity"] = bad["disparity"] + 1.0
    np.savez(tmp_path / "bad.npz", **bad)
    rc, res = port("compare", str(tmp_path / "port.npz"), str(tmp_path / "bad.npz"))
    assert rc == 1 and res["match"] is False and list(res["mismatches"]) == ["disparity"]


# ---------------------------------------------------------------------------
# infer
# ---------------------------------------------------------------------------

def _engine(config, **kw):
    from hobot_stereonet_tpu_torch.config import Config
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine

    return StereoEngine(Config.from_json(config), device="cpu", **kw)


def test_infer_input_bin_equals_the_engine(tmp_path, tiny_config):
    """A float32 NCHW tensor written by ``save_input_tensor`` and replayed by
    ``infer --input-bin``: the statistics of ``infer_preprocessed`` on the
    same tensor; ``--out`` writes the colorized disparity."""
    from hobot_stereonet_tpu_torch.data.bintensor import load_input_tensor, save_input_tensor

    x = np.random.default_rng(5).uniform(-1, 1, (1, H, W, 6)).astype(np.float32)
    path = str(tmp_path / "x.raw")
    save_input_tensor(path, x, dtype="float32", layout="nchw")
    rc, got = port("infer", "--input-bin", path, "--bin-height", str(H), "--bin-width", str(W),
                   "--config", tiny_config, "--checkpoint", "none", "--device", "cpu", "--out",
                   str(tmp_path / "disp.png"))
    disp = _engine(tiny_config).infer_preprocessed(load_input_tensor(path, H, W))
    assert rc == 0 and got["source"] == "bin" and got["shape"] == [H, W]
    assert got["disparity_px"] == {"min": float(disp.min()), "max": float(disp.max()),
                                   "mean": float(disp.mean()), "median": float(np.median(disp))}
    assert np.asarray(Image.open(tmp_path / "disp.png")).shape == (H, W, 3)


def test_infer_images_and_nv12_equal_the_engine(tmp_path, pair, tiny_config):
    """``infer`` on the PNG pair and on the same pair as raw ``.nv12`` files:
    the statistics of ``StereoEngine.infer`` on the decoded images; the
    ``.nv12`` decode equals the JAX CLI's bit for bit; ``--out`` writes the
    left view over the disparity."""
    from hobot_stereonet_tpu import cli as jcli
    from hobot_stereonet_tpu_torch.ops import colorspace as cs

    left, right, (lp, rp) = pair
    eng = _engine(tiny_config)
    for name, img in (("l.nv12", left), ("r.nv12", right)):
        bgr = torch.from_numpy(np.ascontiguousarray(img[..., ::-1]))
        cs.bgr_to_nv12(bgr).numpy().tofile(tmp_path / name)
    nv12 = [str(tmp_path / "l.nv12"), str(tmp_path / "r.nv12")]
    decoded = [cli._read_any_image(p, H, W) for p in nv12]
    for p, got in zip(nv12, decoded):
        np.testing.assert_array_equal(got, jcli._read_any_image(p, H, W))
    for (a, b), out in (((lp, rp), "png.png"), (tuple(nv12), "nv12.png")):
        rc, got = port("infer", "--left", a, "--right", b, "--nv12-height", str(H),
                       "--nv12-width", str(W), "--config", tiny_config, "--checkpoint", "none",
                       "--device", "cpu", "--out", str(tmp_path / out))
        imgs = (left, right) if out == "png.png" else decoded
        disp = eng.infer(*imgs)
        assert rc == 0 and got["shape"] == [H, W]
        assert got["disparity_px"] == {"min": float(disp.min()), "max": float(disp.max()),
                                       "mean": float(disp.mean())}
        assert np.asarray(Image.open(tmp_path / out)).shape == (2 * H, W, 3)


def test_infer_needs_an_input():
    with pytest.raises(SystemExit, match="--left/--right"):
        cli.main(["infer", "--device", "cpu"])


# ---------------------------------------------------------------------------
# stream and bench
# ---------------------------------------------------------------------------

def test_stream_through_the_native_ring(tiny_config):
    """The synthetic stream, unpaced, through the capture thread's native
    ring: every frame served, the ring named in the JSON line."""
    from hobot_stereonet_tpu_torch.runtime import hostio

    assert hostio.available()
    rc, got = port("stream", "--frames", "5", "--unpaced", "--ring", "--config", tiny_config,
                   "--checkpoint", "none", "--device", "cpu")
    assert rc == 0 and got["frames_out"] + got["capture_dropped"] == 5
    assert got["capture_ring"] == "native" and got["nan_dropped"] == 0
    assert got["epe_px"] >= 0
    rc, got = port("stream", "--frames", "2", "--unpaced", "--config", tiny_config,
                   "--checkpoint", "none", "--device", "cpu")
    assert rc == 0 and got["frames_out"] == 2 and "capture_ring" not in got


def test_stream_image_lists_with_live_view(tmp_path, pair, tiny_config):
    """Image-list replay (the capture ring on by default) with ``--serve 0``:
    both listed pairs served and published."""
    _, _, (lp, rp) = pair
    for side, path in (("left", lp), ("right", rp)):
        (tmp_path / f"{side}.list").write_text(f"# pairs\n{path}\n\n{os.path.basename(path)}\n")
        os.symlink(path, tmp_path / os.path.basename(path))
    rc, got = port("stream", "--left-list", str(tmp_path / "left.list"), "--right-list",
                   str(tmp_path / "right.list"), "--unpaced", "--serve", "0", "--config",
                   tiny_config, "--checkpoint", "none", "--device", "cpu")
    assert rc == 0 and got["frames_out"] == 2 and got["capture_ring"] == "native"


def test_bench_prints_bench_py_line(monkeypatch, tmp_path):
    """``bench`` drives ``measure_engine_fps`` with bench.py's regime (here
    cut to 64x128, 2 frames a batch, for the CPU) and prints its line."""
    from hobot_stereonet_tpu_torch.runtime import benchmark

    seen = []
    real = benchmark.measure_engine_fps

    def small(**kw):
        seen.append(dict(kw))
        kw.update(batch=2, n_batches=1, height=H, width=W)
        if kw.get("model_cfg") is None:
            from hobot_stereonet_tpu_torch.config import StereoNetConfig

            kw["model_cfg"] = StereoNetConfig(**{**TINY_MODEL, "compute_dtype": torch.float32})
        return real(**kw)

    monkeypatch.setattr(benchmark, "measure_engine_fps", small)
    rc, got = port("bench", "--streaming", "--stage-timing", "--device", "cpu", "--out",
                   str(tmp_path / "b.json"))
    assert rc == 0 and got["metric"] == "stereo_fps_per_chip_1280x720_streaming_stage_timing"
    assert got["unit"] == "frames/s" and got["value"] > 0
    assert got["vs_baseline"] == round(got["value"] / 15.0, 2)
    assert seen[0]["batch"] == 32 and seen[0]["n_batches"] == 12
    assert seen[0]["preprocess_cfg"].color_space == "yuv"
    full = json.loads((tmp_path / "b.json").read_text())
    assert full["metric"] == got["metric"] and "network_ms" in full
    rc, got = port("bench", "--int8-static", "--device", "cpu")
    assert got["metric"] == "stereo_fps_per_chip_1280x720_int8static_flagship"
    assert seen[1]["batch"] == 128 and seen[1]["static_quant"] == str(CALIB_JSON)


# ---------------------------------------------------------------------------
# --debug-nans
# ---------------------------------------------------------------------------

def test_debug_nans_raises_at_the_first_nonfinite_module():
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import FastStereoNet
    from hobot_stereonet_tpu_torch.utils.debug import raise_on_nonfinite

    net = FastStereoNet(StereoNetConfig(**{**TINY_MODEL, "compute_dtype": torch.float32}),
                        device="cpu").eval()
    x = torch.rand(1, H, W, 3) * 2 - 1
    handles = raise_on_nonfinite(net)
    with torch.inference_mode():
        net(x, x)                                     # finite: no raise
        net.FeatureTower_0.ResBlock2D_0.Conv_0.weight[0, 0, 0, 0] = float("nan")
        with pytest.raises(FloatingPointError, match="FeatureTower_0.ResBlock2D_0.Conv_0 "):
            net(x, x)
    for h in handles:
        h.remove()


def test_common_flags_parse_for_every_command(tiny_config, tmp_path):
    """``--int8``, ``--int8-calib`` and ``--debug-nans`` on a serving
    command; ``train`` takes them too (its anomaly detection is scoped to
    the call)."""
    rc, got = port("eval", "--dataset", "synthetic", "--frames", "1", "--checkpoint", "none",
                   "--config", tiny_config, "--device", "cpu", "--debug-nans", "--int8-calib",
                   str(CALIB_JSON))
    assert rc == 0 and got["n_frames"] == 1
    rc, got = port("train", "--steps", "1", "--batch", "2", "--log-every", "0", "--config",
                   tiny_config, "--device", "cpu", "--debug-nans", "--int8")
    assert rc == 0 and got["steps"] == 1 and np.isfinite(got["final_loss"])
    assert not torch.is_anomaly_enabled()


# ---------------------------------------------------------------------------
# slam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loop_closure", [False, True])
def test_slam_on_gt_disparity_matches_the_jax_cli(loop_closure):
    """The synthetic trajectory on ground-truth disparity: the JAX command's
    keys and counts, its ATE bound (0.05 m) and its ATE within 0.01 m."""
    extra = ["--loop-closure"] if loop_closure else []
    rc, got = port("slam", "--gt-disparity", "--device", "cpu", *extra)
    jrc, want = jax_cli("slam", "--gt-disparity", *extra)
    assert rc == jrc == 0
    assert set(want) <= set(got) and set(got) - set(want) == {"frames_per_s"}
    for k in ("frames", "tracked", "disparity_source", "loops_closed"):
        assert got.get(k) == want.get(k), k
    assert got["tracked"] == got["frames"] == 12
    assert got["ate_m"] < 0.05 and abs(got["ate_m"] - want["ate_m"]) < 0.01


def test_slam_with_network_disparity_on_the_cpu(tiny_config):
    """Network disparity (a tiny random float32 network) through the
    engine's ``infer_with_confidence``, gated: the JAX command's keys."""
    argv = ["slam", "--frames", "3", "--checkpoint", "none", "--config", tiny_config,
            "--confidence-gate", "0.5"]
    rc, got = port(*argv, "--device", "cpu")
    jrc, want = jax_cli(*argv)
    assert rc == jrc == 0
    assert set(want) <= set(got)
    assert (got["disparity_source"], got["confidence_gate"], got["frames"]) == (
        "network", 0.5, 3)
    with pytest.raises(SystemExit, match="confidence-gate needs network"):
        port("slam", "--gt-disparity", "--confidence-gate", "0.5", "--device", "cpu")
