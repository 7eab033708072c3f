"""The port's compiled artifact (``.stereoblob``) against its live pipeline
and the JAX package's artifact, on the CPU.

Config: the flagship's widths at a 64x128 camera, float32 compute, YUV
input, the flagship's weights in both packages; buckets 1 and 4, platform
``cpu``.  An entry is the same program as the live pipeline, traced, so it
equals the port's engine bit for bit (float32 and int8 static); against
the JAX artifact it is held at 1e-3 px, the float32 network's bound
(tests/test_torch_engine.py).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobot_stereonet_tpu import config as jconfig
from hobot_stereonet_tpu.models import FastStereoNet as JFastStereoNet
from hobot_stereonet_tpu.runtime.artifact import (
    CompiledStereoArtifact as JArtifact, export_artifact as jexport_artifact)
from hobot_stereonet_tpu.runtime.checkpoint import load_params
from hobot_stereonet_tpu_torch import config as tconfig
from hobot_stereonet_tpu_torch.ops.kernels import int8_conv as k8
from hobot_stereonet_tpu_torch.reference import CALIB_JSON
from hobot_stereonet_tpu_torch.runtime.artifact import (
    ArtifactEngine, CompiledStereoArtifact, export_artifact)
from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine

torch.set_num_threads(1)

H, W = 64, 128
FRAME_LEN = H * (2 * W) * 3 // 2
BUCKETS = (1, 4)
DISP_ATOL = 1e-3


def _configs():
    jcfg = jconfig.Config(
        camera=jconfig.CameraConfig(width=W, height=H),
        model=jconfig.StereoNetConfig(compute_dtype=jnp.float32),
        preprocess=jconfig.PreprocessConfig(color_space="yuv"))
    tcfg = tconfig.Config(
        camera=tconfig.CameraConfig(width=W, height=H),
        model=tconfig.StereoNetConfig(compute_dtype=torch.float32),
        preprocess=tconfig.PreprocessConfig(color_space="yuv"),
        engine=tconfig.EngineConfig(max_batch=4, batch_buckets=BUCKETS))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, load_params("checkpoints/flagship/params"))


@pytest.fixture(scope="module")
def blob_path(params, tmp_path_factory):
    _, tcfg = _configs()
    path = str(tmp_path_factory.mktemp("art") / "model.stereoblob")
    manifest = export_artifact(path, "fast", params, tcfg, buckets=BUCKETS,
                               platforms=("cpu",))
    assert manifest["buckets"] == list(BUCKETS)
    return path


@pytest.fixture(scope="module")
def jax_blob_path(params, tmp_path_factory):
    jcfg, _ = _configs()
    path = str(tmp_path_factory.mktemp("jart") / "jax.stereoblob")
    jexport_artifact(path, JFastStereoNet(jcfg.model), params, jcfg, buckets=BUCKETS,
                     platforms=("cpu",))
    return path


@pytest.fixture(scope="module")
def art(blob_path):
    with CompiledStereoArtifact(blob_path, device="cpu") as loaded:
        yield loaded


@pytest.fixture(scope="module")
def engine(params):
    _, tcfg = _configs()
    return StereoEngine(tcfg, params=params, device="cpu")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).integers(0, 256, (3, FRAME_LEN), dtype=np.uint8)


def _live(engine, frames, bucket):
    """The engine's pipeline on the frames padded with zero frames."""
    pad = np.zeros((bucket - len(frames), FRAME_LEN), np.uint8)
    disp, depth = engine.pipeline(torch.from_numpy(np.concatenate([frames, pad])))[:2]
    return disp[:len(frames)].numpy(), depth[:len(frames)].numpy()


def test_manifest_is_inspectable(blob_path):
    with zipfile.ZipFile(blob_path) as z:
        names = set(z.namelist())
        m = json.loads(z.read("manifest.json"))
    assert {f"cpu/{k}_b{b}.pt2" for k in ("nv12", "rgb") for b in BUCKETS} <= names
    assert m["height"] == H and m["width"] == W and m["frame_len"] == FRAME_LEN
    assert m["platforms"] == ["cpu"] and m["torch_version"] == torch.__version__
    assert (m["model"], m["quant"], m["int8"]) == ("fast", "none", False)
    assert m["config"]["camera"]["height"] == H
    assert m["config"]["model"]["compute_dtype"] == "float32"


def test_nv12_entry_equals_live_pipeline_and_jax(art, jax_blob_path, engine, frames):
    """3 frames pad to bucket 4: bit-equal to the engine's pipeline on the
    same padded batch, within 1e-3 px of the JAX artifact."""
    disp, depth = art.run_nv12(frames)
    d1, z1 = art.run_nv12(frames[:1])
    assert disp.shape == depth.shape == (3, H, W)
    want_disp, want_depth = _live(engine, frames, 4)
    np.testing.assert_array_equal(disp, want_disp)
    np.testing.assert_array_equal(depth, want_depth)
    w1 = _live(engine, frames[:1], 1)
    np.testing.assert_array_equal(d1, w1[0])
    np.testing.assert_array_equal(z1, w1[1])
    with JArtifact(jax_blob_path) as jart:
        jdisp, jdepth = jart.run_nv12(frames)
    np.testing.assert_allclose(disp, jdisp, rtol=0, atol=DISP_ATOL)
    np.testing.assert_allclose(depth, jdepth, rtol=1e-4, atol=0)


def test_rgb_entry_equals_live_pipeline_and_jax(art, jax_blob_path, engine):
    rng = np.random.default_rng(3)
    left = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    right = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    single = art.infer(left[0], right[0])
    batch = art.infer(left, right)                          # pads 2 -> 4
    np.testing.assert_array_equal(single, engine.infer(left[0], right[0]))
    assert batch.shape == (2, H, W)
    with JArtifact(jax_blob_path) as jart:
        jbatch = jart.infer(left, right)
    np.testing.assert_allclose(batch, jbatch, rtol=0, atol=DISP_ATOL)


def test_oversize_batch_and_bad_geometry_refused(art, blob_path):
    with pytest.raises(ValueError, match="exceeds largest"):
        art.run_nv12(np.zeros((5, FRAME_LEN), np.uint8))
    from hobot_stereonet_tpu_torch.data.stream import Frame

    eng = ArtifactEngine(art)
    assert not eng.feed(Frame(0.0, np.zeros(100, np.uint8), H, 2 * W))
    assert eng.metrics.invalid == 1
    with pytest.raises(ValueError, match="not an exported bucket"):
        ArtifactEngine(blob_path, max_batch=16, device="cpu")


def test_artifact_engine_serves_stream(art):
    """The feed/poll loop micro-batches to the exported bucket and equals
    the synchronous run_nv12 of the same batch."""
    from hobot_stereonet_tpu_torch.data.stream import SyntheticStreamSource

    frames = list(SyntheticStreamSource(height=H, width=W, num_frames=4, paced=False))
    eng = ArtifactEngine(art)
    assert (eng.height, eng.width, eng.max_batch) == (H, W, 4)
    for f in frames:
        assert eng.feed(f)
    eng.start()
    eng.drain()
    results = sorted((eng.poll(timeout=1.0) for _ in range(4)), key=lambda r: r.index)
    eng.stop()
    assert [r.index for r in results] == [0, 1, 2, 3]
    assert eng.metrics.dispatch_batch.summary()["max"] == 4
    want_disp, want_depth = art.run_nv12(np.stack([np.asarray(f.sbs_nv12) for f in frames]))
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r.disparity, want_disp[i])
        np.testing.assert_array_equal(r.depth_m, want_depth[i])
        assert r.gt_disparity is not None


def test_artifact_engine_drain_raises_on_dead_worker(blob_path):
    from hobot_stereonet_tpu_torch.data.stream import Frame

    eng = ArtifactEngine(blob_path, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("injected artifact call failure")

    eng.artifact.call_nv12_async = boom
    assert eng.feed(Frame(0.0, np.zeros(FRAME_LEN, np.uint8), H, 2 * W))
    eng.start(warmup=False)
    try:
        with pytest.raises(RuntimeError, match="worker thread died"):
            eng.drain()
        with pytest.raises(RuntimeError, match="worker thread died"):
            list(eng.results(timeout=0.1))
    finally:
        eng.stop()


def test_fps_in_turns_serves_every_frame_of_each_engine_in_turns(art, params, frames):
    """Each round runs each engine once over the frames, in the given order
    on even rounds and reversed on odd ones; every frame comes back."""
    from hobot_stereonet_tpu_torch.runtime.benchmark import fps_in_turns

    _, tcfg = _configs()
    engines = {"artifact": ArtifactEngine(art, drop_on_full=False),
               "engine": StereoEngine(dataclasses.replace(tcfg, engine=dataclasses.replace(
                   tcfg.engine, drop_on_full=False)), params=params, device="cpu")}
    order = []
    for name, eng in engines.items():
        def start(warmup=True, real=eng.start, name=name):
            order.append(name)
            return real(warmup)
        eng.start = start
    runs = fps_in_turns(engines, frames, n_frames=5, rounds=3)
    assert order == ["artifact", "engine", "engine", "artifact", "artifact", "engine"]
    assert {k: len(v) for k, v in runs.items()} == {"artifact": 3, "engine": 3}
    assert all(x > 0 for v in runs.values() for x in v)
    assert sum(e.metrics.snapshot()["frames_out"] for e in engines.values()) == 30


def test_fps_in_turns_raises_on_a_lost_frame(blob_path, frames):
    from hobot_stereonet_tpu_torch.runtime.benchmark import fps_in_turns

    eng = ArtifactEngine(blob_path, drop_on_full=False, device="cpu")
    real = eng.artifact.call_nv12_async

    def poisoned(batch):
        disp, depth = real(batch)
        return torch.full_like(disp, float("nan")), depth

    eng.artifact.call_nv12_async = poisoned
    with pytest.raises(AssertionError, match="0 results of 2 frames"):
        fps_in_turns({"artifact": eng}, frames, n_frames=2, rounds=1)


def test_artifact_engine_nan_guard_drops_nonfinite_frames(blob_path, frames):
    eng = ArtifactEngine(blob_path, device="cpu")
    real = eng.artifact.call_nv12_async

    def poisoned(batch):
        disp, depth = real(batch)
        disp = disp.clone()
        disp[0, 0, 0] = float("nan")
        return disp, depth

    eng.artifact.call_nv12_async = poisoned
    from hobot_stereonet_tpu_torch.data.stream import Frame

    for i in range(2):
        assert eng.feed(Frame(0.0, frames[i], H, 2 * W, index=i))
    eng.start(warmup=False)
    eng.drain()
    got = [r.index for r in eng.results(timeout=0.2)]
    eng.stop()
    assert got == [1] and eng.metrics.nan_dropped == 1


def test_int8_static_artifact_equals_live_int8_pipeline(params, frames, tmp_path):
    _, tcfg = _configs()
    path = str(tmp_path / "int8.stereoblob")
    m = export_artifact(path, "fast", params, tcfg, buckets=(4,), platforms=("cpu",),
                        static_quant=str(CALIB_JSON))
    assert (m["quant"], m["int8"]) == ("static", True)
    eng = StereoEngine(tcfg, params=params, static_quant=str(CALIB_JSON), device="cpu")
    with CompiledStereoArtifact(path, device="cpu") as art:
        disp, depth = art.run_nv12(frames)
    want_disp, want_depth = _live(eng, frames, 4)
    np.testing.assert_array_equal(disp, want_disp)
    np.testing.assert_array_equal(depth, want_depth)


def _rewrite(src: str, dst: str, manifest_edit=None, rename=None) -> None:
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "manifest.json" and manifest_edit is not None:
                m = json.loads(data)
                manifest_edit(m)
                data = json.dumps(m).encode()
            zout.writestr(rename(name) if rename else name, data)


def test_missing_platform_other_torch_and_jax_blob_raise(blob_path, jax_blob_path, tmp_path):
    cuda_only = str(tmp_path / "cuda.stereoblob")
    _rewrite(blob_path, cuda_only, lambda m: m.update(platforms=["cuda"]),
             lambda n: n.replace("cpu/", "cuda/"))
    with pytest.raises(ValueError, match="no cpu entries"):
        CompiledStereoArtifact(cuda_only, device="cpu")
    other = str(tmp_path / "other.stereoblob")
    _rewrite(blob_path, other, lambda m: m.update(torch_version="2.11.0+cu128"))
    with pytest.raises(ValueError, match=r"torch 2\.11\.0\+cu128.*" + re.escape(torch.__version__)):
        CompiledStereoArtifact(other, device="cpu")
    with pytest.raises(ValueError, match="JAX artifact"):
        CompiledStereoArtifact(jax_blob_path, device="cpu")


LOAD_WITHOUT_MODELS = r"""
import sys, importlib.abc
class NoModels(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.startswith("hobot_stereonet_tpu_torch.models"):
            raise ImportError("model code is not available: " + name)
        return None
sys.meta_path.insert(0, NoModels())
import numpy as np
from hobot_stereonet_tpu_torch.runtime.artifact import CompiledStereoArtifact
frames = np.load(sys.argv[2])
with CompiledStereoArtifact(sys.argv[1], device="cpu") as art:
    disp, depth = art.run_nv12(frames)
np.save(sys.argv[3], disp)
assert not any(m.startswith("hobot_stereonet_tpu_torch.models") for m in sys.modules)
"""


def test_loader_needs_no_model_code(art, blob_path, frames, tmp_path):
    np.save(tmp_path / "frames.npy", frames)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_WITHOUT_MODELS, blob_path, str(tmp_path / "frames.npy"),
         str(tmp_path / "disp.npy")], capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want, _ = art.run_nv12(frames)
    np.testing.assert_array_equal(np.load(tmp_path / "disp.npy"), want)


def test_cli_export_infer_and_stream_artifact(tmp_path, capsys):
    from PIL import Image

    from hobot_stereonet_tpu_torch.cli import main as cli_main

    _, tcfg = _configs()
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(tcfg.to_dict()))
    blob = str(tmp_path / "cli.stereoblob")
    assert cli_main(["export", "--out", blob, "--config", str(cfg_path), "--checkpoint", "none",
                     "--buckets", "1", "--platforms", "cpu", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["buckets"] == [1] and out["platforms"] == ["cpu"]
    assert out["geometry"] == f"{W}x{H}" and out["bytes"] == os.path.getsize(blob)

    rng = np.random.default_rng(5)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(lp)
    Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(rp)
    assert cli_main(["infer", "--left", lp, "--right", rp, "--artifact", blob,
                     "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["shape"] == [H, W]

    bad = str(tmp_path / "bad.png")
    Image.fromarray(rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)).save(bad)
    with pytest.raises(SystemExit, match="artifact geometry"):
        cli_main(["infer", "--left", bad, "--right", bad, "--artifact", blob, "--device", "cpu"])

    assert cli_main(["stream", "--frames", "3", "--unpaced", "--artifact", blob,
                     "--device", "cpu"]) == 0
    snap = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert snap["frames_out"] == 3 and "epe_px" in snap


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s, dt=torch.float32):
        return torch.randn(*s, generator=g).to(dt)

    x = r(2, 8, 32, 32).contiguous(memory_format=torch.channels_last)
    q = torch.randint(-127, 128, (8, 8, 3, 3), dtype=torch.int8, generator=g)
    xc = r(2, 8, 16, 16).contiguous(memory_format=torch.channels_last)
    s = torch.tensor([0.05])
    sbs = torch.randint(0, 256, (2, 3 * 8 * 16), dtype=torch.uint8, generator=g)
    return {
        "nv12_yuv": (torch.ops.hst.nv12_sbs_preprocess, (sbs, 8, 16, False, False)),
        "nv12_rgb_quantize": (torch.ops.hst.nv12_sbs_preprocess, (sbs, 8, 16, True, True)),
        "correlation": (torch.ops.hst.correlation_volume,
                        (r(2, 4, 8, 16, dt=torch.bfloat16), r(2, 4, 8, 16, dt=torch.bfloat16), 5)),
        "soft_argmin": (torch.ops.hst.soft_argmin_confidence, (r(2, 4, 8, 24), 8.0)),
        "soft_argmin_cost": (torch.ops.hst.soft_argmin_cost,
                             (r(2, 6, 4, 8, dt=torch.bfloat16), 4.0)),
        "group_norm": (torch.ops.hst.group_norm_fused,
                       (x, r(8), r(8), None, None, 2, 1e-6, False, False)),
        "group_norm_fused": (torch.ops.hst.group_norm_fused,
                             (x, r(8), r(8), r(8), x.clone(), 2, 1e-6, True, True)),
        "int8_conv": (torch.ops.hst.int8_conv,
                      (xc, q, k8.pack_weight(q), r(8).abs(), r(8), s, 1 / s, 2, 1, False,
                       torch.bfloat16)),
        "int8_epilogue": (torch.ops.hst.int8_epilogue,
                          (torch.randint(-999, 999, (40, 16), dtype=torch.int32, generator=g),
                           32, 8, 16, torch.tensor([0.1, 0.2]), r(8).abs(), r(8),
                           torch.float32)),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_custom_op_passes_opcheck(case):
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor CUDA raises, as before the ops."""
    from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg

    x = torch.zeros((1, 4, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kg.group_norm(x, 2, torch.ones(4, device="meta"), torch.zeros(4, device="meta"), 1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        k8.int8_epilogue(torch.zeros((20, 8), dtype=torch.int32, device="meta"), 16, 8, 16,
                         torch.ones(1, device="meta"), torch.ones(8, device="meta"),
                         torch.zeros(8, device="meta"), torch.float32)
