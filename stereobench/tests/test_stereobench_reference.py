"""The plain reference against the program's CPU path, and its independence."""

import ast
import json

import pytest
import torch

from stereobench import frames, harness
from stereobench.reference import classic, common, fast

H, W = 64, 128
CASES = {"fast": ("fast-stereonet-720p-bf16", fast), "classic": ("classic-stereonet-720p-bf16",
                                                                  classic)}


def _program(cfg, net, dtype, pool):
    from hobot_stereonet_tpu_torch.config import Config
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine
    from hobot_stereonet_tpu_torch.runtime.weights import load_flax_npz

    model = dict(cfg["model"], compute_dtype=dtype)
    pcfg = Config.from_dict({"camera": dict(cfg["camera"], height=H, width=W), "model": model,
                             "preprocess": cfg["preprocess"]})
    eng = StereoEngine(pcfg, load_flax_npz(str(harness.ROOT / cfg["weights"])), model=net,
                       device="cpu", emit_confidence=True)
    return eng.pipeline(pool)


@pytest.mark.parametrize("net", ["fast", "classic"])
def test_reference_matches_the_programs_float32_cpu_path(net):
    name, mod = CASES[net]
    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    pool = frames.make_pool(3, 2, H, W, "cpu")
    disp, depth, conf, flags = _program(cfg, net, "float32", pool)
    p = common.Params(common.load_npz(str(harness.ROOT / cfg["weights"])), "cpu")
    left, right = common.nv12_to_input(pool, H, W, cfg["preprocess"]["color_space"])
    with torch.no_grad():
        ref = mod.forward(p, left, right, cfg["model"])
    assert (disp - ref["disparity"]).abs().max() < 1e-3
    assert (conf - ref["confidence"]).abs().max() < 1e-4
    cam = cfg["camera"]
    z = common.depth_m(ref["disparity"], cam["focal_px"], cam["baseline_mm"])
    assert torch.allclose(depth, z, rtol=1e-3)
    assert flags.sum() == 0


@pytest.mark.parametrize("space", ["yuv", "rgb"])
def test_reference_ingest_matches_the_programs_plain_ingest(space):
    from hobot_stereonet_tpu_torch.ops.kernels.preprocess_kernel import nv12_sbs_preprocess_plain

    pool = frames.make_pool(4, 3, H, W, "cpu")
    left, right = common.nv12_to_input(pool, H, W, space)
    prog = nv12_sbs_preprocess_plain(pool, H, W, rgb=space == "rgb").float()
    ref = torch.cat([left, right], 1).permute(0, 2, 3, 1)
    assert (prog - ref).abs().max() < 1e-5


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "zipfile", "contextlib",
                                           "__future__"), f"{path.name} imports {n}"


def test_frames_are_made_from_the_seed():
    a = frames.make_pool(2**31 + 5, 3, H, W, "cpu")
    b = frames.make_pool(2**31 + 5, 3, H, W, "cpu")
    c = frames.make_pool(2**31 + 6, 3, H, W, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (3, frames.frame_bytes(H, W)) and a.dtype == torch.uint8
    assert len({bytes(r.numpy()) for r in a}) == 3
