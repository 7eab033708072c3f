"""The census against FlopCounterMode and the tensor sizes of the reference."""

import json
import re

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from stereobench import frames, harness
from stereobench.counts import classic, common, fast
from stereobench.reference import classic as ref_classic
from stereobench.reference import common as rc
from stereobench.reference import fast as ref_fast

CONFIGS = {"fast": "fast-stereonet-720p-bf16", "classic": "classic-stereonet-720p-bf16"}
NETS = {"fast": (fast, ref_fast), "classic": (classic, ref_classic)}
H, W = 64, 128


def _config(net):
    return json.loads((harness.HERE / "configs" / f"{CONFIGS[net]}.json").read_text())


def _run_reference(net, record_gn=None):
    cfg = _config(net)
    p = rc.Params(rc.load_npz(str(harness.ROOT / cfg["weights"])), "cpu")
    pool = frames.make_pool(1, 1, H, W, "cpu")
    left, right = rc.nv12_to_input(pool, H, W, cfg["preprocess"]["color_space"])
    with torch.no_grad():
        return NETS[net][1].forward(p, left, right, cfg["model"])


@pytest.mark.parametrize("net", ["fast", "classic"])
def test_conv_flops_match_flop_counter(net):
    cfg = _config(net)
    census = NETS[net][0].census(cfg["model"], H, W)
    with FlopCounterMode(display=False) as fc:
        _run_reference(net)
    assert census.conv_flops == fc.get_total_flops()


@pytest.mark.parametrize("net", ["fast", "classic"])
def test_group_norm_elements_match_tensor_sizes(net, monkeypatch):
    seen = []
    real = F.group_norm

    def spy(x, *a, **k):
        seen.append(x.numel())
        return real(x, *a, **k)

    monkeypatch.setattr(F, "group_norm", spy)
    _run_reference(net)
    census = NETS[net][0].census(_config(net)["model"], H, W)
    assert seen == [n for _, n, _ in census.group_norms]
    skips = sum(1 for _, _, s in census.group_norms if s)
    assert census.group_norm_bytes == census.act_bytes * (2 * sum(seen) + sum(
        n for _, n, s in census.group_norms if s))
    assert skips == sum(1 for name, _, _ in census.group_norms
                        if re.search(r"ResBlock2D_\d+/GroupNorm_0$", name))


@pytest.mark.parametrize("net,convs,norms", [("fast", 28, 25), ("classic", 53, 48)])
def test_720p_census_counts_the_published_layers(net, convs, norms):
    census = NETS[net][0].census(_config(net)["model"], 720, 1280)
    assert len(census.convs) == convs and len(census.group_norms) == norms
    gflop = {"fast": 36.92, "classic": 130.58}[net]
    assert census.conv_flops / 1e9 == pytest.approx(gflop, abs=0.01)


@pytest.mark.parametrize("space,out_bytes", [("yuv", 2), ("rgb", 4)])
def test_ingest_bytes_match_tensor_sizes(space, out_bytes):
    pool = frames.make_pool(1, 1, H, W, "cpu")
    left, right = rc.nv12_to_input(pool, H, W, space)
    expect = pool[0].numel() + (left.numel() + right.numel()) * out_bytes
    assert common.ingest_bytes(H, W, space) == expect
