#!/usr/bin/env python3
"""How often the GroupNorm kernel's exact scan falls back, on the networks'
real activations.

    python3 scripts/torch_group_norm_scan_rate.py [--classic-size 720x1280]

Runs the port's bf16 networks with their trained weights on the CPU (the
flagship on the two stored 256x512 held-out scenes, CLASSIC on a rendered
held-out scene at ``--classic-size``, 720p by default) and feeds every
GroupNorm input (the conv output plus its bias, bf16, as the kernel reads
it) to the numpy model of the kernel's algorithm
(``ops/kernels/group_norm.py``, ``scan_sums_model``, which mirrors
``csrc/group_norm.cu``).  Checks that the model's chains equal the
sequential float32 chains bit for bit, and counts, per million chain steps
(each position of each (sample, channel) counts twice: s1 and s2):

  * segments (32 runs of R positions) whose predicted spacing or map
    failed, which the kernel steps alone, and their steps.

Prints one JSON object a line per GroupNorm shape and one for each network.
Needs no card; the 720p CLASSIC forward and its 48 GroupNorms take minutes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hobot_stereonet_tpu_torch import reference  # noqa: E402
from hobot_stereonet_tpu_torch.config import Config, PreprocessConfig, StereoNetConfig  # noqa: E402
from hobot_stereonet_tpu_torch.data.loader import SyntheticStereoDataset  # noqa: E402
from hobot_stereonet_tpu_torch.models import build_model  # noqa: E402
from hobot_stereonet_tpu_torch.models.layers import GroupNorm, cast_convs  # noqa: E402
from hobot_stereonet_tpu_torch.ops import preprocess as pp  # noqa: E402
from hobot_stereonet_tpu_torch.ops.kernels import group_norm as kg  # noqa: E402
from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params  # noqa: E402

KEYS = ("chains", "positions", "segments", "steps")


def per_million(c: dict) -> dict:
    m = 1e6 / c["positions"]
    return dict(positions=c["positions"], segments_per_m=c["segments"] * m,
                steps_per_m=c["steps"] * m)


def census(name: str, net, left, right) -> dict:
    """Model every GroupNorm input of one forward; totals by shape."""
    by_shape: dict = {}

    def hook(mod, args, kwargs):
        x, cb = args[0], kwargs.get("conv_bias")
        a = x if cb is None else x + cb.to(x.dtype).view((1, -1) + (1,) * (x.dim() - 2))
        n, c = a.shape[:2]
        arr = a.movedim(1, -1).reshape(n, -1, c).float().numpy()
        s1, s2, counts = kg.scan_sums_model(arr, a.dtype == torch.bfloat16)
        w1 = np.cumsum(arr, axis=1, dtype=np.float32)[:, -1]
        w2 = np.cumsum(arr * arr, axis=1, dtype=np.float32)[:, -1]
        if not (np.array_equal(s1, w1) and np.array_equal(s2, w2)):
            raise AssertionError(f"{name}: the scan model differs from the chains at {a.shape}")
        key = f"{c}x{'x'.join(map(str, a.shape[2:]))}"
        tot = by_shape.setdefault(key, dict.fromkeys(KEYS, 0) | {"calls": 0, "samples": n})
        tot["calls"] += 1
        for k in KEYS:
            tot[k] += counts[k]

    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True) for m in net.modules()
             if isinstance(m, GroupNorm)]
    with torch.inference_mode():
        net(left, right)
    for h in hooks:
        h.remove()
    total = dict.fromkeys(KEYS, 0)
    for key, tot in sorted(by_shape.items()):
        print(json.dumps(dict(network=name, shape=key, calls=tot["calls"], samples=tot["samples"],
                              **per_million(tot))), flush=True)
        for k in KEYS:
            total[k] += tot[k]
    print(json.dumps(dict(network=name, shape="all", **per_million(total))), flush=True)
    return total


def trained(model: str, mcfg, params):
    net = build_model(model, mcfg, "cpu")
    net.load_state_dict(from_flax_params(params, mcfg, model))
    return cast_convs(net, torch.bfloat16).eval()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--classic-size", default="720x1280")
    args = ap.parse_args()
    torch.manual_seed(0)
    heldout = reference.heldout_dataset()
    cfg = Config.from_json(str(ROOT / "checkpoints" / "flagship" / "config.json"))
    mcfg = dataclasses.replace(cfg.model, compute_dtype=torch.bfloat16)
    x = torch.cat([pp.rgb_pair_to_model_input(heldout[i].left, heldout[i].right,
                                              PreprocessConfig(color_space="yuv"), "cpu")
                   for i in reference.SCENES])
    census("flagship, 2 held-out scenes at 256x512", trained("fast", mcfg, reference.load_params()),
           *pp.split_model_input(x))

    h, w = map(int, args.classic_size.split("x"))
    scene = SyntheticStereoDataset(size=1, seed=reference.HELDOUT["seed"], height=h, width=w)[0]
    x = pp.rgb_pair_to_model_input(scene.left, scene.right, PreprocessConfig(), "cpu")
    ccfg = StereoNetConfig(compute_dtype=torch.bfloat16)
    census(f"CLASSIC, a held-out scene at {h}x{w}",
           trained("classic", ccfg, reference.load_params(reference.CLASSIC_PARAMS_NPZ)),
           *pp.split_model_input(x))
    return 0


if __name__ == "__main__":
    sys.exit(main())
