#!/usr/bin/env python3
"""Two ranks on one card through gloo: tile = 2 engines of both networks and the distributed BA.

    python3 scripts/torch_two_ranks_one_card.py --rank R --world 2 --store DIR --out OUT.json
        [--frames 8]

Run once per rank (``chip_smoke.py`` starts both).  NCCL refuses two ranks
on one device, so the ranks form a gloo group on cuda:0 (``initialize(...,
backend="gloo")``; tensors travel through the host) over a ``FileStore`` in
``--store``.  Then:

  * a (1, 2) mesh ``StereoEngine`` of each network in bf16 at 720p (the
    flagship's config and committed weights, then CLASSIC's default config
    and committed weights) serves the stored 720p scene
    (``reference.frame_720p``) ``--frames`` times in one dispatch, rank 0
    dispatching while rank 1 serves; each rank holds half the rows, so each
    GroupNorm runs ``group_norm_stats`` and ``group_norm_apply`` (the
    kernels' launches are counted from just before to just after each
    dispatch, and rank 0 counts its GroupNorm calls by input shape: the
    tile's rows); rank 0 holds each result to the one-card engine's on the
    same frames within the CPU tests' bf16 bounds (median 0.03 px, 0.05 %
    over 1 px, max 8 px);
  * ``make_distributed_bundle_adjust`` on a (2, 1) mesh against
    ``bundle_adjust`` on a synthetic problem (4 poses, 64 landmarks): poses
    within 1e-4, landmarks within 1e-2 (the JAX package's tolerances).

Rank 0 writes one JSON object to ``--out``; a failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BF16_BOUNDS = (0.03, 0.0005, 8.0)


def ba_problem(device):
    """4 poses and 64 landmarks seen from them (``tests/test_ba.py``'s
    construction, in the port's geometry)."""
    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch.config import CameraConfig
    from hobot_stereonet_tpu_torch.slam import se3
    from hobot_stereonet_tpu_torch.slam.ba import BAProblem
    from hobot_stereonet_tpu_torch.slam.odometry import project

    cam = CameraConfig(width=640, height=480, focal_px=500.0, baseline_mm=120.0)
    rng = np.random.default_rng(1234)
    lm = np.stack([rng.uniform(-4, 4, 64), rng.uniform(-3, 3, 64), rng.uniform(6, 20, 64)],
                  -1).astype(np.float32)
    xi = np.zeros((4, 6), np.float32)
    for i in range(1, 4):
        xi[i] = xi[i - 1] + np.r_[rng.uniform(-0.15, 0.15, 3),
                                  rng.uniform(-0.04, 0.04, 3)].astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)   # noqa: E731
    R_gt, t_gt = se3.exp_se3(t(xi))
    pc = torch.einsum("nij,mj->nmi", R_gt, t(lm)) + t_gt[:, None, :]
    obs = project(pc, cam)[0]
    valid = ((obs[..., 0] > 0) & (obs[..., 0] < cam.width) & (obs[..., 1] > 0)
             & (obs[..., 1] < cam.height) & (pc[..., 2] > 0.1))
    xi0 = xi.copy()
    xi0[1:] += rng.normal(0, 0.02, (3, 6)).astype(np.float32)
    lm0 = lm + rng.normal(0, 0.05, lm.shape).astype(np.float32)
    return BAProblem(poses=se3.exp_se3(t(xi0)), landmarks=t(lm0), obs=obs, valid=valid), cam


def shape_key(x) -> str:
    """A GroupNorm input's shape as ``chip_smoke.py``'s kernel rows write it."""
    return f"[{x.shape[0]}, {x.shape[1]}, {'x'.join(map(str, x.shape[2:]))}]"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--store", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=8)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from collections import Counter

    import numpy as np
    import torch

    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.config import Config, MeshConfig
    from hobot_stereonet_tpu_torch.models.layers import GroupNorm
    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.parallel import distributed
    from hobot_stereonet_tpu_torch.parallel.mesh import make_mesh
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine
    from hobot_stereonet_tpu_torch.slam.ba import bundle_adjust, make_distributed_bundle_adjust

    t0 = time.monotonic()
    info = distributed.initialize(f"file://{Path(args.store) / 'store'}", args.world, args.rank,
                                  device="cuda:0", backend="gloo", timeout_s=300)
    dev = torch.device("cuda:0")
    out = {"info": info, "dispatch_s": {}, "tile2_vs_one_card": {}}
    frames = torch.from_numpy(np.stack([reference.frame_720p()] * args.frames)).to(dev)
    networks = {"fast": (Config.from_json(str(ROOT / "checkpoints" / "flagship" / "config.json")),
                         reference.PARAMS_NPZ),
                "classic": (Config(), reference.CLASSIC_PARAMS_NPZ)}
    mesh = make_mesh(MeshConfig(1, args.world))
    launches, by_shape = Counter(), Counter()
    for model, (cfg, npz) in networks.items():
        params = reference.load_params(npz)
        eng = StereoEngine(cfg, params=params, mesh=mesh, device=dev, emit_confidence=True,
                           model=model)
        count = lambda mod, a: by_shape.update([shape_key(a[0])])   # noqa: E731
        hooks = [m.register_forward_pre_hook(count) for m in eng.model.modules()
                 if isinstance(m, GroupNorm)]
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t = time.monotonic()
        if eng.is_root:
            disp, _, conf, flags = eng.pipeline(frames)
            eng.close()
        else:
            eng.serve()
        torch.cuda.synchronize()
        out["dispatch_s"][model] = time.monotonic() - t
        launches.update(build.launch_counts)
        for hk in hooks:
            hk.remove()
        if not eng.is_root:
            continue
        single = StereoEngine(cfg, params=params, device=dev, emit_confidence=True, model=model)
        with torch.inference_mode():
            want = single.pipeline(frames)
        err = (disp - want[0]).abs()
        stats = (float(err.median()), float((err > 1.0).float().mean()), float(err.max()))
        out["tile2_vs_one_card"][model] = {
            "median_px": stats[0], "over_1px": stats[1], "max_px": stats[2],
            "bit_equal": float((err == 0).float().mean()),
            "confidence_max": float((conf - want[2]).abs().max()), "flags": flags.tolist()}
        if not all(s <= b for s, b in zip(stats, BF16_BOUNDS)) or flags.any():
            raise AssertionError(f"{model}, tile = 2 against one card: {stats} (bounds "
                                 f"{BF16_BOUNDS})")
        del single, want
    out["launches"] = dict(launches)
    out["group_norm_by_shape"] = dict(by_shape)
    calls = sum(by_shape.values())
    if (launches["group_norm_stats"] != calls or launches["group_norm_apply"] != calls
            or launches["group_norm"]):
        raise AssertionError(f"rank {args.rank}: the tiled GroupNorm's launches {dict(launches)}, "
                             f"its calls by shape {dict(by_shape)}")
    # The distributed BA on a (2, 1) mesh.
    problem, cam = ba_problem(dev)
    t = time.monotonic()
    got = make_distributed_bundle_adjust(make_mesh(MeshConfig(args.world, 1)), cam,
                                         iters=8)(problem)
    out["ba_s"] = time.monotonic() - t
    want = bundle_adjust(problem, cam, iters=8)
    out["ba"] = {"pose_err": max(float((got.R - want.R).abs().max()),
                                 float((got.t - want.t).abs().max())),
                 "landmark_err": float(((got.landmarks - want.landmarks).abs()
                                        / (want.landmarks.abs() + 1)).max()),
                 "cost_first_last": [float(got.cost_history[0]), float(got.cost_history[-1])]}
    if out["ba"]["pose_err"] > 1e-4 or out["ba"]["landmark_err"] > 1e-2:
        raise AssertionError(f"distributed BA against one rank: {out['ba']}")
    distributed.shutdown()
    out["seconds"] = time.monotonic() - t0
    if args.rank == 0:
        Path(args.out).write_text(json.dumps(out))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
