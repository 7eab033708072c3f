#!/usr/bin/env python3
"""Two gloo ranks on one card: tile = 2 engines, the distributed BA, the sharded train step.

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
    within 1e-4, landmarks within 1e-2 (the JAX package's tolerances);
  * ``make_sharded_train_step`` of both networks from their committed
    weights on the stored training batch (``reference.train_step_batch``,
    4 crops of 128x256), float32 and bf16, on a (2, 1) and a (1, 2) mesh:
    two steps each; the first step's loss, gradient norm and gradients held
    to the stored JAX step (float32: ``reference.TRAIN_F32_*``, on the
    (1, 2) mesh each gradient within ``TRAIN_F32_TILE_GRAD_RTOL``; bf16:
    ``reference.bf16_grad_check`` and ``BF16_LOSS_FACTOR``), the ranks'
    parameters, moments and metrics bit-equal after each step; rank 0
    counts the kernels' launches in each step (by name, with the tile's
    shape) and its GroupNorm calls by input shape.

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


def digest(state) -> str:
    """A hash of a train state's parameters, moments and step count."""
    import hashlib

    h = hashlib.sha256(str(state.opt_state["count"]).encode())
    for k in sorted(state.params):
        for t in (state.params[k], state.opt_state["mu"][k], state.opt_state["nu"][k]):
            h.update(t.detach().cpu().contiguous().view(-1).numpy().tobytes())
    return h.hexdigest()


def step_check(model: str, dtype, params: dict, metrics: dict, tiled: bool) -> tuple:
    """(ok, summary) of a sharded step's first update against the stored JAX
    step (``params``' gradients are the step's reduced ones); float32 on a
    row-tiled mesh (``tiled``): each gradient within
    ``reference.TRAIN_F32_TILE_GRAD_RTOL``, all together within
    ``TRAIN_F32_GRAD_RTOL`` (the reason is there)."""
    import torch

    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.runtime.weights import _flatten, _unwrap, to_flax_params

    stored = reference.load_train_step(model)
    flat = {"/".join(k): v for k, v in _flatten(_unwrap(to_flax_params(
        {k: p.grad for k, p in params.items()})))}
    loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
    if dtype == torch.float32:
        want = stored["f32"]
        errs = reference.grad_mismatches(flat, want["grads"], 0.0)
        worst = max(errs, key=lambda e: e[1]) if errs else ("", 0.0)
        together = reference.grad_distance(flat, want["grads"])
        per_tensor = reference.TRAIN_F32_TILE_GRAD_RTOL if tiled else \
            reference.TRAIN_F32_GRAD_RTOL
        ok = (abs(loss - want["loss"]) <= reference.TRAIN_F32_RTOL * abs(want["loss"])
              and abs(norm - want["grad_norm"]) <= reference.TRAIN_F32_NORM_RTOL[model]
              * want["grad_norm"] and worst[1] <= per_tensor
              and together <= reference.TRAIN_F32_GRAD_RTOL)
        return ok, {"loss": loss, "jax_loss": want["loss"], "grad_norm": norm,
                    "jax_grad_norm": want["grad_norm"], "worst_grad": worst[0],
                    "worst_rel_l2": worst[1], "limit": per_tensor, "all_rel_l2": together,
                    "beyond_1e-3": sum(e[1] > reference.TRAIN_F32_GRAD_RTOL for e in errs)}
    f32, b16 = stored["f32"], stored["bf16"]
    res = reference.bf16_grad_check(flat, b16["grads"], f32["grads"])
    ok = res["ok"] and abs(loss - f32["loss"]) <= reference.BF16_LOSS_FACTOR * abs(
        b16["loss"] - f32["loss"])
    return ok, {"loss": loss, "jax_bf16_loss": b16["loss"], "jax_f32_loss": f32["loss"],
                "grad_norm": norm, "ratio": res["ratio"], "share": res["share"],
                "worst": list(res["worst"])}


def sharded_training(dev, rank: int) -> dict:
    """Two sharded steps of each network, precision and mesh (module
    docstring); returns rank 0's summary, launches and GroupNorm calls."""
    from collections import Counter

    import torch
    import torch.distributed as dist

    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.config import MeshConfig, StereoNetConfig
    from hobot_stereonet_tpu_torch.models import build_model
    from hobot_stereonet_tpu_torch.models.layers import GroupNorm
    from hobot_stereonet_tpu_torch.ops.kernels import build
    from hobot_stereonet_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from hobot_stereonet_tpu_torch.runtime import training
    from hobot_stereonet_tpu_torch.runtime.train_loop import to_model_input
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params

    out = {"runs": {}, "launches": Counter(), "by_shape": Counter(),
           "group_norm_by_shape": Counter()}
    meshes = {shape: make_mesh(MeshConfig(*shape)) for shape in ((2, 1), (1, 2))}
    for model, npz in (("fast", reference.PARAMS_NPZ), ("classic", reference.CLASSIC_PARAMS_NPZ)):
        stored = reference.load_train_step(model)
        cs = str(stored["color_space"])
        batch = [to_model_input(torch.from_numpy(stored[k]).to(dev), cs)
                 for k in ("left_u8", "right_u8")] + [torch.from_numpy(stored["disparity"]).to(dev)]
        flax = reference.load_params(npz)
        for dtype in (torch.float32, torch.bfloat16):
            for shape, mesh in meshes.items():
                cfg = StereoNetConfig(compute_dtype=dtype)
                net = build_model(model, cfg, dev)
                net.load_state_dict(from_flax_params(flax, cfg, model))
                opt = training.make_optimizer()
                params = replicate(mesh, dict(net.named_parameters()))
                state = training.TrainState(params, opt.init(params), 0)
                step = training.make_sharded_train_step(net, opt, mesh, cfg.max_disparity)
                k = cfg.cost_resolution_divisor
                shards = [shard_batch(mesh, t, factor=k) for t in batch]
                tile = (shards[0].shape[0], shards[0].shape[1] // k, shards[0].shape[2] // k)
                calls = Counter()
                hooks = [m.register_forward_pre_hook(
                    lambda mod, a: calls.update([shape_key(a[0])]))
                    for m in net.modules() if isinstance(m, GroupNorm)]
                name = f"{model} {str(dtype).removeprefix('torch.')} mesh {shape}"
                rec = {}
                for i in range(2):
                    torch.cuda.synchronize()
                    build.reset_launch_counts()
                    t = time.monotonic()
                    state, m = step(state, *shards)
                    torch.cuda.synchronize()
                    rec[f"step{i + 1}_s"] = time.monotonic() - t
                    if i == 0:
                        launches, gn = dict(build.launch_counts), sum(calls.values())
                        out["launches"].update(launches)
                        out["by_shape"].update({f"{n} {list(tile)}": c
                                                for n, c in launches.items()})
                        if shape[1] > 1:          # the split entries' calls
                            out["group_norm_by_shape"].update(calls)
                        ok, rec["vs_jax"] = step_check(model, dtype, params, m, shape[1] > 1)
                        if not ok:
                            raise AssertionError(f"{name}: the first step against the stored "
                                                 f"JAX step: {rec['vs_jax']}")
                        rec["launches"] = launches
                    mine = [digest(state), [float(v) for v in m.values()]]
                    every = [None, None]
                    dist.all_gather_object(every, mine)
                    if every[0] != every[1]:
                        raise AssertionError(f"{name}, step {i + 1}: the ranks' states or "
                                             f"metrics differ: {every}")
                    rec[f"step{i + 1}_metrics"] = mine[1]
                for hk in hooks:
                    hk.remove()
                want = ("group_norm_stats", "group_norm_apply") if shape[1] > 1 else \
                    ("group_norm",)
                want += ("correlation", "correlation_bwd", "soft_argmin", "soft_argmin_bwd") \
                    if model == "fast" else ("soft_argmin_cost", "soft_argmin_cost_bwd")
                if any(rec["launches"].get(n, 0) <= 0 for n in want) or any(
                        rec["launches"].get(n, 0) != gn for n in want if "group_norm" in n):
                    raise AssertionError(f"{name}: launches {rec['launches']}, GroupNorm calls "
                                         f"{gn}")
                out["runs"][name] = rec
                if rank == 0:
                    print(json.dumps({name: rec}), flush=True)
                del net, state, step, params
    return {k: dict(v) if isinstance(v, Counter) else v for k, v in out.items()}


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
    t = time.monotonic()
    out["train"] = sharded_training(dev, args.rank)
    out["train_s"] = time.monotonic() - t
    distributed.shutdown()
    out["seconds"] = time.monotonic() - t0
    if args.rank == 0:
        Path(args.out).write_text(json.dumps(out))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
