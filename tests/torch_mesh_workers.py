"""Rank processes of the port's multi-process tests (gloo on the CPU).

Not a test module: ``tests/test_torch_parallel.py``,
``tests/test_torch_mesh_engine.py`` and ``tests/test_torch_distributed_slam.py``
call :func:`spawn`, which starts one process per rank running
:func:`main` on a scenario below.  Ranks meet through a ``FileStore`` in the
test's temporary directory (no port is fixed), run with one thread each,
and every process and the group's set-up has a timeout, so a hang fails in
seconds.  Each rank writes what it returns to ``<out>/<rank>.pt``.  This
module imports no JAX: the parent test computes the JAX references.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
INIT_TIMEOUT_S = 60.0

# The serving cases' geometry: 40 rows split at 1/8 into 5, so tile = 4
# gives 2 / 1 / 1 / 1 coarse rows (an uneven split) and tile = 2 gives 3 / 2.
H, W = 40, 64
# tests/test_model.py's SMALL (the JAX package's multi-device tests' network).
SMALL = dict(feature_channels=8, num_feature_res_blocks=1, num_aggregation_layers=1,
             aggregation_channels=8, num_refinement_res_blocks=1, refinement_channels=8,
             max_disparity=32)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def spawn(scenario: str, n: int, tmp: Path, timeout: float = 150.0, **kwargs) -> list:
    """Run ``scenario`` on ``n`` ranks; returns each rank's result."""
    out = Path(tmp) / f"{scenario}-{n}"
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            "from tests.torch_mesh_workers import main; main()")
    procs = [subprocess.Popen([sys.executable, "-c", code, scenario, str(r), str(n), str(store),
                               str(out), json.dumps(kwargs)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, failed
    return [torch.load(out / f"{r}.pt", weights_only=False) for r in range(n)]


def main() -> None:
    scenario, rank, n, store, out, kwargs = sys.argv[1:7]
    rank, n = int(rank), int(n)
    torch.set_num_threads(1)
    from hobot_stereonet_tpu_torch.parallel import distributed

    info = distributed.initialize(f"file://{store}", n, rank, device="cpu",
                                  timeout_s=INIT_TIMEOUT_S)
    try:
        result = SCENARIOS[scenario](rank, n, info, **json.loads(kwargs))
    finally:
        distributed.shutdown()
    torch.save(result, Path(out) / f"{rank}.pt")


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------


def allreduce(rank, n, info):
    """Each rank's row into one sum (tests/test_multiprocess.py's psum)."""
    import torch.distributed as dist

    from hobot_stereonet_tpu_torch.parallel import distributed

    mesh = distributed.global_mesh(tile=1)
    x = torch.full((1, 4), float(rank + 1))
    dist.all_reduce(x, group=mesh.get_group("data"))
    return {"info": info, "total": float(x.sum()), "mesh": tuple(mesh.shape)}


def collectives(rank, n, info):
    """The mesh, shards, replication and the halo exchange on 4 ranks."""
    from hobot_stereonet_tpu_torch.config import MeshConfig
    from hobot_stereonet_tpu_torch.parallel import halo, mesh as mesh_mod

    res = {"info": info}
    shapes = {}
    for d, t in ((2, 2), (4, 1), (1, 4)):
        m = mesh_mod.make_mesh(MeshConfig(d, t))
        shapes[(d, t)] = (tuple(m.shape), m.mesh_dim_names, mesh_mod.coordinate(m))
    res["shapes"] = shapes
    try:
        mesh_mod.make_mesh(MeshConfig(data=8, tile=1))
        res["too_big"] = None
    except ValueError as e:
        res["too_big"] = str(e)
    res["auto"] = mesh_mod.auto_mesh_config()
    m22 = mesh_mod.make_mesh(MeshConfig(2, 2))
    x = torch.arange(4 * 16 * 8 * 3, dtype=torch.float32).reshape(4, 16, 8, 3)
    res["shard"] = mesh_mod.shard_batch(m22, x)
    res["shard_rows8"] = mesh_mod.shard_batch(m22, x[:, :8], factor=4)   # 2 coarse rows
    net = torch.nn.Conv2d(3, 4, 3)
    torch.nn.init.constant_(net.weight, float(rank))
    mesh_mod.replicate(m22, net)
    res["replicated"] = net.weight.detach().clone()
    # The halo exchange on a 1 x 4 tile group: 16 rows, 4 a rank.
    m14 = mesh_mod.make_mesh(MeshConfig(1, 4))
    g = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1).repeat(1, 1, 4)
    local = g[:, 4 * rank:4 * rank + 4]
    res["halo1"] = halo.exchange_row_halos(local, 1, m14)
    res["halo6"] = halo.exchange_row_halos(local, 6, m14)                   # reach > 4 rows
    res["halo6_edge"] = halo.exchange_row_halos(local, 6, m14, edge="replicate")
    # Uneven shards: 3 / 1 / 1 / 2 rows of 7.
    counts = [3, 1, 1, 2]
    lo = sum(counts[:rank])
    res["uneven"] = halo.exchange_row_halos(
        torch.arange(7.0).reshape(1, 7, 1)[:, lo:lo + counts[rank]], 2, m14)
    stencil_in = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 8)))

    def stencil(p):
        up = torch.nn.functional.pad(p, (0, 0, 1, 0))[:, :-1]
        down = torch.nn.functional.pad(p, (0, 0, 0, 1))[:, 1:]
        return (up + p + down) / 3.0

    res["halo_map"] = halo.halo_map(stencil, m14, 1)(stencil_in[:, 8 * rank:8 * rank + 8])
    return res


def _frames(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, H * 2 * W * 3 // 2), dtype=np.uint8)


def small_config(model: str, dtype: str, data: int = 1, tile: int = 1, **engine):
    """The serving cases' ``Config`` (also the parent's single-rank engine's)."""
    from hobot_stereonet_tpu_torch import config as C

    eng = dict(max_batch=8, batch_buckets=(1, 2, 4, 8))
    eng.update(engine)
    return C.Config(camera=C.CameraConfig(width=W, height=H),
                    model=C.StereoNetConfig(compute_dtype=DTYPES[dtype], **SMALL),
                    preprocess=C.PreprocessConfig(color_space="yuv"),
                    engine=C.EngineConfig(**eng), mesh=C.MeshConfig(data, tile))


def small_calibration(model: str, dtype: str) -> dict:
    """A static int8 calibration of the small network (seeded weights) on
    the serving frames, the same on every rank and in the parent."""
    from hobot_stereonet_tpu_torch.ops import preprocess as pp
    from hobot_stereonet_tpu_torch.ops.quant import calibrate_activation_scales
    from hobot_stereonet_tpu_torch.runtime.engine import serving_network

    cfg = small_config(model, dtype)
    net = serving_network(model, None, cfg, torch.device("cpu"))
    x = pp.nv12_ingest(torch.from_numpy(_frames(4)), H, 2 * W, cfg.preprocess)
    return calibrate_activation_scales(net, [pp.split_model_input(x)])


def engine_kwargs(model: str, dtype: str, scheme: str) -> dict:
    kw = dict(device="cpu", emit_confidence=True, model=model)
    if scheme == "dynamic":
        kw["int8"] = True
    elif scheme == "static":
        kw["static_quant"] = small_calibration(model, dtype)
    return kw


def serving(rank, n, info, cases, frames=4, streams=()):
    """``StereoEngine`` on a mesh: for each case (model, dtype, scheme, data,
    tile, engine options) one synchronous dispatch of the serving frames
    (``pipeline`` on rank 0, ``serve`` elsewhere); for each of ``streams``
    the frames fed and polled through the workers.  Rank 0 returns the
    maps, the buckets and what raised."""
    from hobot_stereonet_tpu_torch.runtime.engine import Frame, StereoEngine

    out = {}
    batch = torch.from_numpy(_frames(frames))
    for case in cases + list(streams):
        model, dtype, scheme, data, tile, engine = case
        cfg = small_config(model, dtype, data, tile, **engine)
        try:
            eng = StereoEngine(cfg, **engine_kwargs(model, dtype, scheme))
        except ValueError as e:
            out[json.dumps(case)] = {"error": str(e)}
            continue
        if not eng.is_root:
            eng.serve()
            continue
        if case in streams:
            res = {}
            for i, f in enumerate(batch.numpy()):
                assert eng.feed(Frame(0.0, f, H, 2 * W, index=i))
            with eng:
                eng.drain(timeout=120.0)
                while (r := eng.poll(timeout=0.2)) is not None:
                    res[r.index] = np.asarray(r.disparity)
            got = {"stream": res, "batches": eng.metrics.dispatch_batch.summary()}
        else:
            disp, depth, conf, flags = eng.pipeline(batch)
            got = {"disparity": disp, "depth": depth, "confidence": conf, "flags": flags}
        eng.close()
        got["buckets"] = eng._buckets
        out[json.dumps(case)] = got
    return out if rank == 0 else None


def slam(rank, n, info, problems):
    """The distributed BA and pose graph on a ``data = n`` mesh."""
    from hobot_stereonet_tpu_torch.config import CameraConfig, MeshConfig
    from hobot_stereonet_tpu_torch.parallel.mesh import make_mesh
    from hobot_stereonet_tpu_torch.slam.ba import BAProblem, make_distributed_bundle_adjust
    from hobot_stereonet_tpu_torch.slam.pose_graph import PoseGraph, make_distributed_pose_graph

    data = torch.load(problems, weights_only=False)
    mesh = make_mesh(MeshConfig(data=n, tile=1))
    cam = CameraConfig(**data["camera"])
    out = {}
    ba = make_distributed_bundle_adjust(mesh, cam, iters=data["ba_iters"])
    out["ba"] = ba(BAProblem(**data["ba"]))._asdict()
    pg = make_distributed_pose_graph(mesh, iters=data["pg_iters"])
    out["pose_graph"] = pg(PoseGraph(**data["pose_graph"]))._asdict()
    try:
        ba(BAProblem(**{**data["ba"], "landmarks": data["ba"]["landmarks"][:-1],
                        "obs": data["ba"]["obs"][:, :-1], "valid": data["ba"]["valid"][:, :-1]}))
        out["ba_uneven"] = None
    except ValueError as e:
        out["ba_uneven"] = str(e)
    return out


SCENARIOS = {"allreduce": allreduce, "collectives": collectives, "serving": serving,
             "slam": slam}
