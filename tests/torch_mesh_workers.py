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


# ---------------------------------------------------------------------------
# The sharded training step and what it differentiates through
# ---------------------------------------------------------------------------

# Row splits of the gradient cases, (height, tiles, 1/scale) as in
# tests/test_torch_parallel.py's conv_rows test, and the convs' (kernel,
# stride, dilation) there.
SPLITS = [(40, 4, 1), (40, 2, 2), (720, 4, 1), (64, 3, 4)]
CONVS = [(5, 2, 1), (3, 1, 1), (3, 1, 8), (3, 1, 4), (3, 2, 1)]
# The tiled GroupNorm's cases: (shape with the rows at dim -2, conv bias,
# skip, activation); 40 rows split 2 / 1 / 1 / 1 at 1/8 over 4 tiles, or 5.
GN_CASES = [((2, 16, 40, 6), True, True, True), ((2, 16, 40, 6), False, False, False),
            ((2, 16, 40, 6), True, False, True), ((2, 16, 3, 5, 4), True, False, True),
            ((2, 16, 3, 5, 4), False, True, False)]
# Every case's whole-image input and weights: float64 from this seed.
GRAD_SEED = 17


def tile_mesh(tiles: int):
    """A (1, tiles) mesh over the first ``tiles`` ranks (every rank calls)."""
    from hobot_stereonet_tpu_torch.config import MeshConfig
    from hobot_stereonet_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(MeshConfig(1, tiles))


def halo_case(height, tiles, scale, kernel, stride, dilation, edge):
    """(starts, counts, tops, bottoms) of a halo case: each rank's conv_rows
    plan of that conv at that split ("zero" edge), or one row each side
    with the edge repeated (the bilinear stencil)."""
    from hobot_stereonet_tpu_torch.parallel import tiling

    geo = [tiling.RowTiles(height, 8, None, index=t, size=tiles) for t in range(tiles)]
    starts, counts, _ = geo[0].layout(geo[0].coarse[0] * 8 // scale)
    if edge == "replicate":
        return starts, counts, [kernel] * tiles, [kernel] * tiles
    plans = [geo[t].conv_rows(counts[t], kernel, stride, dilation) for t in range(tiles)]
    return starts, counts, [p[0] for p in plans], [p[1] for p in plans]


def grad_inputs(key: str, shape, n_weights: int = 0, integer: bool = False):
    """A case's whole-image input and ``n_weights`` output weights (float64;
    small integers with ``integer``, so that every sum is exact)."""
    rng = np.random.default_rng([GRAD_SEED, sum(map(ord, key))])
    draw = (lambda s: rng.integers(-8, 9, s).astype(np.float64)) if integer else \
        (lambda s: rng.standard_normal(s))
    return [torch.from_numpy(draw(shape))] + [torch.from_numpy(draw(shape))
                                               for _ in range(n_weights)]


def halo_grads(rank, cases):
    """Each case's gradient of sum(exchange_rows(x) * w_rank) at this rank's
    rows: on the tile group of the case's first ``tiles`` ranks."""
    from hobot_stereonet_tpu_torch.parallel import halo

    out = {}
    for case in cases:
        height, tiles, scale, kernel, stride, dilation, edge = case
        mesh = tile_mesh(tiles)
        if rank >= tiles:
            continue
        starts, counts, tops, bottoms = halo_case(*case)
        x = grad_inputs(json.dumps(case), (2, starts[-1] + counts[-1], 3), integer=True)[0]
        local = x[:, starts[rank]:starts[rank] + counts[rank]].clone().requires_grad_()
        ext = halo.exchange_rows(local, starts, counts, tops, bottoms, 1,
                                 mesh.get_group("tile"), edge)
        wts = grad_inputs(json.dumps(case) + f"/{rank}", tuple(ext.shape), integer=True)[0]
        (ext * wts).sum().backward()
        out[json.dumps(case)] = local.grad
    return out


def conv_grads(rank, cases):
    """Each conv case's float64 gradients (input rows of this rank, weight,
    bias) of sum(conv(x) * w) on its tile group, the conv row-tiled."""
    from hobot_stereonet_tpu_torch.models.layers import SameConv2d, SameConv3d
    from hobot_stereonet_tpu_torch.parallel import tiling

    out = {}
    for case in cases:
        height, tiles, scale, kernel, stride, dilation, three_d = case
        mesh = tile_mesh(tiles)
        if rank >= tiles:
            continue
        tl = tiling.RowTiles(height, 8, mesh.get_group("tile"))
        rows = height // scale
        shape = (1, 2, 3, rows, 4) if three_d else (1, 2, rows, 6)
        x, = grad_inputs(json.dumps(case), shape)
        torch.manual_seed(GRAD_SEED)
        conv = (SameConv3d(2, 3, kernel) if three_d else
                SameConv2d(2, 3, kernel, stride, dilation)).double()
        starts, counts, _ = tl.layout(tl.coarse[rank] * 8 // scale)
        local = x.narrow(-2, starts[rank], counts[rank]).clone().requires_grad_()
        with tiling.row_tiles(tl):
            y = conv(local)
        _, ycounts, _ = tl.layout(y.shape[-2])
        wfull = grad_inputs(json.dumps(case) + "/w",
                            tuple(y.shape[:-2]) + (sum(ycounts), y.shape[-1]))[0]
        ystarts = [sum(ycounts[:t]) for t in range(tiles)]
        (y * wfull.narrow(-2, ystarts[rank], ycounts[rank])).sum().backward()
        out[json.dumps(case)] = {"x": local.grad, "weight": conv.weight.grad,
                                 "bias": conv.bias.grad}
    return out


def group_norm_grads(rank, cases):
    """Each GroupNorm case's float64 gradients (x, skip at this rank's rows;
    weight, bias, conv bias: this tile's sums) of sum(out * w) on 4 tiles."""
    from hobot_stereonet_tpu_torch.models.layers import GroupNorm
    from hobot_stereonet_tpu_torch.parallel import tiling

    mesh = tile_mesh(4)
    out = {}
    for case in cases:
        shape, with_bias, with_skip, activate = case
        key = json.dumps(case)
        x, skip, wts = grad_inputs(key, shape, 2)
        gn = GroupNorm(shape[1]).double()
        with torch.no_grad():
            gn.weight.copy_(1.0 + 0.5 * torch.linspace(-1, 1, shape[1], dtype=torch.float64))
            gn.bias.copy_(0.25 * torch.linspace(1, -1, shape[1], dtype=torch.float64))
        cb = torch.linspace(-0.5, 0.5, shape[1], dtype=torch.float64).requires_grad_()
        tl = tiling.RowTiles(40, 8, mesh.get_group("tile"))
        starts, counts, _ = tl.layout(tl.coarse[rank] * shape[-2] // 5)
        sl = lambda t: t.narrow(-2, starts[rank], counts[rank])       # noqa: E731
        lx, ls = sl(x).clone().requires_grad_(), sl(skip).clone().requires_grad_()
        with tiling.row_tiles(tl):
            y = gn(lx, conv_bias=cb if with_bias else None, skip=ls if with_skip else None,
                   activate=activate)
        (y * sl(wts)).sum().backward()
        out[key] = {"x": lx.grad, "skip": ls.grad, "weight": gn.weight.grad,
                    "bias": gn.bias.grad, "conv_bias": cb.grad}
    return out


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def state_digests(state) -> dict:
    """Hashes of the parameters' and the moments' bytes (rank equality)."""
    names = sorted(state.params)
    return {"params": _digest(state.params[k] for k in names),
            "mu": _digest(state.opt_state["mu"][k] for k in names),
            "nu": _digest(state.opt_state["nu"][k] for k in names)}


def flax_grads(params: dict) -> dict:
    """{flax path: numpy gradient} of a state's parameters."""
    from hobot_stereonet_tpu_torch.runtime.weights import _flatten, _unwrap, to_flax_params

    return {"/".join(k): v for k, v in _flatten(_unwrap(to_flax_params(
        {k: p.grad for k, p in params.items()})))}


def build_step(mesh, model: str, dtype, params_flax, cfg_kwargs=None, max_disparity=None,
               tile_rows=True):
    """(state, step, 2^K): ``make_sharded_train_step`` of ``model`` from
    ``params_flax`` (replicated over ``mesh``), the optimizer at its
    defaults (with ``cfg_kwargs``, the small networks: tests/test_training.py's)."""
    from hobot_stereonet_tpu_torch.config import StereoNetConfig
    from hobot_stereonet_tpu_torch.models import build_model
    from hobot_stereonet_tpu_torch.parallel.mesh import replicate
    from hobot_stereonet_tpu_torch.runtime import training
    from hobot_stereonet_tpu_torch.runtime.weights import from_flax_params

    cfg = StereoNetConfig(compute_dtype=dtype, **(cfg_kwargs or {}))
    net = build_model(model, cfg, "cpu")
    net.load_state_dict(from_flax_params(params_flax, cfg, model))
    opt = training.make_optimizer(**({} if cfg_kwargs is None else
                                     dict(lr=1e-3, warmup_steps=1, total_steps=100)))
    params = replicate(mesh, dict(net.named_parameters()))
    step = training.make_sharded_train_step(
        net, opt, mesh, cfg.max_disparity if max_disparity is None else max_disparity,
        tile_rows)
    return training.TrainState(params, opt.init(params), 0), step, cfg.cost_resolution_divisor


def sharded_steps(mesh, model: str, dtype, batch, params_flax, cfg_kwargs=None, steps=2,
                  max_disparity=None, tile_rows=True):
    """``steps`` sharded steps (:func:`build_step`) on this rank's shard of
    ``batch`` (left, right, gt: whole tensors): per step the metrics and the
    state's digests, and after the first the reduced gradients by flax path."""
    from hobot_stereonet_tpu_torch.parallel.mesh import shard_batch

    state, step, k = build_step(mesh, model, dtype, params_flax, cfg_kwargs, max_disparity,
                                tile_rows)
    shards = [shard_batch(mesh, t, tile_rows, factor=k) for t in batch]
    out = []
    for i in range(steps):
        state, m = step(state, *shards)
        rec = {"metrics": {n: float(v) for n, v in m.items()}, "digests": state_digests(state)}
        if i == 0:
            rec["grads"] = flax_grads(state.params)
        out.append(rec)
    return out


def refused(mesh, shards) -> "str | None":
    """What one sharded step of the small flagship on ``shards`` raises."""
    from hobot_stereonet_tpu_torch.runtime.weights import random_flax_params

    params = random_flax_params(small_config("fast", "float32").model, seed=0)
    state, step, _ = build_step(mesh, "fast", torch.float32, params, SMALL, 32.0)
    try:
        step(state, *shards)
    except ValueError as e:
        return str(e)
    return None


def stored_batch(model: str):
    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.runtime.train_loop import to_model_input

    st = reference.load_train_step(model)
    cs = str(st["color_space"])
    return (to_model_input(torch.from_numpy(st["left_u8"]), cs),
            to_model_input(torch.from_numpy(st["right_u8"]), cs),
            torch.from_numpy(st["disparity"]))


def small_batch(seed: int = 0):
    """tests/test_training.py's sharded case: 4 frames of 16x32, gt 4."""
    rng = np.random.default_rng(seed)
    b, h, w_ = 4, 16, 32
    return (torch.from_numpy(rng.standard_normal((b, h, w_, 3)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((b, h, w_, 3)).astype(np.float32)),
            torch.full((b, h, w_), 4.0))


def training(rank, n, info, halo=(), convs=(), group_norms=(), models=(), small=(),
             refusals=False):
    """The gradient cases, then for each of ``models`` two float32 sharded
    steps on the stored batch: a (2, 1) mesh on ranks 0-1 beside a (1, 2)
    mesh on ranks 2-3, then (2, 2) on all four; ``small``: the (2, 2) step of
    the small networks on tests/test_training.py's batch, with and without
    ``tile_rows``; ``refusals``: a
    tile count and a batch the mesh cannot split."""
    from torch.distributed.device_mesh import DeviceMesh

    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.config import MeshConfig
    from hobot_stereonet_tpu_torch.parallel.mesh import make_mesh
    from hobot_stereonet_tpu_torch.runtime.weights import random_flax_params

    res = {"halo": halo_grads(rank, [tuple(c) for c in halo]),
           "convs": conv_grads(rank, [tuple(c) for c in convs]),
           "group_norm": group_norm_grads(rank, [tuple(c) for c in group_norms])}
    pair = [DeviceMesh("cpu", torch.tensor([[0], [1]]), mesh_dim_names=("data", "tile")),
            DeviceMesh("cpu", torch.tensor([[2, 3]]), mesh_dim_names=("data", "tile"))]
    m22 = make_mesh(MeshConfig(2, 2))
    mine = pair[rank // 2]
    res["steps"] = {}
    for model in models:
        npz = reference.PARAMS_NPZ if model == "fast" else reference.CLASSIC_PARAMS_NPZ
        params, batch = reference.load_params(npz), stored_batch(model)
        res["steps"][(model, tuple(mine.shape))] = sharded_steps(mine, model, torch.float32,
                                                                 batch, params)
        res["steps"][(model, (2, 2))] = sharded_steps(m22, model, torch.float32, batch, params)
    res["small"] = {}
    for model in small:
        params = random_flax_params(small_config(model, "float32").model, seed=0, model=model)
        for tile_rows in (True, False):
            res["small"][model, tile_rows] = sharded_steps(
                m22, model, torch.float32, small_batch(), params, SMALL, steps=1,
                max_disparity=32.0, tile_rows=tile_rows)[0]["metrics"]
    if refusals:
        batch = small_batch()
        res["refused"] = {
            # 16 rows are 2 at 1/8, which 4 tiles cannot split (each rank given 4)
            "tiles": refused(make_mesh(MeshConfig(1, 4)),
                             [t[:, 4 * rank:4 * rank + 4] for t in batch]),
            # shards of 2, 1, 1 and 1 frames: a batch of 5 over data = 4
            "batch": refused(make_mesh(MeshConfig(4, 1)), [t[:2 if rank == 0 else 1]
                                                           for t in batch])}
    return res


SCENARIOS = {"allreduce": allreduce, "collectives": collectives, "serving": serving,
             "slam": slam, "training": training}
