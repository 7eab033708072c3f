"""``bench-scaling``: a data-parallel forward at 1 and N ranks.

Counterpart of the JAX package's ``cmd_bench_scaling``
(``hobot_stereonet_tpu/cli.py``), which times a data-sharded forward on 1
and N virtual CPU devices.  Here each rank runs the float32 flagship
(seeded random weights, broadcast from rank 0) on its own batch of
``per_device_batch`` frames, ``iters`` times after one untimed call; N
ranks' frames/s is their frames over the slowest rank's wall time.

  * ``device="cpu"``: N gloo ranks are spawned on this host, one thread
    each (a ``FileStore`` in a temporary directory); rank 0 first runs alone
    (the others wait) for the single-rank figure;
  * on cards: the ranks it is launched with (``torchrun --nproc-per-node N``,
    NCCL, ``cuda:LOCAL_RANK`` each); rank 0 first runs alone for the
    single-rank figure.  More ranks than cards are refused; nothing moves
    to the CPU.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

CPU_NOTE = ("gloo ranks share one host's cores and memory, so this efficiency only shows that "
            "the data-parallel program runs; card scaling needs the NCCL run on cards")
CARD_NOTE = "ranks on the cards of one host over NCCL"


def _forward_fps(per_device_batch: int, height: int, width: int, iters: int,
                 device: torch.device, mesh=None) -> float:
    """Frames/s of this rank's timed forwards (all ranks' frames over the
    slowest rank's time on a mesh)."""
    import torch.distributed as dist

    from ..config import Config, StereoNetConfig
    from ..parallel.mesh import replicate
    from .engine import serving_network

    cfg = Config(model=StereoNetConfig(compute_dtype=torch.float32))
    net = serving_network("fast", None, cfg, device)
    if mesh is not None:
        replicate(mesh, net)
    rank = dist.get_rank() if mesh is not None else 0
    g = torch.Generator().manual_seed(rank)
    left, right = (torch.randn(per_device_batch, height, width, 3, generator=g).to(device)
                   for _ in range(2))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if mesh is not None:
            dist.barrier()

    with torch.inference_mode():
        net(left, right)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = net(left, right)["disparity"]
        out.sum().item()
        sync()
        wall = time.perf_counter() - t0
    ranks = 1
    if mesh is not None:
        ranks = dist.get_world_size()
        slowest = torch.tensor([wall], dtype=torch.float64)
        if str(dist.get_backend()).lower() == "nccl":
            slowest = slowest.to(device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        wall = float(slowest)
    return ranks * per_device_batch * iters / wall


def _single_then_all(args: tuple, dev: torch.device, n: int, rank: int):
    """(rank 0's frames/s alone, the n ranks' frames/s): rank 0 runs first
    while the others wait, then all run data-parallel."""
    import torch.distributed as dist

    from ..config import MeshConfig
    from ..parallel.mesh import make_mesh

    fps1 = _forward_fps(*args, device=dev) if rank == 0 else None
    if n == 1:
        return fps1, fps1
    dist.barrier()
    return fps1, _forward_fps(*args, device=dev, mesh=make_mesh(MeshConfig(data=n, tile=1)))


def _cpu_worker(rank: int, n: int, store: str, args: tuple, results) -> None:
    torch.set_num_threads(1)
    from ..parallel import distributed

    distributed.initialize(f"file://{store}", n, rank, device="cpu", timeout_s=300)
    try:
        fps = _single_then_all(args, torch.device("cpu"), n, rank)
        if rank == 0:
            results.put(fps)
    finally:
        distributed.shutdown()


def bench_scaling(devices: "int | None" = None, per_device_batch: int = 1, height: int = 128,
                  width: int = 256, iters: int = 5, device: "str | None" = None) -> dict:
    """The JSON line of ``bench-scaling`` (the JAX package's keys): frames/s
    at 1 and N ranks and their ratio over N.  ``devices``: N (None: 8 gloo
    ranks on the CPU, the launched ranks on cards).  On cards (``device``
    None or CUDA) every launched rank calls this; rank 0 returns the line,
    the others None."""
    args = (per_device_batch, height, width, iters)
    if device is not None and torch.device(device).type == "cpu":
        import torch.multiprocessing as mp

        devices = devices or 8
        results = mp.get_context("spawn").SimpleQueue()
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_cpu_worker, nprocs=devices, start_method="spawn", join=True,
                               args=(devices, os.path.join(tmp, "store"), args, results))
        fps1, fpsn = results.get()
        backend, note = "gloo (cpu)", CPU_NOTE
    else:
        from ..parallel import distributed

        n = int(os.environ.get("WORLD_SIZE", "1"))
        if not torch.cuda.is_available():
            raise RuntimeError("bench-scaling: CUDA is not available; pass --device cpu")
        if n > torch.cuda.device_count():
            raise ValueError(f"bench-scaling: {n} ranks but {torch.cuda.device_count()} cards")
        devices = devices or n
        if devices != n:
            raise ValueError(f"bench-scaling: --devices {devices}, but {n} ranks were launched "
                             "(torchrun --nproc-per-node sets them)")
        info = distributed.initialize()
        fps1, fpsn = _single_then_all(args, torch.device(info["device"]), n,
                                      info["process_index"])
        if info["process_index"] != 0:
            return None
        backend, note = ("nccl" if n > 1 else "cuda (one rank)"), CARD_NOTE
    return {
        "backend": backend,
        "fps_1dev": round(fps1, 2),
        f"fps_{devices}dev": round(fpsn, 2),
        "scaling_efficiency": round(fpsn / (fps1 * devices), 3),
        "note": note,
    }
