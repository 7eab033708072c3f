"""Multi-process initialization: one process a card, as under ``torchrun``.

Counterpart of ``hobot_stereonet_tpu/parallel/distributed.py``: call
:func:`initialize` first in every process, then build the mesh
(:func:`global_mesh`, or ``mesh.make_mesh``).  The backend follows the
device, chosen explicitly: NCCL for a card, gloo for the CPU; a rank that
asks for a card where none is found raises, it never moves to the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig

INIT_TIMEOUT_S = 300.0


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, local_rank: Optional[int] = None,
               device: "str | torch.device | None" = None, backend: Optional[str] = None,
               timeout_s: float = INIT_TIMEOUT_S) -> dict:
    """Join (or, with one process and no address, skip, as the JAX package
    does) the process group.

    Arguments default from torchrun's variables: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, and ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``);
    ``init_method`` may also be ``tcp://host:port`` or ``file://path`` (a
    ``FileStore``).  Each rank binds ``cuda:LOCAL_RANK`` unless ``device``
    names the CPU; the backend is NCCL on a card, gloo on the CPU, unless
    ``backend="gloo"`` asks for gloo on cards (several ranks on one card,
    which NCCL refuses; tensors then travel through the host).  Returns
    the JAX package's summary keys (``multi_process``, ``process_index``,
    ``process_count``, ``local_devices``, ``global_devices``) and the
    ``device`` and ``backend``.
    """
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", 0))
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    dev = torch.device(f"cuda:{local_rank}" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: CUDA is not available; pass device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"initialize: unsupported device {dev}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    elif backend not in ("gloo", "nccl") or (backend == "nccl" and dev.type != "cuda"):
        raise ValueError(f"initialize: backend {backend!r} does not serve {dev}")
    multi = (world_size or 1) > 1 or init_method is not None
    if multi and not dist.is_initialized():
        kw = dict(device_id=dev) if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size if world_size is not None else 1,
                                rank=rank if rank is not None else 0,
                                timeout=datetime.timedelta(seconds=timeout_s), **kw)
    elif multi and str(dist.get_backend()).lower() != backend:
        raise RuntimeError(f"initialize: the process group runs {dist.get_backend()}, "
                           f"{dev} needs {backend}")
    joined = dist.is_initialized()
    return {
        "multi_process": multi,
        "process_index": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if joined else 1,
        "device": str(dev),
        "backend": backend if joined else None,
    }


def shutdown() -> None:
    """Leave the process group (if any)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(data: Optional[int] = None, tile: int = 1):
    """The (data, tile) mesh over every rank of the group; by default every
    rank lands on the data axis."""
    from .mesh import make_mesh, world_size

    n = world_size()
    if data is None:
        data = n // tile
    return make_mesh(MeshConfig(data=data, tile=tile))
