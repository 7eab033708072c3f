"""The (data, tile) device mesh and the placement of batches and weights.

Counterpart of ``hobot_stereonet_tpu/parallel/mesh.py``.  Scale-out runs
SPMD, one process a card (as under ``torchrun``), over a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data", "tile")``:

  * ``data`` shards the batch of stereo pairs: data rank d takes the d-th
    equal slice of every batch;
  * ``tile`` shards image rows: the ranks of a tile group take one frame's
    rows (``parallel/tiling.py``), exchanging halos (``parallel/halo.py``).

The mesh spans the first ``data * tile`` ranks of the default process group
(``parallel/distributed.py``), rank r at (r // tile, r % tile); its device
type follows the group's backend (NCCL: CUDA, gloo: the CPU).  Where the JAX
package places global arrays with ``NamedSharding``s, each rank here holds
its own shard: :func:`shard_batch` cuts it from a batch every rank holds,
:func:`replicate` broadcasts a module's weights from rank 0, and
:func:`gather_maps` brings per-pixel maps back to rank 0.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig
from .halo import comm_device
from .tiling import split_rows

DATA_AXIS = "data"
TILE_AXIS = "tile"


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def device_type() -> str:
    """The mesh's device type: ``cuda`` under NCCL, ``cpu`` under gloo."""
    return "cuda" if str(dist.get_backend()).lower() == "nccl" else "cpu"


def make_mesh(cfg: MeshConfig = MeshConfig()):
    """A (data, tile) ``DeviceMesh`` over the first ``cfg.num_devices`` ranks
    of the default process group.  Raises ``ValueError`` when the group holds
    fewer ranks (one process with no group holds one)."""
    from torch.distributed.device_mesh import DeviceMesh

    n, have = cfg.num_devices, world_size()
    if have < n:
        raise ValueError(f"mesh {cfg.data}x{cfg.tile} needs {n} devices, have {have}")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"mesh {cfg.data}x{cfg.tile} needs a process group: call "
                         "parallel.distributed.initialize first")
    grid = torch.arange(n).reshape(cfg.data, cfg.tile)
    return DeviceMesh(device_type(), grid, mesh_dim_names=(DATA_AXIS, TILE_AXIS))


def mesh_config(mesh) -> MeshConfig:
    return MeshConfig(data=mesh.size(0), tile=mesh.size(1))


def coordinate(mesh) -> "tuple[int, int]":
    """This rank's (data, tile) coordinate on ``mesh``."""
    return mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(TILE_AXIS)


def auto_mesh_config(n_devices: Optional[int] = None) -> MeshConfig:
    """Every rank on the data axis (perfectly efficient; tiles only where a
    batch cannot cover the cards), as the JAX package chooses."""
    return MeshConfig(data=world_size() if n_devices is None else n_devices, tile=1)


def local_slices(mesh, batch: int, height: Optional[int] = None, factor: int = 1):
    """(batch slice, row slice) of this rank: the data rank's equal slice of
    ``batch`` frames, and its tile's rows of ``height`` split at a resolution
    of 1/``factor`` (``tiling.split_rows``; all rows when ``height`` is None)."""
    cfg = mesh_config(mesh)
    d, t = coordinate(mesh)
    if batch % cfg.data:
        raise ValueError(f"a batch of {batch} does not split over data={cfg.data}")
    per = batch // cfg.data
    rows = slice(None)
    if height is not None:
        if height % factor:
            raise ValueError(f"{height} rows do not split at 1/{factor}")
        counts = [c * factor for c in split_rows(height // factor, cfg.tile)]
        rows = slice(sum(counts[:t]), sum(counts[:t + 1]))
    return slice(d * per, (d + 1) * per), rows


def shard_batch(mesh, x: torch.Tensor, tile_rows: bool = True, factor: int = 1
                ) -> torch.Tensor:
    """This rank's shard of a batch every rank holds: [B, H, W(, C)] -> its
    data slice of B and, with ``tile_rows``, its tile's rows (split at
    1/``factor``)."""
    b_sl, r_sl = local_slices(mesh, x.shape[0], x.shape[1] if tile_rows else None, factor)
    return x[b_sl, r_sl]


@torch.no_grad()
def replicate(mesh, tree):
    """Every tensor of ``tree`` (a module's parameters and buffers, a dict or
    list of tensors, or a tensor) overwritten in place with the mesh's first
    rank's, over the mesh's ranks (which may be fewer than the process
    group's), so that every rank serves or trains the same weights; returns
    ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.state_dict(keep_vars=True).values())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        tensors = list(tree)
    else:
        tensors = [tree]
    # from data rank 0 along each data group, then from tile rank 0 along
    # each tile group: every rank then holds the mesh's first rank's bits
    groups = [mesh.get_group(axis) for axis in (DATA_AXIS, TILE_AXIS)]
    for t in tensors:
        data = t.data if isinstance(t, torch.nn.Parameter) else t
        staged = data.to(comm_device(data))
        for g in groups:
            dist.broadcast(staged, src=dist.get_global_rank(g, 0), group=g)
        if staged is not data:
            data.copy_(staged)
    return tree


def gather_maps(mesh, local: torch.Tensor, counts: list, row_dim: int = 1
                ) -> Optional[torch.Tensor]:
    """Per-pixel maps back to rank 0: each rank's [b, rows, ...] shard ->
    on rank 0 the [b * data, H, ...] batch (data slices in order, each frame's
    tiles' rows in order), on ``local``'s device; None on the other ranks.
    ``counts``: each tile's rows.  Tiles of unequal heights are padded to
    the tallest for the gather and cropped after."""
    cfg = mesh_config(mesh)
    comm = comm_device(local)
    tallest = max(counts)
    pad = list(local.shape)
    pad[row_dim] = tallest - local.shape[row_dim]
    shard = torch.cat([local, local.new_zeros(pad)], row_dim) if pad[row_dim] else local
    shard = shard.to(comm).contiguous()
    root = mesh.mesh.flatten()[0].item()
    me = dist.get_rank()
    parts = [torch.empty_like(shard) for _ in range(cfg.num_devices)] if me == root else None
    dist.gather(shard, parts, dst=root)
    if me != root:
        return None
    frames = []
    for d in range(cfg.data):
        tiles = [parts[d * cfg.tile + t].narrow(row_dim, 0, counts[t])
                 for t in range(cfg.tile)]
        frames.append(torch.cat(tiles, row_dim))
    return torch.cat(frames, 0).to(local.device)
