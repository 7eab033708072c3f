"""Small collectives over the mesh's groups (the solvers', the train step's).

The JAX package reduces with ``psum`` inside ``shard_map``; here each is a
``torch.distributed`` call over the ``data`` group, staged through the host
under gloo (``halo.comm_device``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from .halo import comm_device


def data_group(mesh):
    """The ``data`` process group of this rank on ``mesh`` (a ``DeviceMesh``),
    or ``mesh`` itself when it is a process group (None: the default)."""
    return mesh.get_group("data") if hasattr(mesh, "get_group") else mesh


def all_sum(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each tensor summed over ``group`` (new tensors on the inputs' devices),
    in one all-reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    staged = flat.to(comm_device(flat, group), copy=True)
    dist.all_reduce(staged, group=group)
    staged = staged.to(flat.device)
    out, at = [], 0
    for t in tensors:
        out.append(staged[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in rank order."""
    staged = t.to(comm_device(t, group)).contiguous()
    parts = [torch.empty_like(staged) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, staged, group=group)
    return torch.cat(parts, dim).to(t.device)


def sum_in_rank_order(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group``: every rank's gathered and added in float64
    in rank order, so that every rank holds the same bits whatever the
    arrival order (float64, on ``t``'s device)."""
    from ..ops.kernels.group_norm import add_in_order

    return add_in_order(list(all_gather_cat(t[None], group)))
