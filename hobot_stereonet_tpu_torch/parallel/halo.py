"""Halo exchange for row-tiled spatial computation.

Counterpart of ``hobot_stereonet_tpu/parallel/halo.py``.  When image rows
are split over the ``tile`` group, an op that reads across rows needs rows
held by other ranks.  The JAX package's ``exchange_row_halos`` is a pair of
``ppermute``s to the two neighbours inside ``shard_map``; here it is
point-to-point sends along the tile group (``batch_isend_irecv``): each
rank works out which of its rows every other rank needs and sends them in
one message, so a reach wider than a neighbour's rows takes rows from as
many ranks as it spans (as GSPMD does), and tiles of unequal heights work.
Rows beyond the image are zero (a "SAME" conv's padding) or the edge row
repeated.  With one rank in the group there is no exchange.
"""

from __future__ import annotations

import bisect
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def memory_format(t: torch.Tensor):
    """``t``'s memory format: channels-last (2-D or 3-D) where it is laid out
    so and not also plainly contiguous, else contiguous."""
    for dim, fmt in ((4, torch.channels_last), (5, torch.channels_last_3d)):
        if t.dim() == dim and t.is_contiguous(memory_format=fmt) and not t.is_contiguous():
            return fmt
    return torch.contiguous_format


def comm_device(t: torch.Tensor, group=None) -> torch.device:
    """Where ``t`` travels through ``group``'s backend: the host under gloo
    (staged there from a card), ``t``'s device under NCCL."""
    return torch.device("cpu") if _backend(group) == "gloo" else t.device


def exchange_rows(x: torch.Tensor, starts: Sequence[int], counts: Sequence[int], top, bottom,
                  dim: int, group=None, edge: str = "zero", index: Optional[int] = None,
                  peers: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``x`` (this rank's rows ``starts[i] .. starts[i] + counts[i]`` of an
    image split over ``group``, along ``dim``) extended by ``top`` rows above
    and ``bottom`` below (ints, or one each a rank, so that every rank knows
    what each asks for), from whichever ranks hold them; beyond the image
    zero (``edge="zero"``) or the edge row repeated (``"replicate"``).  Each
    pair of ranks exchanges one message each way at most, all in one
    ``batch_isend_irecv``.  The result keeps ``x``'s memory format."""
    if edge not in ("zero", "replicate"):
        raise ValueError(f"unknown edge {edge!r}")
    size = len(counts)
    me = dist.get_rank(group) if index is None else index
    if peers is None:
        peers = [dist.get_global_rank(group, t) if group is not None else t
                 for t in range(size)]
    tops = list(top) if isinstance(top, Sequence) else [top] * size
    bottoms = list(bottom) if isinstance(bottom, Sequence) else [bottom] * size
    if x.shape[dim] != counts[me]:
        raise ValueError(f"rank {me} holds {x.shape[dim]} rows, the layout says {counts[me]}")
    total = starts[-1] + counts[-1]

    def halo(t):                     # rank t's halo rows: (owner or None, row of the owner)
        a, b = starts[t], starts[t] + counts[t]
        out = []
        for g in list(range(a - tops[t], a)) + list(range(b, b + bottoms[t])):
            if edge == "replicate":
                g = min(max(g, 0), total - 1)
            elif g < 0 or g >= total:
                out.append((None, 0))
                continue
            owner = bisect.bisect_right(starts, g) - 1
            out.append((owner, g - starts[owner]))
        return out

    ops, recv, comm = [], {}, comm_device(x, group)
    for t in range(size):
        if t == me:
            continue
        mine = [r for owner, r in halo(t) if owner == me]
        if mine:
            idx = torch.tensor(mine, device=x.device)
            ops.append(dist.P2POp(dist.isend, x.index_select(dim, idx).to(comm).contiguous(),
                                  peers[t], group))
    halo_me = halo(me)
    for owner in sorted({o for o, _ in halo_me if o is not None and o != me}):
        shape = list(x.shape)
        shape[dim] = sum(1 for o, _ in halo_me if o == owner)
        recv[owner] = torch.empty(shape, dtype=x.dtype, device=comm)
        ops.append(dist.P2POp(dist.irecv, recv[owner], peers[owner], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    # One pool of rows: x's, each owner's message in rank order, a zero row.
    zshape = list(x.shape)
    zshape[dim] = 1
    pool = [x] + [recv[o].to(x.device) for o in sorted(recv)] + [x.new_zeros(zshape)]
    base, offset = {}, x.shape[dim]
    for o in sorted(recv):
        base[o], offset = offset, offset + recv[o].shape[dim]
    zero, taken, index_rows = offset, dict.fromkeys(recv, 0), []
    for owner, r in halo_me:
        if owner is None:
            index_rows.append(zero)
        elif owner == me:
            index_rows.append(r)
        else:
            index_rows.append(base[owner] + taken[owner])
            taken[owner] += 1
    n_top = tops[me]
    index_rows = index_rows[:n_top] + list(range(x.shape[dim])) + index_rows[n_top:]
    ext = torch.cat(pool, dim).index_select(dim, torch.tensor(index_rows, device=x.device))
    return ext.contiguous(memory_format=memory_format(x))


def _tile_group(mesh):
    return mesh.get_group("tile") if hasattr(mesh, "get_group") else mesh


def exchange_row_halos(x: torch.Tensor, halo: int, mesh=None, row_axis: int = 1,
                       edge: str = "zero") -> torch.Tensor:
    """This rank's row shard [B, H_local, ...] -> [B, H_local + 2 * halo, ...]
    with the neighbours' rows along ``row_axis`` (zeros at the image edge), as
    the JAX package's inside ``shard_map`` over ``tile``.  ``mesh``: a
    (data, tile) ``DeviceMesh`` or a tile process group (None: the default
    group).  The ranks' row counts are gathered first, so shards may differ
    in height, and ``halo`` may exceed a neighbour's rows."""
    group = _tile_group(mesh)
    size = dist.get_world_size(group)
    mine = torch.tensor([x.shape[row_axis]], dtype=torch.int64, device=comm_device(x, group))
    counts = [torch.zeros_like(mine) for _ in range(size)]
    dist.all_gather(counts, mine, group=group)
    counts = [int(c) for c in counts]
    starts = [sum(counts[:t]) for t in range(size)]
    return exchange_rows(x, starts, counts, halo, halo, row_axis, group, edge)


def halo_map(fn: Callable, mesh, halo: int, row_axis: int = 1):
    """``fn`` (local [B, H_local + 2 * halo, ...] -> the same rows) as a
    function of this rank's row shard: exchange the halos, apply ``fn``,
    crop the halo back off (the JAX package's ``halo_map``, in SPMD form:
    each rank calls the wrapper on its own shard)."""

    def local(x: torch.Tensor) -> torch.Tensor:
        out = fn(exchange_row_halos(x, halo, mesh, row_axis))
        return out.narrow(row_axis, halo, out.shape[row_axis] - 2 * halo)

    return local


def _backend(group) -> str:
    return str(dist.get_backend(group)).lower()
