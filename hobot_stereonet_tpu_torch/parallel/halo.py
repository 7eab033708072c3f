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
repeated.  With one rank in the group there is no exchange.  The exchange
is differentiable: its backward sends each halo row's gradient back to the
rank that owns the row (the sharded train step's backward through every
layer that reads across rows).
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
    ``batch_isend_irecv``.  The result keeps ``x``'s memory format.

    Differentiable: the backward runs the exchange in reverse (one
    ``batch_isend_irecv``).  This rank keeps the gradient of its own rows;
    each halo row's gradient goes back to the rank that owns the row, which
    adds the rows it receives, in sender-rank order, at the rows it sent (a
    row that ``"replicate"`` repeated adds once for each time); the
    gradient of a row beyond the image (``"zero"``) is dropped.  Every rank
    of the group must run the backward, in the same order as the forwards."""
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
    plan = _Plan(starts, counts, tops, bottoms, edge, me, list(peers), group, dim)
    if torch.is_grad_enabled() and x.requires_grad:
        return _ExchangeRows.apply(x, plan)
    return plan.forward(x)


class _Plan:
    """Who sends which rows to whom in one exchange (every rank's halo is
    known to every rank from the layout)."""

    def __init__(self, starts, counts, tops, bottoms, edge, me, peers, group, dim):
        self.me, self.peers, self.group, self.dim = me, peers, group, dim
        self.n_top, self.local = tops[me], counts[me]
        total = starts[-1] + counts[-1]

        def halo(t):                 # rank t's halo rows: (owner or None, row of the owner)
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

        # this rank's rows each other rank takes, in the order it takes them
        self.send = {}
        for t in range(len(counts)):
            mine = [r for owner, r in halo(t) if owner == me] if t != me else []
            if mine:
                self.send[t] = mine
        self.halo = halo(me)
        # rows of this rank's halo (positions in the extended tensor) by owner
        pos = list(range(self.n_top)) + [self.n_top + self.local + j
                                         for j in range(len(self.halo) - self.n_top)]
        self.pos = {}
        for p, (owner, r) in zip(pos, self.halo):
            if owner is not None:
                self.pos.setdefault(owner, []).append((p, r))

    def _exchange(self, outgoing: dict, incoming: dict, like: torch.Tensor) -> dict:
        """One ``batch_isend_irecv``: ``outgoing`` {rank: tensor} sent,
        ``incoming`` {rank: rows} received as tensors shaped like ``like``
        with that many rows along ``dim``; returns {rank: received}."""
        comm = comm_device(like, self.group)
        ops, recv = [], {}
        for t, msg in outgoing.items():
            ops.append(dist.P2POp(dist.isend, msg.to(comm).contiguous(), self.peers[t],
                                  self.group))
        for t, rows in sorted(incoming.items()):
            shape = list(like.shape)
            shape[self.dim] = rows
            recv[t] = torch.empty(shape, dtype=like.dtype, device=comm)
            ops.append(dist.P2POp(dist.irecv, recv[t], self.peers[t], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return {t: m.to(like.device) for t, m in recv.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dim = self.dim
        out = {t: x.index_select(dim, torch.tensor(rows, device=x.device))
               for t, rows in self.send.items()}
        recv = self._exchange(out, {o: len(v) for o, v in self.pos.items() if o != self.me}, x)
        # One pool of rows: x's, each owner's message in rank order, a zero row.
        zshape = list(x.shape)
        zshape[dim] = 1
        pool = [x] + [recv[o] for o in sorted(recv)] + [x.new_zeros(zshape)]
        base, offset = {}, x.shape[dim]
        for o in sorted(recv):
            base[o], offset = offset, offset + recv[o].shape[dim]
        zero, taken, index_rows = offset, dict.fromkeys(recv, 0), []
        for owner, r in self.halo:
            if owner is None:
                index_rows.append(zero)
            elif owner == self.me:
                index_rows.append(r)
            else:
                index_rows.append(base[owner] + taken[owner])
                taken[owner] += 1
        index_rows = (index_rows[:self.n_top] + list(range(x.shape[dim]))
                      + index_rows[self.n_top:])
        ext = torch.cat(pool, dim).index_select(dim, torch.tensor(index_rows, device=x.device))
        return ext.contiguous(memory_format=memory_format(x))

    def backward(self, g: torch.Tensor, fmt) -> torch.Tensor:
        dim = self.dim
        out = {o: g.index_select(dim, torch.tensor([p for p, _ in v], device=g.device))
               for o, v in sorted(self.pos.items()) if o != self.me}
        recv = self._exchange(out, {t: len(rows) for t, rows in self.send.items()}, g)
        grad = g.narrow(dim, self.n_top, self.local).clone(memory_format=fmt)
        own = self.pos.get(self.me)    # this rank's edge rows that "replicate" repeated
        if own:
            recv[self.me] = g.index_select(dim, torch.tensor([p for p, _ in own],
                                                             device=g.device))
        for t in sorted(recv):
            _add_rows(grad, dim, [r for _, r in own] if t == self.me else self.send[t], recv[t])
        return grad


def _add_rows(acc: torch.Tensor, dim: int, rows: Sequence[int], src: torch.Tensor) -> None:
    """``acc``'s row ``rows[j]`` += ``src``'s row j along ``dim``, in order of
    j: one ``index_add_`` for each repeat of a row, each over rows that
    differ, so that no destination takes two additions at once."""
    seen: dict = {}
    passes: list = []
    for j, r in enumerate(rows):
        k = seen.get(r, 0)
        seen[r] = k + 1
        if k == len(passes):
            passes.append(([], []))
        passes[k][0].append(r)
        passes[k][1].append(j)
    for dst, sel in passes:
        idx = torch.tensor(sel, device=src.device)
        acc.index_add_(dim, torch.tensor(dst, device=acc.device), src.index_select(dim, idx))


class _ExchangeRows(torch.autograd.Function):
    """:func:`exchange_rows` with its backward (the exchange in reverse)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.fmt = plan, memory_format(x)
        return plan.forward(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.backward(g, ctx.fmt), None


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
