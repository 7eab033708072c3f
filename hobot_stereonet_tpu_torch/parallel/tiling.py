"""Row tiling of a forward across the ranks of a ``tile`` group.

Counterpart of what GSPMD does for the JAX package when image rows are
sharded over the ``tile`` mesh axis (``hobot_stereonet_tpu/parallel/``):
here each rank of a tile group runs the network on its own rows, and the
layers that see across rows ask the active :class:`RowTiles` for what they
need (:func:`row_tiles` makes it active for a forward):

  * a conv (``models/layers.py``, ``ops/quant.py``) runs the call it runs on
    a whole image, on its tile extended by the rows above and below it that
    its taps reach (:meth:`RowTiles.conv_rows`), and crops its output back
    to the tile; rows beyond the image are zero, as "SAME" padding;
  * a GroupNorm sums its statistics over this rank's rows
    (``group_norm_stats``), gathers every rank's sums and adds them in
    rank order (:meth:`RowTiles.group_statistics`), then normalizes its rows
    (``group_norm_apply``);
  * the 2x bilinear stencil and the convex upsampling take one neighbour
    row (edge-replicated, and zero, at the image's edge);
  * the dynamic int8 scale takes the max over the tile group.

Rows split at the network's coarsest resolution (1/2^K): rank t of T takes
``n // T + (t < n % T)`` of its n rows (at 720p and K = 3, T = 4: 23, 23,
22, 22), and 2^K / s times as many at 1/s, so every tile starts at a
multiple of 2^K / s rows and the stride-2 convs and the 2x2 pooling line
up.  A tensor's resolution is read from its row count on this rank.  A
tile count above the coarsest row count is refused.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.kernels.int8_conv import same_pads
from .halo import comm_device, exchange_rows, memory_format

_local = threading.local()


def active() -> "Optional[RowTiles]":
    """The row tiling of the forward running on this thread, or None."""
    return getattr(_local, "tiles", None)


@contextlib.contextmanager
def row_tiles(tiles: "Optional[RowTiles]"):
    """Make ``tiles`` the active row tiling for the block (None: none)."""
    prev = active()
    _local.tiles = tiles
    try:
        yield tiles
    finally:
        _local.tiles = prev


def split_rows(rows: int, tiles: int) -> list:
    """Rows of each of ``tiles`` tiles of ``rows`` rows, the first ones one
    longer where they do not divide (GSPMD's uneven split)."""
    if tiles < 1 or tiles > rows:
        raise ValueError(f"cannot split {rows} rows over {tiles} tiles: the tile count must "
                         f"lie in [1, {rows}] (the coarsest resolution's rows)")
    base, extra = divmod(rows, tiles)
    return [base + (t < extra) for t in range(tiles)]


class RowTiles:
    """This rank's rows of an image of ``height`` rows split over the ranks
    of ``group`` (a ``torch.distributed`` group of T ranks; this rank is the
    group's ``index``), at a network that downsamples by ``factor`` (2^K)."""

    def __init__(self, height: int, factor: int, group, index: Optional[int] = None,
                 size: Optional[int] = None):
        """``group=None`` with ``size`` and ``index``: the geometry alone (no
        collective can run)."""
        if height % factor:
            raise ValueError(f"row tiling needs a height divisible by {factor}, got {height}")
        self.group = group
        self.size = dist.get_world_size(group) if group is not None else size
        self.index = dist.get_rank(group) if index is None else index
        self.factor = factor
        self.coarse = split_rows(height // factor, self.size)
        self._peers = ([dist.get_global_rank(group, t) for t in range(self.size)]
                       if group is not None else None)

    # ------------------------------------------------------------------
    # Geometry
    # ------------------------------------------------------------------

    def layout(self, rows: int):
        """(starts, counts, total) of every rank's rows at the resolution
        where this rank holds ``rows`` rows."""
        mine = self.coarse[self.index]
        if rows % mine:
            raise ValueError(f"a tensor of {rows} rows is at no resolution of this tile "
                             f"({mine} rows at 1/{self.factor})")
        mult = rows // mine
        counts = [c * mult for c in self.coarse]
        starts = [sum(counts[:t]) for t in range(self.size)]
        return starts, counts, sum(counts)

    def full_rows(self) -> slice:
        """This rank's rows of the full-resolution image."""
        starts, counts, _ = self.layout(self.coarse[self.index] * self.factor)
        return slice(starts[self.index], starts[self.index] + counts[self.index])

    def conv_rows(self, rows: int, kernel: int, stride: int, dilation: int, t=None):
        """How a "SAME" conv runs on the tile of rank ``t`` (default: this
        rank) holding ``rows`` of its input's rows at this resolution ->
        (rows above, rows below, first output row to keep): the conv of the
        tile so extended, "SAME" padded as a whole image, gives at those
        rows exactly the whole image's output rows of the tile."""
        t = self.index if t is None else t
        starts, counts, total = self.layout(rows)
        local, start = counts[t], starts[t]
        if start % stride or local % stride:
            raise ValueError(f"a tile at row {start} of {local} rows does not line up with "
                             f"stride {stride}")
        reach = (kernel - 1) * dilation + 1
        lo = same_pads(total, kernel, stride, dilation)[0]
        for extra in range(stride):                 # rows above beyond the taps' reach
            for more in range(stride):              # rows below beyond it
                top, bottom = lo + extra, max(reach - stride - lo, 0) + more
                ext = local + top + bottom
                shift = extra + same_pads(ext, kernel, stride, dilation)[0]
                first = shift // stride
                if shift % stride == 0 and first + local // stride <= -(-ext // stride):
                    return top, bottom, first
        raise AssertionError(f"no halo lines up a {kernel}x stride {stride} conv")

    # ------------------------------------------------------------------
    # Collectives
    # ------------------------------------------------------------------

    def exchange(self, x: torch.Tensor, top, bottom, dim: int, edge: str = "zero"
                 ) -> torch.Tensor:
        """``x`` with the ``top`` rows above and ``bottom`` rows below this
        rank's tile along ``dim`` (ints, or one each a rank): ``halo.exchange_rows``
        over this tiling's layout at ``x``'s resolution."""
        starts, counts, _ = self.layout(x.shape[dim])
        return exchange_rows(x, starts, counts, top, bottom, dim, self.group, edge,
                             index=self.index, peers=self._peers)

    def conv(self, fn, x: torch.Tensor, dim: int, kernel: int, stride: int, dilation: int
             ) -> torch.Tensor:
        """A "SAME" conv ``fn`` (the whole image's call: [.., rows, ..] ->
        [.., ceil(rows / stride), ..]) of this rank's tile ``x`` (rows along
        ``dim``): ``fn`` of the tile extended by :meth:`conv_rows`' halo,
        cropped back to the tile's output rows, in ``fn``'s memory format."""
        rows = x.shape[dim]
        plans = [self.conv_rows(rows, kernel, stride, dilation, t) for t in range(self.size)]
        first = plans[self.index][2]
        y = fn(self.exchange(x, [p[0] for p in plans], [p[1] for p in plans], dim))
        return y.narrow(dim, first, rows // stride).contiguous(memory_format=memory_format(y))

    def image_count(self, count: int) -> int:
        """The whole image's count of what this rank's tile holds ``count``
        of, in proportion to rows (the same at every resolution)."""
        return count * sum(self.coarse) // self.coarse[self.index]

    def sum_in_rank_order(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the tile group: every rank's gathered and added
        in float64 in rank order, so that every rank holds the same bits
        whatever the arrival order (float64, on ``t``'s device)."""
        from .collectives import sum_in_rank_order

        return sum_in_rank_order(t, self.group)

    def group_statistics(self, sums: torch.Tensor, count: int, eps: float):
        """(mean, rstd) float32 [N, G] of the whole image from this rank's
        group sums float32 [N, G, 2] over ``count`` elements a group on this
        rank: every rank's sums added in float64 in rank order and rounded
        once (:meth:`sum_in_rank_order`, as ``group_norm.combine_sums``)."""
        from ..ops.kernels.group_norm import statistics_from_sums

        total = self.sum_in_rank_order(sums).float()
        return statistics_from_sums(total, self.image_count(count), eps)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole image's rows along ``dim`` from every rank's tile ``t``
        (tiles of unequal heights padded to the tallest for the gather)."""
        _, counts, _ = self.layout(t.shape[dim])
        pad = list(t.shape)
        pad[dim] = max(counts) - counts[self.index]
        mine = torch.cat([t, t.new_zeros(pad)], dim) if pad[dim] else t
        mine = mine.to(comm_device(t, self.group)).contiguous()
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=self.group)
        return torch.cat([p.narrow(dim, 0, c) for p, c in zip(parts, counts)], dim).to(t.device)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the tile group."""
        out = t.to(comm_device(t, self.group), copy=True)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out.to(t.device)

