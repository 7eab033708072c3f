"""Streaming stereo engine of the port.

Counterpart of ``hobot_stereonet_tpu/runtime/engine.py``: the same
feed/poll/results/drain surface (``serving.ServingLoop``), the same
adaptive micro-batching into padded batch buckets, the same results.

  feed(frame) -> [feed queue] -> dispatch: take <= max_batch queued frames,
                                 pad to a bucket, one pipeline call on the
                                 engine's CUDA stream, record an event
              -> [in-flight queue, depth = cfg.engine.inflight]
              -> fetch: wait for the event (with a deadline), split the
                 batch into results -> [result queue]

The pipeline per batch is the NV12 ingest kernel, the network
(``FastStereoNet``, or the CLASSIC ``StereoNet`` with ``model="classic"``),
depth and the per-frame non-finite flags.  In place of the reference's jit
dispatch, the dispatch thread enqueues the work on a CUDA stream of its own
and records an event; the fetch thread polls the event.  On the CPU
(``device="cpu"``) the same pipeline runs synchronously in the dispatch
thread.

Where a batch comes from:
  * host frames (numpy ``sbs_nv12``): one pinned host-to-device copy;
  * frames whose ``sbs_nv12`` are :class:`~..data.stream.RingSlot` of one
    :class:`~..data.stream.DeviceFrameRing`: one ``index_select`` of the
    ring on the engine's stream, after the stream has waited for the ring's
    staging copy (``ring.ready``); no host copy.

Options (``cfg.engine``):
  * ``fetch_results=False``: results keep the batch on the device; each
    holds a :class:`DeviceBatchView` of its row (no launch, no copy).  Only
    the [B] non-finite flags come back to the host; completion is the
    batch's event;
  * ``stage_timing``: the ingest and the network run as two stages, each
    ended by a wait on its own event, timed into
    ``metrics.preprocess_latency`` and ``metrics.network_latency``.  This
    serializes batches and is a diagnostic, not a serving mode;
  * ``device_microbatch=m``: a bucket larger than ``m`` (and a multiple of
    it) runs as consecutive chunks of ``m`` frames in one dispatch, which
    bounds activation memory by the chunk.

w8a8 (``int8=True``, dynamic scales, or ``static_quant=`` a calibration
dict or ``calib.json`` path, static scales): every conv runs as the int8
conv kernel where it takes the conv, else the exact library route
(``ops/quant.py``), quantized once from the float32 weights.

On a (data, tile) mesh (``mesh=`` a ``DeviceMesh`` from ``parallel.mesh``,
or ``cfg.mesh`` with more than one device; every rank of the process group
builds the engine, SPMD), as the JAX engine serves on one:
  * rank 0 owns ``feed`` and ``poll``; every other rank runs :meth:`serve`
    until rank 0 calls :meth:`close`;
  * each dispatch broadcasts a header (kind, bucket), then
    scatters the frames: data rank d takes the d-th slice of the batch (of
    each ``device_microbatch`` chunk), the ranks of a tile group the same
    frames; each rank ingests its frames whole, keeps its tile's rows and
    runs the network on them (``parallel/tiling.py``: halos, the
    GroupNorm's statistics over the tile group);
  * rank 0 gathers disparity, depth and confidence and computes the
    per-frame non-finite flags from the gathered maps;
  * batch buckets that do not divide by ``data`` are dropped (none left
    raises), and a ``device_microbatch`` that is not a multiple of ``data``
    raises ``ValueError``; ring-fed frames are resolved on the host (the
    ring lives on one card); ``stage_timing`` is not split into stages;
  * the synchronous ``infer*`` calls run on rank 0's card alone.
"""

from __future__ import annotations

import time
from typing import Mapping, Optional

import numpy as np
import torch

from ..config import Config, resolve_device
from ..parallel import mesh as mesh_mod
from ..parallel import tiling
from ..data.stream import Frame, RingSlot
from ..models import build_model, model_name
from ..ops import preprocess as pp
from ..ops.disparity import disparity_to_depth_m
from ..ops.quant import load_calibration, serving_model
from .serving import DeviceBatchView, ServingLoop, StereoResult, nonfinite_flags
from .weights import from_flax_params, random_flax_params

__all__ = ["DeviceBatchView", "Frame", "StereoEngine", "StereoResult", "nonfinite_flags"]


def serving_network(model, params: Optional[Mapping], cfg: Config, device: torch.device,
                    int8: bool = False, static_quant=None) -> torch.nn.Module:
    """The network :class:`StereoEngine` serves: ``model`` (a name, built on
    ``device``, or a built network) with ``params`` (None: seeded random
    weights for a name, a built network's own), quantized as ``int8`` and
    ``static_quant`` ask, in eval mode."""
    built = not isinstance(model, str)
    model = build_model(model, cfg.model, device)
    name = model_name(model)
    if params is None and not built:
        params = random_flax_params(cfg.model, seed=0, model=name)
    if params is not None:
        model.load_state_dict(from_flax_params(params, model.cfg, name))
    return serving_model(model, int8, static_quant)


# Dispatch headers on a mesh: (kind, bucket).
_RUN, _STOP = 1, 0


class StereoEngine(ServingLoop):
    """Feed-many streaming engine on one device, or on a (data, tile) mesh.

    Usage::

        eng = StereoEngine(cfg)            # seeded random weights on cuda:0
        eng.start()
        for frame in source: eng.feed(frame)
        eng.drain()
        for res in eng.results(): ...
        eng.stop()

    ``model`` is ``"fast"`` (``FastStereoNet``, the flagship), ``"classic"``
    (the CLASSIC ``StereoNet``) or a port network built on ``device``, as
    the JAX engine's ``model=`` and its CLI's ``--model`` choose.
    ``params`` is a flax parameter tree of the JAX package (nested numpy
    arrays, as orbax or :func:`~.weights.load_flax_npz` loads it); ``None``
    means random weights from seed 0 (:func:`~.weights.random_flax_params`),
    or a built network's own weights.  ``int8=True`` serves w8a8 with
    dynamic scales, ``static_quant`` (a calibration dict or a ``calib.json``
    path) with calibrated ones, both networks (CLASSIC's 3-D and dilated
    convs through the exact library route).  ``mesh``: a (data, tile)
    ``DeviceMesh`` (module docstring); None takes ``cfg.mesh`` when it has
    more than one device.
    """

    _thread_prefix = "engine"

    def __init__(self, cfg: Config = Config(), params: Optional[Mapping] = None,
                 compute_depth: bool = True, emit_confidence: bool = False,
                 keep_left: bool = False, int8: bool = False, static_quant=None,
                 device: "str | torch.device | None" = None, model="fast", mesh=None):
        if mesh is None and cfg.mesh.num_devices > 1:
            mesh = mesh_mod.make_mesh(cfg.mesh)
        self.mesh = mesh
        if device is None and mesh is not None and mesh_mod.device_type() == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = resolve_device(device, "StereoEngine")
        self.cfg = cfg
        H, W = cfg.camera.height, cfg.camera.width
        self._init_serving(
            expected_len=H * (2 * W) * 3 // 2,
            height=H,
            width=W,
            feed_queue_depth=cfg.engine.feed_queue_depth,
            inflight=cfg.engine.inflight,
            drop_on_full=cfg.engine.drop_on_full,
            max_batch=cfg.engine.max_batch,
            nan_guard=cfg.engine.nan_guard,
            fetch_results=cfg.engine.fetch_results,
            keep_left=keep_left,
        )
        if isinstance(static_quant, str):
            static_quant = load_calibration(static_quant)
        self.int8 = int8
        self.static_quant = static_quant
        self.model = serving_network(model, params, cfg, self.device, int8, static_quant)
        self._compute_depth = compute_depth
        self._emit_confidence = emit_confidence
        self._buckets = cfg.engine.batch_buckets
        if mesh is not None:
            self._init_mesh(mesh)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            # The weights were placed on the default stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    # ------------------------------------------------------------------
    # Pipeline
    # ------------------------------------------------------------------

    def _ingest(self, sbs_batch: torch.Tensor) -> torch.Tensor:
        H, W = self.cfg.camera.height, self.cfg.camera.width
        return pp.nv12_ingest(sbs_batch, H, 2 * W, self.cfg.preprocess)

    def _network(self, x: torch.Tensor):
        disp, depth, conf = self._maps(x)
        return disp, depth, conf, nonfinite_flags(disp)

    def _maps(self, x: torch.Tensor):
        """(disparity, depth | None, confidence | None) of model inputs."""
        out = self.model(*pp.split_model_input(x))
        disp = out["disparity"]
        depth = disparity_to_depth_m(disp, self.cfg.camera) if self._compute_depth else None
        conf = out["confidence"] if self._emit_confidence else None
        return disp, depth, conf

    @torch.inference_mode()
    def pipeline(self, sbs_batch: torch.Tensor):
        """[B, L] uint8 frames on the engine's device ->
        (disparity [B,H,W], depth | None, confidence | None, flags [B]).

        With ``device_microbatch = m`` a batch larger than ``m`` (and a
        multiple of it) runs as consecutive chunks of ``m`` frames.  On a
        mesh (rank 0 only, the others serving): one dispatch over the mesh."""
        if self.mesh is not None:
            return self._mesh_pipeline(sbs_batch)
        return self._chunked(sbs_batch, self.cfg.engine.device_microbatch, self._network)

    def _chunked(self, sbs_batch: torch.Tensor, m: int, network):
        b = sbs_batch.shape[0]
        if not (m and b > m and b % m == 0):
            return network(self._ingest(sbs_batch))
        chunks = [network(self._ingest(c)) for c in sbs_batch.split(m)]
        return tuple(torch.cat(parts) if parts[0] is not None else None
                     for parts in zip(*chunks))

    def _bucket(self, n: int) -> int:
        return next(b for b in self._buckets if b >= n)

    def _assemble_batch(self, frames):
        """The frames as one [bucket, L] batch, padded by repeating the last
        frame (pad rows are computed, then discarded).

        Returns ``(ring, slot indices)`` when every frame is a slot of one
        device ring, else a numpy array (slots of several rings are copied
        to the host first).
        """
        bufs = [f.sbs_nv12 for f in frames]
        bufs += [bufs[-1]] * (self._bucket(len(bufs)) - len(bufs))
        first = bufs[0]
        if self.mesh is None and isinstance(first, RingSlot) and all(
                isinstance(b, RingSlot) and b.ring is first.ring for b in bufs):
            return first.ring, [b.slot for b in bufs]
        return np.stack([np.asarray(b) for b in bufs])

    def _to_device(self, batch) -> torch.Tensor:
        """A batch from :meth:`_assemble_batch` as a [B, L] tensor on the
        engine's device, enqueued on the current (the engine's) stream."""
        if isinstance(batch, np.ndarray):
            t = torch.from_numpy(batch)
            if self._stream is None:
                return t.to(self.device)
            return t.pin_memory().to(self.device, non_blocking=True)
        ring, slots = batch
        if ring.data.device != self.device:
            raise ValueError(f"frame ring on {ring.data.device}, engine on {self.device}")
        idx = torch.tensor(slots, dtype=torch.int64)
        if self._stream is None:
            return ring.data.index_select(0, idx.to(ring.data.device))
        if ring.ready is not None:
            self._stream.wait_event(ring.ready)
        ring.data.record_stream(self._stream)
        return ring.data.index_select(0, idx.pin_memory().to(self.device, non_blocking=True))

    def _launch(self, batch, record: bool = True):
        """Enqueue one batch; returns (outputs, completion event | None).

        On CUDA everything is enqueued on the engine's stream: the batch's
        copy or gather, the pipeline, and non-blocking copies into pinned
        host memory: of every output, or with ``fetch_results=False`` of the
        flags only (the other outputs stay on the device).  The outputs are
        valid once the returned event has completed.  With ``stage_timing``
        the two stages are waited for and timed here (into the metrics
        unless ``record`` is False).
        """
        fetch = self._fetch_results
        timed = self.cfg.engine.stage_timing and self.mesh is None
        if self._stream is None:
            dev = self._to_device(batch)
            if timed:
                outs = self._timed_stages(dev, record)
            else:
                outs = self.pipeline(dev)
            if fetch:
                outs = [o.numpy() if o is not None else None for o in outs]
            return outs, None
        with torch.cuda.stream(self._stream):
            dev = self._to_device(batch)
            if timed:
                outs = self._timed_stages(dev, record)
            else:
                outs = self.pipeline(dev)
            if fetch:
                outs = [o.to("cpu", non_blocking=True) if o is not None else None
                        for o in outs]
            else:
                outs = list(outs[:3]) + [outs[3].to("cpu", non_blocking=True)]
            event = torch.cuda.Event()
            event.record(self._stream)
        return outs, event

    @torch.inference_mode()
    def _timed_stages(self, dev: torch.Tensor, record: bool):
        """The pipeline as two stages, each waited for and timed."""
        t0 = time.monotonic()
        x = self._ingest(dev)
        self._sync()
        t_pre = time.monotonic()
        outs = self._network(x)
        self._sync()
        t_net = time.monotonic()
        if record:
            self.metrics.preprocess_latency.record(t_pre - t0)
            self.metrics.network_latency.record(t_net - t_pre)
        return outs

    def _sync(self) -> None:
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
            self._wait(event)

    # ------------------------------------------------------------------
    # Synchronous API
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _forward(self, x) -> dict:
        x = torch.as_tensor(x).to(self.device)
        return self.model(*pp.split_model_input(x))

    def infer(self, left_rgb: np.ndarray, right_rgb: np.ndarray) -> np.ndarray:
        """One RGB uint8 pair [H, W, 3] -> disparity [H, W] float32 px."""
        x = pp.rgb_pair_to_model_input(left_rgb, right_rgb, self.cfg.preprocess, self.device)
        return self.infer_preprocessed(x)

    def infer_with_confidence(self, left_rgb: np.ndarray, right_rgb: np.ndarray):
        """Like :meth:`infer`, also returning the [H/8, W/8] confidence."""
        x = pp.rgb_pair_to_model_input(left_rgb, right_rgb, self.cfg.preprocess, self.device)
        out = self._forward(x)
        return out["disparity"][0].cpu().numpy(), out["confidence"][0].cpu().numpy()

    def infer_preprocessed(self, x) -> np.ndarray:
        """Forward of a normalized [1, H, W, 6] input -> disparity [H, W]."""
        return self._forward(x)["disparity"][0].cpu().numpy()

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def warmup(self, buckets=None, ring=None) -> None:
        """Run the pipeline once per bucket (default: the smallest and the
        largest), so that the first frames' latencies show steady state.
        With ``ring`` the batches are gathers of its slots, as the
        ring-fed stream's are."""
        if buckets is None:
            buckets = sorted({self._buckets[0], self._buckets[-1]})
        for b in buckets:
            batch = (ring, [0] * b) if ring is not None else \
                np.zeros((b, self._expected_len), np.uint8)
            _, event = self._launch(batch, record=False)
            self._wait(event)

    # ------------------------------------------------------------------
    # Workers
    # ------------------------------------------------------------------

    def _submit(self, frames: list):
        return self._launch(self._assemble_batch(frames))

    # ------------------------------------------------------------------
    # Mesh serving
    # ------------------------------------------------------------------

    def _init_mesh(self, mesh) -> None:
        cfg = self.cfg
        mc = mesh_mod.mesh_config(mesh)
        if mc.num_devices != mesh_mod.world_size():
            raise ValueError(f"the mesh {mc.data}x{mc.tile} must span every rank of the "
                             f"process group ({mesh_mod.world_size()})")
        self._ndata = mc.data
        # Batch buckets must split evenly over the data axis; padding to
        # the bucket covers partial batches.
        self._buckets = tuple(b for b in self._buckets if b % mc.data == 0)
        if not self._buckets:
            raise ValueError(f"no batch bucket divisible by mesh data={mc.data}; "
                             f"set EngineConfig.batch_buckets accordingly")
        self._max_batch = min(self._max_batch, self._buckets[-1])
        m = cfg.engine.device_microbatch
        if m and m % mc.data:
            raise ValueError(f"device_microbatch={m} must be a multiple of the mesh data axis "
                             f"({mc.data}) so that each chunk splits evenly; use "
                             f"m={mc.data * max(1, m // mc.data)} or disable")
        self._local_microbatch = m // mc.data
        self.rank = torch.distributed.get_rank()
        self._root = int(mesh.mesh.flatten()[0])
        self._tiles = None
        if mc.tile > 1:
            self._tiles = tiling.RowTiles(cfg.camera.height, cfg.model.cost_resolution_divisor,
                                          mesh.get_group(mesh_mod.TILE_AXIS))
        self._comm = torch.device("cuda", torch.cuda.current_device()) \
            if mesh_mod.device_type() == "cuda" else torch.device("cpu")
        self._closed = False
        self._order_cache = {}
        mesh_mod.replicate(mesh, self.model)

    @property
    def is_root(self) -> bool:
        """Whether this rank feeds and polls (always, off a mesh)."""
        return self.mesh is None or self.rank == self._root

    def _order(self, bucket: int) -> list:
        """Frame indices in the order the data ranks take them: rank d the
        d-th slice of each microbatch chunk (of the whole batch without)."""
        m = self.cfg.engine.device_microbatch
        chunk = m if (m and bucket > m and bucket % m == 0) else bucket
        per = chunk // self._ndata
        return [c * chunk + d * per + i for d in range(self._ndata)
                for c in range(bucket // chunk) for i in range(per)]

    def _header(self, kind: int = _RUN, bucket: int = 0) -> torch.Tensor:
        """Broadcast rank 0's header; the received one elsewhere.  Rank 0
        never waits for the device here: the header goes up from pinned
        memory on the stream, so dispatches keep overlapping."""
        h = torch.tensor([kind, bucket], dtype=torch.int64)
        if self._comm.type == "cuda":
            h = h.pin_memory().to(self._comm, non_blocking=True)
        torch.distributed.broadcast(h, src=self._root)
        return h

    def _order_index(self, bucket: int, device: torch.device) -> torch.Tensor:
        """:meth:`_order` as an index tensor on ``device``, made once per bucket."""
        key = (bucket, device)
        if key not in self._order_cache:
            self._order_cache[key] = torch.tensor(self._order(bucket), device=device)
        return self._order_cache[key]

    def _mesh_pipeline(self, sbs_batch: torch.Tensor):
        """Rank 0's side of one dispatch over the mesh (module docstring)."""
        if not self.is_root:
            raise RuntimeError(f"rank {self.rank} serves through serve(); rank "
                               f"{self._root} dispatches")
        if self._closed:
            raise RuntimeError("the mesh engine is closed")
        bucket = sbs_batch.shape[0]
        if bucket % self._ndata:
            raise ValueError(f"a batch of {bucket} does not split over data={self._ndata}")
        self._header(_RUN, bucket)
        frames = sbs_batch.to(self._comm)
        if self._ndata > 1:                    # one data rank: the order is the batch's
            frames = frames.index_select(0, self._order_index(bucket, self._comm))
        outs = self._serve_batch(list(frames.chunk(self._ndata)), bucket)
        if self._ndata > 1:
            outs = [None if o is None else torch.empty_like(o).index_copy_(
                0, self._order_index(bucket, o.device), o) for o in outs]
        disp, depth, conf = outs
        return disp, depth, conf, nonfinite_flags(disp)

    @torch.inference_mode()
    def _serve_batch(self, chunks, bucket: int):
        """Every rank's part of a dispatch: the scatter of the frames, the
        local pipeline, the gather of the maps (rank 0 gets them, in the
        scattered order)."""
        mc = mesh_mod.mesh_config(self.mesh)
        local = torch.empty((bucket // self._ndata, self._expected_len), dtype=torch.uint8,
                            device=self._comm)
        scatter = None
        if chunks is not None:                 # rank r = (d, t) takes data slice d
            scatter = [chunks[r // mc.tile].contiguous() for r in range(mc.num_devices)]
        torch.distributed.scatter(local, scatter, src=self._root)
        outs = self._chunked(local.to(self.device), self._local_microbatch, self._tile_maps)
        gathered = []
        for o in outs:
            if o is None:
                gathered.append(None)
                continue
            counts = self._tiles.layout(o.shape[1])[1] if self._tiles else [o.shape[1]]
            gathered.append(mesh_mod.gather_maps(self.mesh, o, counts=counts))
        return gathered

    def _tile_maps(self, x: torch.Tensor):
        """:meth:`_maps` of this rank's rows (all of them at ``tile = 1``);
        rank 0 computes the flags from the gathered maps."""
        if self._tiles is None:
            return self._maps(x)
        x = x[:, self._tiles.full_rows()].contiguous()
        with tiling.row_tiles(self._tiles):
            return self._maps(x)

    def serve(self) -> int:
        """A rank other than rank 0: serve rank 0's dispatches until it calls
        :meth:`close`; returns the dispatches served."""
        if self.mesh is None or self.is_root:
            raise RuntimeError("serve() runs on the mesh's other ranks")
        served = 0
        while True:
            kind, bucket = self._header().tolist()
            if kind == _STOP:
                return served
            self._serve_batch(None, bucket)
            served += 1

    def start(self, warmup: bool = True):
        if not self.is_root:
            raise RuntimeError(f"rank {self.rank} serves through serve(); rank {self._root} "
                               "feeds the mesh engine")
        return super().start(warmup)

    def close(self) -> None:
        """Stop the workers; on a mesh, also end the other ranks' :meth:`serve`
        (rank 0, once)."""
        self.stop()
        if self.mesh is not None and self.is_root and not self._closed:
            self._header(_STOP)
            self._closed = True
