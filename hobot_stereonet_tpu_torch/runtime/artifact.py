"""Compiled model artifact: a serialized export of the serving pipeline.

Counterpart of ``hobot_stereonet_tpu/runtime/artifact.py``.  The reference
deploys a fixed-function compiled blob (a ``.hbm`` file with the weights,
graph and quantization baked in; the runtime only feeds tensors).  Here the
blob is a ``.stereoblob`` zip:

  * ``manifest.json``: the format version, the exporting torch version,
    the platforms, the batch buckets, the geometry, the quantization, the
    network's name, the whole config and the outputs;
  * per platform (``cpu``, ``cuda``) and bucket b, ``{platform}/nv12_b{b}.pt2``
    and ``{platform}/rgb_b{b}.pt2``: ``torch.export.save`` of the pipeline
    (ingest, network, disparity and depth) traced on that platform's
    device, with the weights as the program's constants.

The hand-written kernels are custom operators (``hst::*``, registered by
``ops/kernels``), so an exported program calls them by name: on CUDA
tensors the kernel, on CPU tensors its plain version.  Loading needs those
operators and no model code.  A program is run on the device it was traced
on: loading picks the caller's device's entries and raises where the
artifact has none, and raises on another torch version than the
exporter's (a ``.pt2`` is not promised to load across versions) and on a
JAX ``.stereoblob`` (``.stablehlo`` entries).
"""

from __future__ import annotations

import copy
import io
import json
import zipfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, resolve_device
# The custom operators an exported program calls; importing them registers them.
from ..ops.kernels import correlation, group_norm, int8_conv, preprocess_kernel  # noqa: F401
from ..utils.precision import exact_float32
from .serving import ServingLoop, nonfinite_flags

FORMAT_VERSION = 1
MANIFEST = "manifest.json"
PLATFORMS = ("cpu", "cuda")
SUFFIX = ".pt2"


class _Pipeline(torch.nn.Module):
    """The serving contract of one entry: ``nv12`` ([B, L] uint8
    side-by-side NV12 -> (disparity, depth) [B, H, W]) or ``rgb`` (two
    [B, H, W, 3] uint8 images -> the same)."""

    def __init__(self, net: torch.nn.Module, cfg: Config, kind: str):
        super().__init__()
        self.net, self.cfg, self.kind = net, cfg, kind

    def forward(self, *inputs):
        from ..ops import preprocess as pp

        cfg = self.cfg
        if self.kind == "nv12":
            H, W = cfg.camera.height, cfg.camera.width
            x = pp.nv12_ingest(inputs[0], H, 2 * W, cfg.preprocess)
        else:
            x = pp.rgb_batch_to_model_input(*inputs, cfg.preprocess)
        disp = self.net(*pp.split_model_input(x))["disparity"]
        return disp, cfg.camera.depth_from_disparity(disp)


def _export(module: torch.nn.Module, args, dtype, device) -> bytes:
    with torch.no_grad(), exact_float32(dtype, device):
        ep = torch.export.export(module, args)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_artifact(
    path: str,
    model,
    params,
    cfg: Config,
    buckets: Sequence[int] = (1, 8),
    platforms: Sequence[str] = ("cuda",),
    int8: bool = False,
    static_quant=None,
) -> dict:
    """Trace and serialize the serving pipeline for each platform and batch
    bucket and write a ``.stereoblob`` zip.  Returns the manifest dict.

    ``model``, ``params``, ``int8`` and ``static_quant`` (a calibration dict
    or ``calib.json`` path) are what :class:`~.engine.StereoEngine` takes
    (a built float32 network is copied to each platform's device); each
    platform's entries are traced on its device (``cuda:0`` for ``cuda``)."""
    from ..models import model_name
    from ..ops.quant import load_calibration
    from .engine import serving_network

    platforms = tuple(dict.fromkeys(platforms))
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms {list(platforms)}: expected some of {list(PLATFORMS)}")
    if isinstance(static_quant, str):
        static_quant = load_calibration(static_quant)
    buckets = sorted(set(int(b) for b in buckets))
    H, W = cfg.camera.height, cfg.camera.width
    frame_len = H * (2 * W) * 3 // 2
    entries, name = {}, None
    for platform in platforms:
        device = resolve_device("cuda:0" if platform == "cuda" else "cpu", "export_artifact")
        built = model if isinstance(model, str) else copy.deepcopy(model).to(device)
        net = serving_network(built, params, cfg, device, int8, static_quant)
        for p in net.parameters():
            p.requires_grad_(False)
        name = model_name(net)
        for b in buckets:
            sbs = torch.zeros((b, frame_len), dtype=torch.uint8, device=device)
            # Two tensors: export would trace one passed twice as one input.
            imgs = tuple(torch.zeros((b, H, W, 3), dtype=torch.uint8, device=device)
                         for _ in range(2))
            for kind, args in (("nv12", (sbs,)), ("rgb", imgs)):
                entries[f"{platform}/{kind}_b{b}{SUFFIX}"] = _export(
                    _Pipeline(net, cfg, kind), args, cfg.model.compute_dtype, device)
        del net
    manifest = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "buckets": buckets,
        "height": H,
        "width": W,
        "frame_len": frame_len,
        "int8": bool(int8 or static_quant is not None),
        "quant": ("static" if static_quant is not None
                  else "dynamic" if int8 else "none"),
        "model": name,
        "config": cfg.to_dict(),
        "outputs": ["disparity_px[B,H,W]f32", "depth_m[B,H,W]f32"],
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(MANIFEST, json.dumps(manifest, indent=2))
        for entry, blob in entries.items():
            z.writestr(entry, blob)
    return manifest


def _without_metadata_asserts(gm: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """Drop the dtype and device assertions export puts at each conversion
    (``aten._assert_tensor_metadata``, about a hundred an entry, a dispatch
    each): an entry's inputs are checked against its input spec when it is
    called, and what runs after them is the traced program."""
    for node in list(gm.graph.nodes):
        if node.op == "call_function" and node.target is torch.ops.aten._assert_tensor_metadata.default:
            gm.graph.erase_node(node)
    gm.recompile()
    return gm


class CompiledStereoArtifact:
    """A loaded ``.stereoblob``: runs the baked pipeline with no model code.

    ``device`` (default ``cuda:0``; ``"cpu"`` on a machine without a card)
    selects the platform's entries.  Entries are loaded once per bucket;
    batches are padded with zero frames up to the nearest bucket, and a
    batch over the largest is refused.
    """

    def __init__(self, path: str, device: "str | torch.device | None" = None):
        self._zf = zipfile.ZipFile(path, "r")
        try:
            self.manifest = m = json.loads(self._zf.read(MANIFEST).decode())
            if "jax_version" in m or any(n.endswith(".stablehlo") for n in self._zf.namelist()):
                raise ValueError(
                    f"{path} is a JAX artifact (StableHLO entries, jax "
                    f"{m.get('jax_version')}); export one with the torch package's "
                    "export_artifact")
            if m.get("format_version") != FORMAT_VERSION:
                raise ValueError(f"artifact format {m.get('format_version')} != "
                                 f"supported {FORMAT_VERSION}")
            if m.get("torch_version") != torch.__version__:
                raise ValueError(
                    f"{path} was exported by torch {m.get('torch_version')}; this is torch "
                    f"{torch.__version__}, which is not promised to load its programs")
            self.device = resolve_device(device, "CompiledStereoArtifact")
            if self.device.type not in m["platforms"]:
                raise ValueError(
                    f"{path} holds no {self.device.type} entries (platforms "
                    f"{m['platforms']}); export it with platforms including "
                    f"{self.device.type!r}")
        except BaseException:
            self._zf.close()
            raise
        self.buckets = list(m["buckets"])
        self.height, self.width = m["height"], m["width"]
        self._dtype = Config.from_dict(m["config"]).model.compute_dtype
        self._cache = {}

    # -- internals ----------------------------------------------------
    def _entry(self, kind: str, bucket: int) -> torch.fx.GraphModule:
        key = (kind, bucket)
        if key not in self._cache:
            blob = self._zf.read(f"{self.device.type}/{kind}_b{bucket}{SUFFIX}")
            self._cache[key] = _without_metadata_asserts(
                torch.export.load(io.BytesIO(blob)).module())
        return self._cache[key]

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch {n} exceeds largest exported bucket {self.buckets[-1]}")

    def _staged(self, rows, bucket: int) -> torch.Tensor:
        """``rows`` (a [B, ...] array or tensor, or B arrays) as a [bucket, ...]
        tensor on the device, zero rows after them.  Host rows are copied once
        into a (pinned, on CUDA) buffer, which goes to the card in one copy."""
        if isinstance(rows, torch.Tensor):
            pad = rows.new_zeros((bucket - rows.shape[0],) + tuple(rows.shape[1:]))
            return torch.cat([rows, pad]).to(self.device)
        first = np.asarray(rows[0])
        dtype = torch.from_numpy(np.empty(0, first.dtype)).dtype
        buf = torch.empty((bucket,) + first.shape, dtype=dtype,
                          pin_memory=self.device.type == "cuda")
        host = buf.numpy()
        for i, row in enumerate(rows):
            host[i] = row
        host[len(rows):] = 0
        return buf.to(self.device, non_blocking=True)

    def _call(self, kind: str, bucket: int, *args):
        with torch.inference_mode(), exact_float32(self._dtype, self.device):
            return self._entry(kind, bucket)(*args)

    def _to_host(self, *tensors) -> list:
        """numpy copies of device tensors (through pinned memory on CUDA)."""
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        out = [t.to("cpu", non_blocking=True) for t in tensors]
        torch.cuda.current_stream(self.device).synchronize()
        return [t.numpy() for t in out]

    # -- public surface -------------------------------------------------
    def call_nv12_async(self, sbs_batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B <= bucket, frame_len] uint8 (an array or B frames) -> (disp,
        depth) on the device, padded to the bucket, enqueued on the current
        stream (read them after a synchronization; :meth:`run_nv12` is the
        synchronous call)."""
        b = self._bucket_for(len(sbs_batch))
        return self._call("nv12", b, self._staged(sbs_batch, b))

    def run_nv12(self, sbs_batch) -> Tuple[np.ndarray, np.ndarray]:
        """[B, frame_len] uint8 -> (disparity [B,H,W], depth_m [B,H,W])."""
        n = len(sbs_batch)
        disp, depth = self.call_nv12_async(sbs_batch)
        return tuple(self._to_host(disp[:n], depth[:n]))

    def infer(self, left_u8, right_u8) -> np.ndarray:
        """RGB uint8 pair(s) -> disparity.  Accepts [H,W,3] or [B,H,W,3]."""
        l, r = np.asarray(left_u8), np.asarray(right_u8)
        single = l.ndim == 3
        if single:
            l, r = l[None], r[None]
        b = self._bucket_for(l.shape[0])
        disp, _ = self._call("rgb", b, self._staged(l, b), self._staged(r, b))
        disp = self._to_host(disp[: l.shape[0]])[0]
        return disp[0] if single else disp

    def close(self) -> None:
        self._zf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ArtifactEngine(ServingLoop):
    """Async streaming engine over a loaded ``.stereoblob``: the
    deployment-side serving loop (no model code, no checkpoint).

    The feed/dispatch/fetch machine is :class:`~.serving.ServingLoop`, as
    in :class:`~.engine.StereoEngine`; this class supplies only how a
    micro-batch is staged and run (``_submit``), padded to the artifact's
    buckets.  Results are host arrays; with ``nan_guard`` a frame whose
    disparity is not finite (flagged on the device, as the engine flags
    it) is dropped.  On CUDA the dispatch thread copies the frames into a
    pinned batch and enqueues it on a stream of its own, with non-blocking
    copies of the results into pinned host memory, and records an event
    that the fetch thread waits for.
    """

    _thread_prefix = "artifact"

    def __init__(self, artifact, inflight: int = 4, feed_queue_depth: int = 64,
                 drop_on_full: bool = True, nan_guard: bool = True,
                 max_batch: Optional[int] = None,
                 device: "str | torch.device | None" = None):
        self.artifact = (artifact if isinstance(artifact, CompiledStereoArtifact)
                         else CompiledStereoArtifact(artifact, device))
        m = self.artifact.manifest
        self.height, self.width = m["height"], m["width"]
        self.max_batch = max_batch or max(self.artifact.buckets)
        if self.max_batch not in self.artifact.buckets:
            raise ValueError(f"max_batch={self.max_batch} not an exported bucket "
                             f"{self.artifact.buckets}")
        self.device = self.artifact.device
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._init_serving(expected_len=m["frame_len"], height=self.height, width=self.width,
                           feed_queue_depth=feed_queue_depth, inflight=inflight,
                           drop_on_full=drop_on_full, max_batch=self.max_batch,
                           nan_guard=nan_guard)

    # -- lifecycle ------------------------------------------------------
    def warmup(self) -> None:
        dummy = np.zeros((self.max_batch, self._expected_len), np.uint8)
        self.artifact.run_nv12(dummy)

    # -- the serving loop's hook ------------------------------------------
    def _submit(self, frames: list):
        """((disp, depth, None, non-finite flags [B]) on the host, pinned and
        filled once the event is done on CUDA; the event or None)."""
        rows = [f.sbs_nv12 for f in frames]
        if self._stream is None:
            disp, depth = self.artifact.call_nv12_async(rows)
            return (disp, depth, None, nonfinite_flags(disp)), None
        with torch.cuda.stream(self._stream):
            disp, depth = self.artifact.call_nv12_async(rows)
            outs = [t.to("cpu", non_blocking=True) for t in (disp, depth, nonfinite_flags(disp))]
            event = torch.cuda.Event()
            event.record(self._stream)
        return (outs[0], outs[1], None, outs[2]), event
