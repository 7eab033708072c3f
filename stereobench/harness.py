"""The benchmark's machinery: finds a cell's files by name, builds the program
under test, hands the window to the traffic's driver, checks what the window
produced against the plain reference and reduces the trace to metrics.

Everything that belongs to one configuration, traffic mix or per-layer metric
lives in a file of its own that this module finds by the name in
``BENCHMARK.json``:

  * ``configs/<config>.json``: the network, its widths and precision, the
    geometry, the ingest's colour space, ``device_microbatch`` and the weights;
  * ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the driver
    ``traffic/<kind>.py``, whose ``run(session)`` feeds the engine and returns a
    :class:`Window`;
  * ``metrics/<metric>.py``: ``read(ctx)`` of one per-layer metric (None when
    the trace holds nothing for it);
  * ``counts/<network>.py``: ``census(model, height, width)``, the work of one
    frame;
  * ``reference/<network>.py``: ``forward(params, left, right, model)``;
  * ``limits/<cell>.json``: the limit of each number the comparison holds.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import frames
from .correctness import compare
from .counts.common import ingest_bytes
from .trace import Tracer

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that no process of the benchmark may hold, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "hobot_stereonet_tpu")
# The NV12 ingest kernel, one launch a batch or a chunk of ``device_microbatch``.
INGEST_KERNEL = "nv12_ingest_kernel"
# Published dense peaks of one card, by a part of its name (NVIDIA H100 SXM data sheet).
PEAKS = {"H100": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12}}


def forbidden_modules(names) -> list:
    """The names among ``names`` whose top-level package is forbidden."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def load_module(path: Path):
    """Import a file of the benchmark by its path (a metric's name holds dots)."""
    name = "stereobench_" + path.parent.name + "_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: list          # this cell's end-to-end metric entries
    per_layer: list           # this cell's per-layer metric entries
    limits: dict


def _covers(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, traffic,
    metrics and limits, each read from its own file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _covers(m, name)]
    # A per-layer metric that lists no cells is reported wherever the
    # end-to-end metric it moves is.
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    limits_file = HERE / "limits" / f"{name}.json"
    return Cell(
        name=name,
        config_name=cfg["name"],
        config=json.loads((root / cfg["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=w["chips"],
        end_to_end=e2e,
        per_layer=layer,
        limits=json.loads(limits_file.read_text()) if limits_file.exists() else {},
    )


def port_config(config: dict, traffic: dict, height: int, width: int):
    """The program's ``Config`` of a cell: the configuration's camera, model and
    ingest, the traffic's engine settings and the configuration's
    ``device_microbatch``."""
    from hobot_stereonet_tpu_torch.config import Config

    engine = dict(traffic["engine"])
    engine["device_microbatch"] = config.get("device_microbatch", 0)
    camera = dict(config["camera"], height=height, width=width)
    return Config.from_dict({"camera": camera, "model": config["model"],
                             "preprocess": config["preprocess"], "engine": engine})


class Consumer:
    """The thread that takes results from the engine as a user would: each
    ``poll`` hands one over, stamped with the host clock at the hand-over.
    ``keep(result, t)`` decides what of a result to hold for the check."""

    def __init__(self, engine, keep: Callable, span: Optional[Callable] = None):
        self.engine = engine
        self.keep = keep
        self.done = {}                  # frame index -> hand-over time
        self.first = threading.Event()
        self._stop = threading.Event()
        self._span = span
        self._thread = threading.Thread(target=self._loop, name="stereobench-consumer",
                                        daemon=True)
        self.error: Optional[BaseException] = None

    def start(self):
        self._thread.start()
        return self

    def _loop(self):
        try:
            while not self._stop.is_set():
                with self._span("stereobench::poll"):
                    res = self.engine.poll(timeout=0.05)
                if res is None:
                    continue
                t = time.monotonic()
                self.done[res.index] = t
                self.first.set()
                self.keep(res, t)
        except Exception as e:  # noqa: BLE001 - re-raised by stop()
            self.error = e

    def stop(self, timeout: float = 30.0):
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("the consumer thread did not stop")
        if self.error is not None:
            raise RuntimeError("the consumer thread failed") from self.error

    def completed_between(self, t0: float, t1: float) -> int:
        return sum(1 for t in list(self.done.values()) if t0 <= t < t1)


@dataclasses.dataclass
class Sample:
    """One result the check holds: the frame's index and pool slot, and the
    program's maps (numpy, or device views until the window has closed)."""
    index: int
    slot: int
    disparity: object
    depth: object
    confidence: object = None


@dataclasses.dataclass
class Window:
    """What a traffic driver hands back."""
    metrics: dict                    # end-to-end name -> value
    attempted: int
    failed: int
    samples: list                    # [Sample]
    missing: list                    # frames accepted and never returned
    nan_dropped: int
    memory_peak_bytes: int
    counters: dict                   # inputs of per-layer readers


class Session:
    """One run's program, frames and options, handed to the traffic driver."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 engine, pool: torch.Tensor, height: int, width: int, marks: list):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.marks = marks              # [(set-up phase, host time at its end)]
        self.traffic = cell.traffic
        self.device = torch.device(device)
        self.engine = engine
        self.pool = pool
        self.height, self.width = height, width
        self.tracer = Tracer(trace and self.device.type == "cuda")
        rng = np.random.default_rng([seed % 2**63, 2])
        self.order = [int(i) for i in rng.permutation(pool.shape[0])]
        self.rng = rng

    def slot(self, index: int) -> int:
        """The pool slot of frame ``index``: consecutive frames take distinct
        slots, so a batch of up to a pool's size never repeats a frame."""
        return self.order[index % len(self.order)]

    def span(self, name: str):
        """A profiler span around a call into the program, when tracing."""
        import contextlib

        if not self.trace:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def mark(self, phase: str) -> float:
        """End the set-up phase ``phase`` now; returns the host clock's time."""
        t = time.monotonic()
        self.marks.append((phase, t))
        return t

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _materialize(samples: list) -> list:
    """Every sample's maps as float32 CPU tensors."""
    def host(x):
        if x is None:
            return None
        if hasattr(x, "device_array"):
            x = x.device_array()
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x
                               ).float().cpu()
    return [dataclasses.replace(s, disparity=host(s.disparity), depth=host(s.depth),
                                confidence=host(s.confidence)) for s in samples]


def reference_outputs(cell: Cell, pool: torch.Tensor, slots, height: int, width: int,
                      device) -> dict:
    """{slot: (disparity, confidence)} of the plain reference, frame by frame
    in float32 without TF32, on ``device``."""
    from .reference import common

    net = importlib.import_module(f"stereobench.reference.{cell.config['network']}")
    params = common.Params(common.load_npz(str(ROOT / cell.config["weights"])), device)
    model = dict(cell.config["model"])
    out = {}
    with torch.no_grad(), common.exact_float32():
        for slot in sorted(set(slots)):
            left, right = common.nv12_to_input(pool[slot:slot + 1].to(device), height, width,
                                               cell.config["preprocess"]["color_space"])
            r = net.forward(params, left, right, model)
            out[slot] = (r["disparity"][0].cpu(), r["confidence"][0].cpu())
    del params
    return out


def census(cell: Cell, height: int, width: int):
    return importlib.import_module(f"stereobench.counts.{cell.config['network']}").census(
        cell.config["model"], height, width)


@dataclasses.dataclass
class LayerContext:
    """What a per-layer reader reads."""
    trace: object            # trace.Slice, or None
    frames_in_slice: int     # frames the device worked on in the traced slice
    census: object           # counts.common.Census of one frame
    ingest_bytes: int        # per frame
    peaks: Optional[dict]
    counters: dict


def per_layer_metrics(cell: Cell, ctx: LayerContext) -> dict:
    out = {}
    for m in cell.per_layer:
        v = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def setup_phases(t_start: float, marks: list) -> dict:
    """{phase: seconds} of the set-up, from consecutive marks after ``t_start``."""
    out, t = {}, t_start
    for name, end in marks:
        out[name] = end - t
        t = end
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             control: Optional[str] = None, height: Optional[int] = None,
             width: Optional[int] = None, t_start: Optional[float] = None,
             marks: Optional[list] = None) -> dict:
    """One run of ``cell``: set-up, the measured window, the check.  Returns the
    result line's fields.  ``control="int8"`` serves the network in int8
    (``StereoEngine(int8=True)``, dynamic scales); ``height`` / ``width``
    override the geometry (tests); ``marks`` holds the set-up phases ended
    before the call, as (name, host time)."""
    marks = [] if marks is None else marks
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine
    from hobot_stereonet_tpu_torch.runtime.weights import load_flax_npz

    t_start = time.monotonic() if t_start is None else t_start
    if control not in (None, "int8"):
        raise ValueError(f"the program serves no {control!r} control")
    marks.append(("port_import", time.monotonic()))
    cfg = cell.config
    h = height or cfg["camera"]["height"]
    w = width or cfg["camera"]["width"]
    pcfg = port_config(cfg, cell.traffic, h, w)
    params = load_flax_npz(str(ROOT / cfg["weights"]))
    marks.append(("weights_read", time.monotonic()))
    engine = StereoEngine(pcfg, params, model=cfg["network"], compute_depth=True,
                          emit_confidence=cell.traffic.get("confidence", False),
                          int8=control == "int8", device=device)
    marks.append(("engine_built", time.monotonic()))
    pool = frames.make_pool(seed, cell.traffic.get("pool", 32), h, w, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    marks.append(("frame_pool", time.monotonic()))
    session = Session(cell, seed, seconds, trace, device, engine, pool, h, w, marks)
    if trace:
        session.tracer.warm()
        session.mark("tracer_warm")
    driver = importlib.import_module(f"stereobench.traffic.{cell.traffic['kind']}")
    win: Window = driver.run(session, t_start)

    # The program's state goes before the reference runs.
    samples = _materialize(win.samples)
    del engine, session.engine
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    refs = reference_outputs(cell, pool, [s.slot for s in samples], h, w, device)
    numbers = compare(samples, refs, cfg["camera"])
    ref_s = time.monotonic() - t_ref

    checks = {}
    correct = bool(samples) and bool(cell.limits) and not win.missing and win.nan_dropped == 0
    for name, limit in cell.limits.items():
        v = numbers.get(name)
        checks[name] = {"value": v, "limit": limit}
        correct = correct and v is not None and v <= limit
    result = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
              "window": win, "numbers": numbers, "checks": checks, "reference_s": ref_s,
              "samples": len(samples), "setup_phases": setup_phases(t_start, marks)}
    if trace:
        sl = session.tracer.read()
        # The frames the device worked on in the slice: where every ingest launch
        # takes the same number of frames (a backlog), the ingest launches times
        # that number (a result is handed over a batch at a time); else the
        # results handed over inside the slice.
        per_launch = win.counters.get("frames_per_launch")
        if per_launch:
            frames_in_slice = sl.launches(lambda n: INGEST_KERNEL in n) * per_launch
        else:
            frames_in_slice = session.tracer.frames_in(win.counters["done_times"])
        kind = torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else ""
        ctx = LayerContext(
            trace=sl, frames_in_slice=frames_in_slice, census=census(cell, h, w),
            ingest_bytes=ingest_bytes(h, w, cfg["preprocess"]["color_space"]),
            peaks=next((p for k, p in PEAKS.items() if k in kind), None),
            counters=win.counters)
        result["per_layer"] = per_layer_metrics(cell, ctx)
        result["trace"] = sl
        result["frames_in_slice"] = frames_in_slice
    return result


def result_line(cell: Cell, res: dict, trace: bool, device) -> dict:
    """The JSON object the run prints last; the checks' key comes last."""
    win = res["window"]
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": win.memory_peak_bytes,
    }
    if trace:
        metrics = res["per_layer"]
        device_info["busy_s"] = res["trace"].busy_s
        device_info["window_s"] = res["trace"].span_s
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in win.metrics.items()
                   if k in units}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device_info}
    if trace:
        line["breakdown"] = res["trace"].breakdown()
    line["setup_phases"] = res["setup_phases"]
    line["checks"] = res["checks"]
    return line


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="serve the network in the configuration's ``control`` precision, one "
                         "below its own (the check's control); not a benchmark run")
    ap.add_argument("--trace-names", default=None,
                    help="with --trace 1: write every device operation's seconds in the "
                         "traced slice to this JSON file")
    args = ap.parse_args(argv)

    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"stereobench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    t_start = time.monotonic() if t_start is None else t_start
    marks = [("imports", time.monotonic())]
    torch.set_num_threads(2)
    torch.zeros(1, device="cuda:0")
    marks.append(("cuda_context", time.monotonic()))
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   control=cell.config["control"] if args.control else None, t_start=t_start,
                   marks=marks)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"stereobench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    win = res["window"]
    infinite = [k for k, v in win.metrics.items() if not math.isfinite(v)]
    if infinite:
        print(f"stereobench: {infinite} not finite ({win.failed} of {win.attempted} failed)",
              file=sys.stderr)
        return 4
    line = result_line(cell, res, bool(args.trace), "cuda:0")
    print(f"stereobench: {args.workload} seed {args.seed}: power {power_limit()}; "
          f"{res['samples']} results checked in {res['reference_s']:.3f} s; readings "
          f"{json.dumps(res['numbers'])}", file=sys.stderr)
    if args.trace and args.trace_names:
        Path(args.trace_names).parent.mkdir(parents=True, exist_ok=True)
        Path(args.trace_names).write_text(json.dumps(res["trace"].breakdown(top=1000), indent=1))
    print("stereobench: set-up phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["setup_phases"].items()), file=sys.stderr)
    for k, v in win.counters.get("notes", {}).items():
        print(f"stereobench: {k}: {v}", file=sys.stderr)
    if args.trace:
        print(f"stereobench: traced slice {res['trace'].span_s:.6f} s, "
              f"{res['frames_in_slice']} frames", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line))
    return 0
