#!/usr/bin/env python3
"""Where the artifact's serving time goes, against the live engine's, on one card.

    python3 scripts/torch_artifact_overhead.py

Exports the flagship (its config and committed weights, 1280x720, buckets
1 and 8, platform cuda) in bf16 into ``build/artifact_probe/`` (and later
in int8 static), then times, at batch 1 and 8 on host frames, each synchronised and as the median of 20
calls (ms): the host's batch assembly (stack, copy into pinned memory,
copy to the card), the artifact's graph on a batch already on the card,
``StereoEngine.pipeline`` on the same batch, the copy of disparity and
depth to the host, the host's check that every value is finite, and
``CompiledStereoArtifact.run_nv12`` end to end; then ``ArtifactEngine``
against ``StereoEngine`` on host frames, in bf16 and in int8 static
(``checkpoints/flagship/calib.json``): at each batch, :data:`ROUNDS` rounds
of :data:`FPS_FRAMES` frames an engine, the two engines in turns
(``runtime.benchmark.fps_in_turns``), each round's frames/s and the median
of the rounds' ratios.  Prints one JSON line; about 4 minutes on one card.
Needs CUDA; imports torch, numpy and the port only.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
H, W = 720, 1280
BUCKETS = (1, 8)
REPS = 20
FPS_FRAMES = {1: 512, 8: 1024}   # frames an engine serves in a round, by batch
ROUNDS = 5


def median_ms(fn, sync) -> float:
    fn()
    sync()
    times = []
    for _ in range(REPS):
        t = time.perf_counter()
        fn()
        sync()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_artifact_overhead: needs CUDA", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from hobot_stereonet_tpu_torch import reference
    from hobot_stereonet_tpu_torch.config import Config
    from hobot_stereonet_tpu_torch.runtime.artifact import (
        ArtifactEngine, CompiledStereoArtifact, export_artifact)
    from hobot_stereonet_tpu_torch.runtime.benchmark import fps_in_turns
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=10).stdout.strip()
    dev = torch.device("cuda:0")
    cfg = Config.from_json(str(ROOT / "checkpoints" / "flagship" / "config.json"))
    trained = reference.load_params()
    out = ROOT / "build" / "artifact_probe"
    out.mkdir(parents=True, exist_ok=True)
    path = str(out / "bf16.stereoblob")
    t = time.monotonic()
    export_artifact(path, "fast", trained, cfg, buckets=BUCKETS, platforms=("cuda",))
    export_s = time.monotonic() - t
    art = CompiledStereoArtifact(path)
    eng = StereoEngine(cfg, params=trained)
    frames = np.random.default_rng(0).integers(0, 256, (max(BUCKETS), 3 * H * W), dtype=np.uint8)
    sync = torch.cuda.synchronize
    report = {"card": card, "export_s": export_s, "ms": {}, "fps": {}}
    for b in BUCKETS:
        host = [frames[i] for i in range(b)]
        batch = torch.from_numpy(np.stack(host)).to(dev)
        disp, depth = art.call_nv12_async(batch)
        graph = art._entry("nv12", b)

        def assemble():
            return torch.from_numpy(np.stack(host)).pin_memory().to(dev, non_blocking=True)

        def to_host():
            return disp.to("cpu", non_blocking=True), depth.to("cpu", non_blocking=True)

        d_host = disp.cpu().numpy()
        with torch.inference_mode():
            report["ms"][b] = {
                "assemble": median_ms(assemble, sync),
                "artifact graph": median_ms(lambda: graph(batch), sync),
                "engine pipeline": median_ms(lambda: eng.pipeline(batch), sync),
                "to host": median_ms(to_host, sync),
                "host isfinite": median_ms(lambda: np.isfinite(d_host).all(axis=(1, 2)),
                                           lambda: None),
                "run_nv12": median_ms(lambda: art.run_nv12(np.stack(host)), sync),
            }
    del eng
    art.close()
    static = str(ROOT / "checkpoints" / "flagship" / "calib.json")
    for name, quant in (("bf16", {}), ("int8 static", {"static_quant": static})):
        if quant:
            path = str(out / "int8_static.stereoblob")
            export_artifact(path, "fast", trained, cfg, buckets=BUCKETS, platforms=("cuda",),
                            **quant)
        art = CompiledStereoArtifact(path)
        report["fps"][name] = {}
        for b in BUCKETS:
            a = ArtifactEngine(art, max_batch=b, drop_on_full=False)
            a.warmup()
            e = StereoEngine(dataclasses.replace(cfg, engine=dataclasses.replace(
                cfg.engine, max_batch=b, drop_on_full=False)), params=trained, **quant)
            e.warmup(buckets=[b])
            runs = fps_in_turns({"ArtifactEngine": a, "StereoEngine": e}, frames,
                                FPS_FRAMES[b], rounds=ROUNDS)
            ratios = [x / y for x, y in zip(runs["ArtifactEngine"], runs["StereoEngine"])]
            report["fps"][name][b] = dict(runs, frames=FPS_FRAMES[b],
                                          median_ratio=statistics.median(ratios))
            del a, e
        art.close()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
