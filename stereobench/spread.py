"""Run one cell several times, one process a run, and print each run's result
line and the spread of each metric.

    python3 stereobench/spread.py --workload <cell> --seeds 11,12,13 --seconds 10 \
        [--trace 0|1] [--control] [--out FILE]

Runs ``stereobench/run.py`` once per seed, one after another on this machine.
The spread of a metric is the distance between its first and third quartile
(``statistics.quantiles(values, n=4)``) as a share of its median.  With
``--out`` every run's result line, exit code and the end of its standard error
are appended to FILE as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# A run exits within 360 s (1200 s for a checkout's first, which builds the kernels).
RUN_TIMEOUT_S = 1200
sys.path.insert(0, os.path.dirname(HERE))

from stereobench.stats import spread  # noqa: E402


def one_run(workload: str, seed: int, seconds: float, trace: int, control, extra=()) -> dict:
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", workload, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace), *extra]
    if control:
        cmd.append("--control")
    t = time.monotonic()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=os.path.dirname(HERE),
                           timeout=RUN_TIMEOUT_S)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", (e.stderr or "") + "\n[spread] run timed out"
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    lines = out.strip().splitlines()
    line = json.loads(lines[-1]) if rc == 0 and lines else None
    return {"workload": workload, "seed": seed, "seconds": seconds, "trace": trace,
            "control": control, "rc": rc, "wall_s": time.monotonic() - t,
            "line": line, "stderr_tail": err[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", action="store_true",
                    help="serve the configuration's control precision (run.py --control)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-names", default=None,
                    help="with --trace 1: a directory for each run's device operation totals")
    args = ap.parse_args(argv)

    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        extra = ()
        if args.trace_names:
            extra = ("--trace-names", os.path.join(args.trace_names,
                                                   f"{args.workload}-{seed}.json"))
        r = one_run(args.workload, seed, args.seconds, args.trace, args.control, extra)
        runs.append(r)
        line = r["line"]
        print(f"{args.workload} seed {seed} rc {r['rc']} wall {r['wall_s']:.1f} s: "
              f"{json.dumps(line) if line else r['stderr_tail'][-1500:]}", flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    good = [r["line"] for r in runs if r["line"]]
    for name in sorted({k for line in good for k in line["metrics"]}):
        values = [line["metrics"][name]["value"] for line in good if name in line["metrics"]]
        if len(values) >= 2:
            print(f"{args.workload} {name}: values {values}; spread {spread(values):.6f}")
    return 0 if len(good) == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
