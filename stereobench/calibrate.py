"""Readings of the check's numbers over many seeds in one process: the program
as the cell's configuration states it, and the lower-precision control.

    python3 stereobench/calibrate.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 21,22,23 --seconds 3 [--out FILE]

Each seed is one whole run of the cell (set-up, a window of ``--seconds`` at
the cell's own load, the check) by ``harness.run_cell``; the control serves
the network in int8 (``StereoEngine(int8=True)``, the program's own path one
precision below bf16).  Prints, for each number, the lower reading (the
largest over the sound seeds), the upper reading (the smallest over the
control's seeds), their ratio and a limit 60 % of the way from the lower to
the upper reading, where the upper is three times the lower or more; with
``--write-limits`` those limits become the cell's (``limits/<cell>.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from stereobench import harness  # noqa: E402


def readings(cell, seeds, seconds, control, out, device="cuda:0", **geometry):
    rows = []
    for seed in seeds:
        t = time.monotonic()
        res = harness.run_cell(cell, seed, seconds, False, device, control=control, t_start=t,
                               **geometry)
        row = {"seed": seed, "control": control, "correct": res["correct"],
               "attempted": res["attempted"], "failed": res["failed"],
               "numbers": res["numbers"], "samples": res["samples"],
               "metrics": res["window"].metrics, "wall_s": time.monotonic() - t}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(dict(row, workload=cell.name)) + "\n")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--write-limits", action="store_true",
                    help="write limits/<cell>.json: every number but the worst-frame ones "
                         "whose upper reading is three times its lower or more")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    cell = harness.find_cell(args.workload)
    sound = readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds, None, args.out)
    ctrl = readings(cell, [int(s) for s in args.control_seeds.split(",")], args.seconds,
                    cell.config["control"], args.out)
    limits = {}
    for name in sorted(sound[0]["numbers"]):
        lower = max(r["numbers"][name] for r in sound)
        upper = min(r["numbers"][name] for r in ctrl)
        ratio = upper / lower if lower > 0 else float("inf")
        limit = lower + 0.6 * (upper - lower) if ratio >= 3 else None
        print(f"{cell.name} {name}: lower {lower!r} upper {upper!r} ratio {ratio:.3f} "
              f"limit {limit!r}")
        if limit is not None and not name.endswith("_worst"):
            limits[name] = limit
    if args.write_limits:
        path = harness.HERE / "limits" / f"{cell.name}.json"
        path.write_text(json.dumps(limits, indent=2) + "\n")
        print(f"wrote {path}: {limits}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
