"""The numbers that decide ``correct``: the program's results against the plain
reference's, over the frames checked.

  * ``disp_mae_px``: mean |program disparity - reference disparity| over every
    pixel of every frame checked (px); ``disp_mae_px_worst``: the same of the
    worst frame;
  * ``disp_bad1_pct``: share of those pixels more than 1 px off (%);
    ``disp_bad1_pct_worst``: the same of the worst frame;
  * ``depth_mae_px`` and ``depth_bad1_pct``: the same of the program's depth
    turned back into disparity, f * B / (1000 * depth), against the
    reference's disparity: they hold the depth to the reference;
  * ``conf_mae``: mean |program confidence - reference confidence|, and
    ``conf_bad2_pct`` / ``conf_bad5_pct``: the share of confidences more than
    0.02 / 0.05 off (%), where the cell's results carry the confidence.

A NaN reads as infinite, which no limit holds.
"""

from __future__ import annotations

import collections
import math


def compare(samples, refs: dict, camera: dict) -> dict:
    """The numbers of ``samples`` (materialized ``harness.Sample``) against
    ``refs`` ({slot: (disparity, confidence)})."""
    fb = camera["focal_px"] * camera["baseline_mm"]
    per = collections.defaultdict(list)

    def gaps(prefix, gap, bad):
        per[prefix + "_mae" + ("_px" if prefix != "conf" else "")].append(float(gap.mean()))
        for threshold, name in bad:
            per[name].append(float((gap > threshold).double().mean()) * 100.0)

    for s in samples:
        d_ref, c_ref = refs[s.slot]
        gaps("disp", (s.disparity.double() - d_ref.double()).abs(), [(1.0, "disp_bad1_pct")])
        if s.depth is not None:
            back = fb / (1000.0 * s.depth.double())
            gaps("depth", (back - d_ref.double()).abs(), [(1.0, "depth_bad1_pct")])
        if s.confidence is not None:
            gaps("conf", (s.confidence.double() - c_ref.double()).abs(),
                 [(0.02, "conf_bad2_pct"), (0.05, "conf_bad5_pct")])
    out = {}
    for name, values in per.items():
        if not values:
            continue
        values = [math.inf if v != v else v for v in values]
        out[name] = sum(values) / len(values)
        if name.startswith("disp_"):
            out[name + "_worst"] = max(values)
    return out
