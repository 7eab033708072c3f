"""The check end to end on the CPU at a small size: a sound run is correct, and
each fault the cells can have, planted under the timed path, makes it not.

The harness's look for a card is skipped: ``harness.run_cell`` runs on the CPU
with the program's plain kernels, a small geometry and small batches.
"""

import time

import pytest
import torch

from stereobench import harness

H, W = 64, 128


CELLS = ["fast-bf16-offline-b32", "classic-bf16-offline-b32"]


def _cell(name):
    cell = harness.find_cell(name)
    t = cell.traffic
    t["engine"] = dict(t["engine"], max_batch=4, feed_queue_depth=8, inflight=1,
                       batch_buckets=[1, 4])
    t.update(pool=8, preroll_s=0.2, samples=4, trace_slice_s=0.0, wait_after_s=20.0,
             warmup_buckets=[1, 4])
    return cell


def _run(cell, seed=7, control=None):
    return harness.run_cell(cell, seed, 1.5, False, "cpu", control=control, height=H, width=W,
                            t_start=time.monotonic())


def _fault(monkeypatch, kind):
    from hobot_stereonet_tpu_torch.runtime.engine import StereoEngine

    real = StereoEngine.pipeline
    last = {}

    def broken(self, sbs):
        outs = list(real(self, sbs))
        b = outs[0].shape[0]
        if kind == "answer_altered":            # every frame's disparity, as produced
            outs[0] = outs[0] + 2.0
        elif kind == "half_batch_left_out":     # the second half copies the first
            h = max(1, b // 2)
            outs = [None if o is None else torch.cat([o[:h]] * (-(-b // h)))[:b] for o in outs]
        elif kind == "state_unchanged":         # every batch returns the first batch's maps
            if "outs" not in last:
                last["outs"] = [None if o is None else o.clone() for o in outs]
            outs = [None if o is None else o[:1].expand_as(n).clone() if n is not None else None
                    for o, n in zip(last["outs"], outs)]
        return tuple(outs)

    monkeypatch.setattr(StereoEngine, "pipeline", broken)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(_cell(name))
    assert res["correct"], res["checks"]
    assert res["samples"] >= 1 and not res["window"].missing


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("kind", ["answer_altered", "half_batch_left_out", "state_unchanged"])
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, name, kind):
    _fault(monkeypatch, kind)
    cell = _cell(name)
    cell.traffic["samples"] = 12
    res = _run(cell)
    assert not res["correct"], res["checks"]


def test_a_result_that_never_comes_is_not_correct(monkeypatch):
    from hobot_stereonet_tpu_torch.runtime import serving

    real = serving.ServingLoop.poll

    def lossy(self, timeout=None):
        res = real(self, timeout)
        return None if res is not None and res.index % 5 == 3 else res

    monkeypatch.setattr(serving.ServingLoop, "poll", lossy)
    cell = _cell("fast-bf16-offline-b32")
    cell.traffic["wait_after_s"] = 1.0
    res = _run(cell)
    assert res["window"].missing and not res["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_lower_precision_control_is_not_correct(name):
    cell = _cell(name)
    res = _run(cell, control=cell.config["control"])
    assert not res["correct"], res["checks"]
