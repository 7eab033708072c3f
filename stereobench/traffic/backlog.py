"""Backlogged traffic: frames already on the card, always more than the engine
takes.

The frame pool is written into a device frame ring (``data/stream.py::
DeviceFrameRing``'s buffer, without its host generator); a feeder thread
feeds ring slots as fast as the engine accepts them (``drop_on_full`` false:
a feed waits while the queue is full).  Results stay on the card
(``fetch_results`` false).  After the warm-up of the mix's buckets and a
pre-roll, the window counts the results handed to the consumer inside it.

The check holds a sample of the window's results, drawn from the seed by
reservoir sampling as they come (device views: no copy in the window).  After
the window every frame the engine accepted has to come back within
``wait_after_s``; one that does not is missing.

Parameters: ``engine`` (the engine's settings), ``warmup_buckets``,
``preroll_s``, ``samples``, ``wait_after_s`` and ``trace_slice_s`` (the
traced slice ends with the window).
"""

from __future__ import annotations

import resource
import threading
import time


def device_ring(pool, height: int, width: int):
    """A ``DeviceFrameRing`` whose slots are the pool's frames."""
    from hobot_stereonet_tpu_torch.data.stream import DeviceFrameRing

    ring = DeviceFrameRing.__new__(DeviceFrameRing)
    ring.device, ring.height, ring.width = pool.device, height, width
    ring.data = pool
    ring._gt = [None] * pool.shape[0]
    ring.ready = None
    if pool.device.type == "cuda":
        import torch

        ring.ready = torch.cuda.Event()
        ring.ready.record(torch.cuda.current_stream(pool.device))
    return ring


def run(s, t_start: float):
    from stereobench.harness import Consumer, Sample, Window
    from hobot_stereonet_tpu_torch.data.stream import Frame, RingSlot

    p, eng = s.traffic, s.engine
    ring = device_ring(s.pool, s.height, s.width)
    eng.warmup(buckets=p["warmup_buckets"], ring=ring)
    s.mark("warmup")

    want = p["samples"]
    reservoir, seen = [], [0]
    window = [None, None]

    def keep(res, t):
        if window[0] is None or not window[0] <= t < window[1]:
            return
        seen[0] += 1
        item = Sample(res.index, s.slot(res.index), res.disparity, res.depth_m, res.confidence)
        if len(reservoir) < want:
            reservoir.append(item)
        else:
            j = int(s.rng.integers(0, seen[0]))
            if j < want:
                reservoir[j] = item

    consumer = Consumer(eng, keep, s.span)
    stop = threading.Event()

    accepted = []

    def feeder():
        i = 0
        while not stop.is_set():
            with s.span("stereobench::feed"):
                if eng.feed(Frame(time.monotonic(), RingSlot(ring, s.slot(i)), s.height,
                                  2 * s.width, None, i)):
                    accepted.append(i)
            i += 1

    feed_thread = threading.Thread(target=feeder, name="stereobench-feeder", daemon=True)
    eng.start(warmup=False)
    consumer.start()
    feed_thread.start()
    if not consumer.first.wait(120.0):
        raise TimeoutError("no result within 120 s of the start")
    s.mark("first_result")
    time.sleep(p["preroll_s"])

    t0 = s.mark("preroll")
    window[:] = [t0, t0 + s.seconds]
    nan0 = eng.metrics.nan_dropped
    setup_s = t0 - t_start
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    s.tracer.run_slice(t0 + s.seconds, p["trace_slice_s"])
    time.sleep(max(0.0, window[1] - time.monotonic()))
    t1 = time.monotonic()
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    nan_in_window = eng.metrics.nan_dropped - nan0
    stop.set()
    feed_thread.join(60.0)
    eng.drain(timeout=120.0)
    peak = s.memory_peak()
    deadline = time.monotonic() + p["wait_after_s"]
    while (len(consumer.done) + eng.metrics.nan_dropped < len(accepted)
           and time.monotonic() < deadline):
        time.sleep(0.01)
    consumer.stop()
    eng.stop()
    s.tracer.stop()
    if feed_thread.is_alive():
        raise TimeoutError("the feeder did not stop")

    completed = consumer.completed_between(t0, t1)
    per_second = [consumer.completed_between(t0 + k, min(t0 + k + 1, t1))
                  for k in range(int(s.seconds))]
    return Window(
        metrics={"fps": completed / (t1 - t0), "setup_s": setup_s},
        attempted=completed + nan_in_window, failed=nan_in_window,
        samples=reservoir, missing=[k for k in accepted if k not in consumer.done],
        nan_dropped=eng.metrics.nan_dropped, memory_peak_bytes=peak,
        counters={"done_times": list(consumer.done.values()),
                  "frames_per_launch": (eng.cfg.engine.device_microbatch
                                        or p["engine"]["max_batch"]),
                  "notes": {
                      "results each second of the window": per_second,
                      "host in the window": (
                          f"user {use1.ru_utime - use0.ru_utime:.3f} s, system "
                          f"{use1.ru_stime - use0.ru_stime:.3f} s, context switches "
                          f"{use1.ru_nvcsw - use0.ru_nvcsw} voluntary, "
                          f"{use1.ru_nivcsw - use0.ru_nivcsw} involuntary")}})
