"""The NV12 ingest kernel's share of its roofline (%): the census's ingest bytes
(the frame's NV12 read once, the model input written once) of the frames the
device worked on in the traced slice (its ingest launches), over the card's HBM
bandwidth, divided by the summed time of ``nv12_ingest_kernel`` in the slice."""

KERNEL = "nv12_ingest_kernel"


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.frames_in_slice:
        return None
    t = ctx.trace.device_time(lambda n: KERNEL in n)
    if t <= 0:
        return None
    return 100.0 * ctx.ingest_bytes * ctx.frames_in_slice / ctx.peaks["hbm_bytes_s"] / t
