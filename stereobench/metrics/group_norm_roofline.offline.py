"""The GroupNorm kernels' share of their roofline (%): the census's GroupNorm
bytes (input, residual input and output, once each) of the frames the device
worked on in the traced slice, over the card's HBM bandwidth, divided by the
summed time of the ``group_norm_*`` kernels in the slice."""

PATTERN = "group_norm_"


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.frames_in_slice:
        return None
    t = ctx.trace.device_time(lambda n: PATTERN in n)
    if t <= 0:
        return None
    return 100.0 * ctx.census.group_norm_bytes * ctx.frames_in_slice / ctx.peaks["hbm_bytes_s"] / t
