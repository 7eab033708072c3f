"""The whole step's share of the card's bf16 dense peak (%): the census's
convolution FLOPs of the frames the device worked on in the traced slice,
divided by the slice's seconds times the peak."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.frames_in_slice or ctx.trace.span_s <= 0:
        return None
    return (100.0 * ctx.census.conv_flops * ctx.frames_in_slice
            / (ctx.trace.span_s * ctx.peaks["bf16_flops"]))
