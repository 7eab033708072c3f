"""Device time of the network's convolution kernels (cuDNN's, and the int8 conv
where it runs) in the traced slice, a frame the device worked on in the slice
(ms)."""

# cuDNN's convolution kernels and its layout and padding helpers (the networks
# use cuDNN for nothing else), and the int8 conv.
PATTERNS = ("fprop", "convolve", "implicit_gemm", "cudnn", "winograd", "nhwcAddPadding",
            "nchwToNhwc", "nhwcToNchw", "int8_conv")


def is_conv(name: str) -> bool:
    return any(p in name for p in PATTERNS)


def read(ctx):
    if ctx.trace is None or not ctx.frames_in_slice:
        return None
    t = ctx.trace.device_time(is_conv)
    return t * 1e3 / ctx.frames_in_slice if t > 0 else None
