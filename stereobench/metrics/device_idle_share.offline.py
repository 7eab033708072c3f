"""Share of the traced slice in which no operation ran on the device (%): one
minus the union of the device's intervals over the slice."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_share()
