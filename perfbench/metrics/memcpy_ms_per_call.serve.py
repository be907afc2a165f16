"""Device time of host-to-device and device-to-host copies a call, in ms,
from the trace."""


def read(ctx):
    return ctx.trace.memcpy_s() * 1e3 / ctx.calls
