"""Device kernels a call in the trace, the library's (cuDNN's) included."""


def read(ctx):
    return len(ctx.trace.kernels()) / ctx.calls
