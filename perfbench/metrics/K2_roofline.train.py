"""K2's share of its roofline over the traced window, in %: the least time
the card could take for the work the traced calls asked of K2
(kernels/K2.py) over the device time of K2's entries in the trace."""

from perfbench import harness


def read(ctx):
    return harness.roofline_share(ctx, "K2")
