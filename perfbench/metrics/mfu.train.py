"""Model FLOP utilisation of training, in % of the card's dense peak in the
configuration's precision: the model FLOPs of a step (forward and backward,
counted on the reference step) times the timed window's steps, over the
window's seconds."""


def read(ctx):
    w = ctx.window
    return 100.0 * ctx.flops["step"] * w["steps"] / w["elapsed_s"] / ctx.peak_flops()
