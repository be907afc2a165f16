"""Model FLOP utilisation of serving, in % of the card's dense peak in the
configuration's precision: the model FLOPs of the work the timed window's
calls asked for (the classifier on every image and each image's own branch,
counted on the reference; padding rows do not count) over the window's
seconds."""


def read(ctx):
    w, f = ctx.window, ctx.flops
    levels = ctx.traffic["levels"]
    work = sum(n * (f["classifier"] + f[lvl]) for lvl, n in zip(levels, w["images_by_level"]))
    return 100.0 * work / w["elapsed_s"] / ctx.peak_flops() if w["elapsed_s"] > 0 else None
