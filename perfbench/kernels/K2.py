"""K2, CBAM's channel and spatial gate (`channel_spatial_gate`: the
statistics pass and the gate kernel): its work over the traced window, from
shapes.

Every AttentionBlock's input shape comes from the reference branch on the
meta device. Bytes: x read once and the output written once in the compute
dtype, the channel gate (f32, a value per image and channel) read once, the
7x7x2 stencil (f32) once a block; the kernel's own second read of x is not
counted. Operations: two multiplies and the mean and max a value, and the
7x7 stencil over the two maps; against the f32 peak (no tensor cores)."""

import torch

COUNTER = "cbam_gate"
TRACE_NAMES = ("cbam_gate_kernel", "gated_maps_kernel")
ENTRIES_PER_LAUNCH = 2      # the statistics pass, then the gate kernel


def block_shapes(port: dict, level: str):
    """(C, H, W) of each AttentionBlock's input in one image's pass through
    the branch of `level`."""
    from perfbench.reference.layers import AttentionBlock
    from perfbench.reference.models import Router
    side = port["dataset"]["img_size"]
    shapes = []
    with torch.device("meta"):
        branch = Router(port).models[level].eval()
        hooks = [m.register_forward_pre_hook(lambda m, a: shapes.append(tuple(a[0].shape[1:])))
                 for m in branch.modules() if isinstance(m, AttentionBlock)]
        with torch.no_grad():
            branch(torch.empty(1, side, side, 3))
        for h in hooks:
            h.remove()
    return shapes


def work(ctx):
    esize = 2 if ctx.config["precision"] == "bf16" else 4
    flops = nbytes = 0
    for level, n in ctx.images_by_branch.items():
        shapes = block_shapes(ctx.config["port"], level) if n else []
        for c, h, w in shapes:
            nbytes += n * (2 * c * h * w * esize + 4 * c) + 7 * 7 * 2 * 4
            flops += n * (4 * c * h * w + 2 * h * w * 49 * 2)
    if not nbytes:
        return None
    return {"flops": flops, "bytes": nbytes, "peak": "fp32"}
