"""K1, the low branch's fused chain (`lightweight_chain`): its work over the
traced window, from shapes.

Operations: the low branch's convolutions, counted by FlopCounterMode on the
reference's low branch (a multiply-add is two). Bytes: each image read once
in float32 and its output written once in float32, and the chain's weights
once. Only the `lightweight` low branch runs K1."""

COUNTER = "lightweight_chain"
TRACE_NAMES = ("lightweight_group_kernel", "conv3x3_kernel")
ENTRIES_PER_LAUNCH = 1


def work(ctx):
    port = ctx.config["port"]
    n = ctx.images_by_branch.get("low", 0)
    if port["dehazing"]["low"]["model_type"] != "lightweight" or not n:
        return None
    side = port["dataset"]["img_size"]
    c, blocks = port["dehazing"]["low"]["channels"], port["dehazing"]["low"]["blocks"]
    esize = 2 if ctx.config["precision"] == "bf16" else 4
    # 3->c, 2 c->c a block, c->c, c->3: 3x3 taps, and a shift per output channel.
    convs = [(3, c)] + [(c, c)] * (2 * blocks) + [(c, c), (c, 3)]
    weights = sum(9 * a * b * esize + 4 * b for a, b in convs)
    return {"flops": n * ctx.flops["low"], "bytes": n * 2 * side * side * 3 * 4 + weights,
            "peak": ctx.config["precision"]}
