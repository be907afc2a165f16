"""Hand-written Hopper kernels of the port, one module each.

Every module holds a wrapper that launches its kernel on a CUDA tensor (or
raises), the plain PyTorch version of the same function (`*_reference`),
which the wrapper takes for a CPU tensor, and a launch counter on the
wrapper (`wrapper.launches`, one per kernel launch). A CUDA graph replays
its kernels without passing through their wrappers: `captured_launches`
reads what a capture enqueued, and the replay adds it (serving_export.py).
"""
from contextlib import contextmanager


def launch_counters() -> dict:
    """Every kernel wrapper that counts its launches, by kernel name: K1
    (low-branch chain), K2 and K2' (CBAM gates), K3 and K4 (tail chains),
    K5 (three-way blend), K6 (res/attention segment chain), the int8
    serving path's Q1 (per-image quantize; on an H shard its two passes,
    the abs-max and the quantizing at a given abs-max) and Q2 (int8 conv)
    and the operation probes."""
    from adam_dehaze_tpu_torch.ops.kernels.blend import blend3
    from adam_dehaze_tpu_torch.ops.kernels.cbam import (
        channel_spatial_gate,
        spatial_gate,
    )
    from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
        lightweight_chain,
    )
    from adam_dehaze_tpu_torch.ops.kernels.quant import (
        image_absmax,
        int8_conv,
        quantize_images,
        quantize_images_at,
    )
    from adam_dehaze_tpu_torch.ops.kernels.res_chain import res_attn_chain
    from adam_dehaze_tpu_torch.ops.kernels.tail_chain import (
        high_tail_chain,
        medium_tail_chain,
    )
    from adam_dehaze_tpu_torch.tools.probe_ops import probe_op
    return {"lightweight_chain": lightweight_chain,
            "cbam_gate": channel_spatial_gate, "spatial_gate": spatial_gate,
            "medium_tail_chain": medium_tail_chain,
            "high_tail_chain": high_tail_chain, "blend3": blend3,
            "res_attn_chain": res_attn_chain, "int8_quantize": quantize_images,
            "int8_absmax": image_absmax, "int8_quantize_at": quantize_images_at,
            "int8_conv": int8_conv, "probe_ops": probe_op}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0 (and Q2's per body)."""
    for fn in launch_counters().values():
        fn.launches = 0
        for body in getattr(fn, "body_launches", {}):
            fn.body_launches[body] = 0


@contextmanager
def captured_launches():
    """Around a CUDA graph capture: yields a list that is filled, on exit,
    with (wrapper, launches) for every kernel the capture enqueued, and
    sets the counters back, since a capture runs nothing. Each replay of
    the graph adds those launches (`add_launches`)."""
    counters = launch_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    captured = []
    try:
        yield captured
    finally:
        for name, fn in counters.items():
            if fn.launches > before[name]:
                captured.append((fn, fn.launches - before[name]))
            fn.launches = before[name]


def add_launches(captured) -> None:
    """Count the launches of one replay of a captured graph."""
    for fn, n in captured:
        fn.launches += n
