"""Hand-written Hopper kernels of the port, one module each.

Every module holds a wrapper that launches its kernel on a CUDA tensor (or
raises), the plain PyTorch version of the same function (`*_reference`),
which the wrapper takes for a CPU tensor, and a launch counter on the
wrapper (`wrapper.launches`, one per kernel launch).
"""


def launch_counters() -> dict:
    """Every kernel wrapper that counts its launches, by kernel name: K1
    (low-branch chain), K2 and K2' (CBAM gates), K3 and K4 (tail chains),
    K5 (three-way blend), K6 (res/attention segment chain) and the
    operation probes."""
    from adam_dehaze_tpu_torch.ops.kernels.blend import blend3
    from adam_dehaze_tpu_torch.ops.kernels.cbam import (
        channel_spatial_gate,
        spatial_gate,
    )
    from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
        lightweight_chain,
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
            "res_attn_chain": res_attn_chain, "probe_ops": probe_op}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for fn in launch_counters().values():
        fn.launches = 0
