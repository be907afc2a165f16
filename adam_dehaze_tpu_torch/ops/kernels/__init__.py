"""Hand-written Hopper kernels of the port, one module each.

Every module holds a wrapper that launches its kernel on a CUDA tensor (or
raises), the plain PyTorch version of the same function (`*_reference`),
which the wrapper takes for a CPU tensor, and a launch counter on the
wrapper (`wrapper.launches`, one per kernel launch).
"""


def reset_launch_counts() -> None:
    """Set the launch counters of K1 (low-branch chain), K2 (CBAM gate) and
    K5 (three-way blend) to 0."""
    from adam_dehaze_tpu_torch.ops.kernels.blend import blend3
    from adam_dehaze_tpu_torch.ops.kernels.cbam import channel_spatial_gate
    from adam_dehaze_tpu_torch.ops.kernels.lightweight_chain import (
        lightweight_chain,
    )
    for fn in (lightweight_chain, channel_spatial_gate, blend3):
        fn.launches = 0
