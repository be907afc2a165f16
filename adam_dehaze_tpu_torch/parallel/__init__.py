"""Multi-process and multi-device execution of the port.

Counterpart of adam_dehaze_tpu/parallel/: process groups and per-host
loading (`multihost`), the device mesh (`mesh`), the data-parallel train
and eval steps (`data_parallel`), the branches on their own device groups
(`expert_parallel`) and the classifier and branches as a two-stage
pipeline (`pipeline`). `spatial.py` and `sharding.py` (the `spatial` and
`model` mesh axes) are not ported yet.
"""
