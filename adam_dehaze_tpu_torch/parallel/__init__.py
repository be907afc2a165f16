"""Multi-process and multi-device execution of the port.

Counterpart of adam_dehaze_tpu/parallel/: process groups and per-host
loading (`multihost`), the device mesh (`mesh`), the data-parallel train
and eval steps (`data_parallel`), images split over H (`spatial`), the
branches' widest stages split over channels (`sharding`), the branches on
their own device groups (`expert_parallel`), the classifier and branches
as a two-stage pipeline (`pipeline`), and the counterpart of the JAX
package's `dryrun_multichip` (`dryrun`). The exchanges that XLA's sharding
propagation writes for the JAX package are autograd Functions here
(`collectives`), and the layers' convolutions, pools and BNs reach them
through `sharded_ops`.
"""
