"""ADAM-Dehaze ported to PyTorch and CUDA.

The counterpart of `adam_dehaze_tpu`, module by module and name by name.
Public functions take and return NHWC float images in [0, 1], as the JAX
package does. The hand-written Hopper kernels live in `ops/kernels/` (CUDA
C++ sources in `csrc/`, built on first use); on a CPU tensor every kernel
wrapper takes its plain PyTorch version instead.
"""
