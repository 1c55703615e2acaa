"""ecloop_tpu_torch: the PyTorch/CUDA port of ecloop-tpu.

The `add` search runs end to end on an NVIDIA H100 through two kernels
written by hand in CUDA C++ (`csrc/`): the hash160 pipeline and the
batched modular inversion.  Every kernel has a plain torch version in
the module that wraps it; a CPU tensor takes the plain version, a CUDA
tensor launches the kernel.  The JAX package `ecloop_tpu` is the
reference the port is held against.  Submodules are imported on demand.
"""

__version__ = "0.1.0"
