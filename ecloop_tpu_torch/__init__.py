"""ecloop_tpu_torch: the PyTorch/CUDA port of ecloop-tpu.

The `add`, `rnd` and `mul` searches run end to end on an NVIDIA H100
through three kernels written by hand in CUDA C++ (`csrc/`): the hash160
pipeline, the batched modular inversion and the `mul` window add; the
checkpoint and the bloom-filter commands run on the host.  Every kernel
has a plain torch version in the module that wraps it; a CPU tensor
takes the plain version, a CUDA tensor launches the kernel.  The JAX
package `ecloop_tpu` is the reference the port is held against.
Submodules are imported on demand.
"""

__version__ = "0.1.0"
