"""tpumd_torch: the tpu-md molecular-dynamics engine on PyTorch and CUDA.

A port of the JAX package ``tpumd`` to one NVIDIA H100.  It reads the same
LAMMPS-dialect decks; plain tensor code is PyTorch, and each TPU kernel of
``tpumd`` becomes a CUDA kernel in ``tpumd_torch/csrc``, built with nvcc at
first use.  The package imports torch and numpy, never jax or tpumd.
"""
