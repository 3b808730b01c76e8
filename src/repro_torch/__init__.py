"""PyTorch + CUDA port of the Edgent reproduction, for NVIDIA Hopper.

Mirrors the JAX package ``repro`` path for path.  Plain tensor code is
PyTorch; each Pallas TPU kernel of the reference is a CUDA C++ kernel under
``kernels/csrc/``, built with ``nvcc`` at first use (see
``repro_torch.kernels.build``).
"""
