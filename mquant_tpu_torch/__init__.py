"""PyTorch / CUDA port of mquant_tpu's W4A8 serving path for NVIDIA Hopper.

The JAX package ``mquant_tpu`` is the reference; this package mirrors its
layout (core/, transform/, kernels/, models/, serve/) and imports no JAX.
The int8 products and the fused MLP tail run in hand-written CUDA kernels
(kernels/csrc/), built at first use with nvcc for sm_90a.
"""
