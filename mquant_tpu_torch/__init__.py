"""PyTorch / CUDA port of mquant_tpu's W4A8 serving path for NVIDIA Hopper.

The JAX package ``mquant_tpu`` is the reference; this package mirrors its
layout (core/, transform/, kernels/, models/, serve/) and imports no JAX.
The int8 products, the attention and the Hadamard / norm → int8 passes run
in hand-written CUDA kernels (kernels/csrc/), built at first use with nvcc
for sm_90a. scripts/ holds the probes (prefill segments, int8 rate);
``python -m mquant_tpu_torch.bench`` measures W4A8 against bf16 as the
repository's bench.py does.
"""
