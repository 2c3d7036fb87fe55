"""Probes of the port on the card: ``prefill_probe`` (the per-segment
breakdown of one prefill layer), ``mxu_rate`` (the int8 / bf16 matmul
rate), the decode-rate probes ``gemv_bench`` (GEMVs at M ≤ 8),
``w4_unpack_tune`` (the packed-W4 unpack variants) and ``mlp_variants``
(the MLP block in bf16, int8 and fp8, and its fused epilogue), with the
CUDA-graph timing helper they share (``timing``)."""
