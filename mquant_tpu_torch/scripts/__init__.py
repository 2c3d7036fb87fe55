"""Probes of the port on the card: ``prefill_probe`` (the per-segment
breakdown of one prefill layer) and ``mxu_rate`` (the int8 / bf16 matmul
rate), with the CUDA-graph timing helper they share (``timing``)."""
