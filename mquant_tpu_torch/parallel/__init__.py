"""Multi-GPU layer (counterpart of ``mquant_tpu/parallel``): Megatron tensor
parallelism over ``torch.distributed`` (:mod:`.sharding`, :mod:`.collectives`)."""
