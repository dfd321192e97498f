"""Scale-out over torch.distributed (port of ``vfisr_tpu/parallel/``)."""
