"""Training (port of ``vfisr_tpu/train``): losses, the optimizer and train
step (``train.py``), on-device synthetic scenes (``device_data.py``) and the
CLI (``python -m vfisr_tpu_torch.train``)."""
