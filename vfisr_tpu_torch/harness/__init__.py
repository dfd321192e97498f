"""The experiment sweep and the triplet benchmark (port of ``vfisr_tpu/harness/``)."""
