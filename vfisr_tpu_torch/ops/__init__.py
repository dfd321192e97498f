"""Analysis ops and the hand-written kernels (``ops/cuda``)."""
