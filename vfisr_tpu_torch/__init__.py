"""PyTorch + CUDA port of ``vfisr_tpu`` for one NVIDIA H100.

The layout mirrors the JAX package (core/, data/, evaluation/, harness/,
methods/, ops/, models/, pipeline/, train/, utils/): each module here is
the counterpart of the module at the same path in ``vfisr_tpu/``, which
stays the reference; ``bench.py`` and ``benchmark.py`` are the
counterparts of the repository's ``bench.py`` and ``benchmark.py``,
``run_experiments.py`` of ``scripts/run_experiments.py``. Public functions keep the
JAX layout (NHWC, floats in [0, 1]) so the two compare like with like;
inside, modules use PyTorch idiom (``nn.Module``s, NCHW convolutions, an
explicit device). Entry points default to ``device="cuda"``.

The package imports torch, numpy and the standard library only. The
repo's one TPU kernel, the windowed warp, is two CUDA kernels in
``csrc/warp_windowed.cu``: the warp (K1) and its flow gradient (K2, the
backward of ``core/warp.py::_WindowedWarp``), built with nvcc at first use
and bound with ctypes (``ops/cuda/warp.py``). K1 is reached through the
custom op ``torch.ops.vfisr_tpu_torch.warp_windowed``, so ``torch.export``
(``utils/aot.py``) keeps it as one node of an exported program.
"""
