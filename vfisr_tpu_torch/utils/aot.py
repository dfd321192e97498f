"""Fixed-shape export of a model's interpolation program (port of
``vfisr_tpu/utils/aot.py``), the deployment artifact that stands in for the
reference's TensorRT engine (``scripts/convert_tensorrt.py``).

- ``build_interpolate_fn`` loads a registry model (in bf16 where its config
  has a dtype, ``precision="bf16"``) and returns its batched device core,
  ``interpolate_batch`` at a fixed timestep set, as a module.
- ``export_interpolate`` traces it with ``torch.export.export`` at a fixed
  [pairs, H, W, 3] f32 input and serializes the program with
  ``torch.export.save``: a ``.pt2`` artifact that runs without the model's
  Python code. The windowed warp is the custom op
  ``torch.ops.vfisr_tpu_torch.warp_windowed`` (``ops/cuda/warp.py``), one
  node of the program; importing this module registers it, so a loaded
  artifact runs the hand-written kernel on CUDA tensors and its plain twin
  on CPU tensors.
- ``load_exported`` returns the artifact's module; it checks its inputs'
  shapes and raises on any other.
- ``compile_stats`` times the export and the exported program's first run
  and counts its FLOPs and peak memory.
"""

from __future__ import annotations

import dataclasses
import io
import sys
import time
from typing import Dict, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from vfisr_tpu_torch.ops.cuda import warp as _warp_op  # noqa: F401 (registers the op)


def _maybe_bf16(model, precision: str):
    """Rebuild the model's module config in bf16 where it has a dtype."""
    if precision not in ("bf16", "bfloat16"):
        return model
    # RIFE family: a CONFIG dataclass with a dtype field (class attribute,
    # shadowed per instance); a model whose config has no dtype cannot
    for attr in ("CONFIG", "cfg"):
        cfg = getattr(model, attr, None)
        if cfg is not None and hasattr(cfg, "dtype"):
            setattr(model, attr, dataclasses.replace(cfg, dtype=torch.bfloat16))
            return model
    raise ValueError(f"{type(model).__name__} has no dtype-bearing config; "
                     "bf16 export unsupported for this model")


class InterpolateFn(torch.nn.Module):
    """``fn(x0, x1) -> [N, T, H, W, 3]``: the model's ``interpolate_batch``
    at fixed timesteps. The model's network, where it has one, is a
    submodule, so an export keeps its weights as parameters."""

    def __init__(self, model, timesteps: Tuple[float, ...]):
        super().__init__()
        self.model = model
        self.timesteps = timesteps
        net = getattr(model, "module", None)
        self.net = net if isinstance(net, torch.nn.Module) else None

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        return self.model.interpolate_batch(x0, x1, self.timesteps)


def build_interpolate_fn(model_name: str, timesteps: Sequence[float] = (0.25, 0.5, 0.75),
                         precision: str = "f32", weights_path: str | None = None,
                         device: str = "cuda") -> Tuple[InterpolateFn, object]:
    """(fn, model): fn(x0, x1) -> [N, T, H, W, 3], export-traceable."""
    from vfisr_tpu_torch.models.registry import get_model

    model = get_model(model_name, device=device)
    _maybe_bf16(model, precision)
    model.load(weights_path) if weights_path else model.load()
    return InterpolateFn(model, tuple(float(t) for t in timesteps)), model


def _inputs(pairs: int, height: int, width: int, device) -> tuple:
    x = torch.zeros((pairs, height, width, 3), dtype=torch.float32, device=device)
    return x, x.clone()


def clear_shape_caches() -> None:
    """Empty every ``functools.lru_cache`` of the port's loaded modules.
    They keep tensors per shape (reflect-pad indices, resize taps, filter
    banks); an export traces with fake tensors, and an entry it made would
    turn the next eager call's results fake."""
    for name, module in list(sys.modules.items()):
        if name.split(".")[0] != "vfisr_tpu_torch" or module is None:
            continue
        for value in list(vars(module).values()):
            if callable(getattr(value, "cache_clear", None)) and hasattr(value, "cache_info"):
                value.cache_clear()


def export_program(fn: torch.nn.Module, *inputs: torch.Tensor) -> torch.export.ExportedProgram:
    """``torch.export.export`` of the module fn at the inputs' shapes,
    dtypes and device (no dynamic dimension), between two
    ``clear_shape_caches``: the trace neither takes a cached eager tensor as
    a constant nor leaves a fake one behind."""
    clear_shape_caches()
    try:
        return torch.export.export(fn, tuple(inputs))
    finally:
        clear_shape_caches()


def export_interpolate(model_name: str, height: int = 1080, width: int = 1920, pairs: int = 1,
                       timesteps: Sequence[float] = (0.25, 0.5, 0.75), precision: str = "f32",
                       weights_path: str | None = None, device: str = "cuda") -> bytes:
    """Serialize the model's fixed-shape interpolation program (``.pt2``)."""
    fn, _ = build_interpolate_fn(model_name, timesteps, precision, weights_path, device)
    buf = io.BytesIO()
    torch.export.save(export_program(fn, *_inputs(pairs, height, width, device)), buf)
    return buf.getvalue()


def load_exported(blob: bytes) -> torch.nn.Module:
    """Deserialize an artifact into a callable module(x0, x1)."""
    return torch.export.load(io.BytesIO(blob)).module()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compile_stats(fn: torch.nn.Module, *inputs: torch.Tensor) -> Dict[str, float]:
    """Export the module fn at the inputs and run the exported program; returns
    ``lower_s`` (the export), ``compile_s`` (the program's first run,
    synchronised), ``flops`` (a second run under
    ``torch.utils.flop_counter.FlopCounterMode``: matmuls and convolutions;
    the warp op counts none), ``argument_size_in_bytes`` and
    ``output_size_in_bytes``, and on CUDA ``peak_bytes``
    (``torch.cuda.max_memory_allocated`` over the first run). XLA's
    ``bytes accessed``, ``transcendentals`` and ``temp_size_in_bytes`` have
    no counterpart here and are left out."""
    device = inputs[0].device
    t0 = time.perf_counter()
    module = export_program(fn, *inputs).module()
    t_lower = time.perf_counter()
    if device.type == "cuda":
        _sync(device)
        torch.cuda.reset_peak_memory_stats(device)
    t1 = time.perf_counter()
    with torch.no_grad():
        out = module(*inputs)
    _sync(device)
    t_run = time.perf_counter()
    stats: Dict[str, float] = {"lower_s": round(t_lower - t0, 3),
                               "compile_s": round(t_run - t1, 3)}
    if device.type == "cuda":
        stats["peak_bytes"] = float(torch.cuda.max_memory_allocated(device))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        module(*inputs)
    stats["flops"] = float(counter.get_total_flops())
    stats["argument_size_in_bytes"] = float(sum(x.numel() * x.element_size() for x in inputs))
    stats["output_size_in_bytes"] = float(out.numel() * out.element_size())
    return stats


def smoke_run(blob: bytes, height: int, width: int, pairs: int = 1,
              device: str = "cuda") -> tuple:
    """Run a deserialized artifact once on zeros; returns the output's shape."""
    fn = load_exported(blob)
    with torch.no_grad():
        out = fn(*_inputs(pairs, height, width, device))
    _sync(torch.device(device))
    return tuple(out.shape)
