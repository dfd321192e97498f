"""Weights in the JAX package's flat Flax ``.npz`` checkpoints (port of
``vfisr_tpu/utils/checkpoint.py``).

A checkpoint maps '/'-joined parameter paths (e.g. ``block0/Conv_0/kernel``)
to arrays. ``params_from_jax`` carries them to a torch ``state_dict`` whose
module names mirror Flax's (``block0.Conv_0.weight``):

- ``Conv`` kernels go HWIO -> OIHW;
- ``ConvTranspose`` kernels are flipped spatially and go HWIO -> IOHW: Flax
  ``ConvTranspose(k, strides=s, padding=p)`` (no kernel transpose) equals
  torch ``conv_transpose2d`` with the flipped kernel and ``padding=k-1-p``;
- ``Dense`` kernels go (in, out) -> (out, in);
- biases carry over as they are.

``params_to_jax`` is the inverse, and ``save_npz`` writes the layout that
``vfisr_tpu.utils.checkpoint.save_params`` writes, so either package loads
what the other saved.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat {path: array} dict of a checkpoint written by ``save_params``."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat Flax params -> torch state_dict (see module docstring)."""
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        module, leaf = parts[-2], parts[-1]
        a = np.asarray(arr, np.float32)
        if leaf == "kernel":
            if module.startswith("ConvTranspose"):
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"{key}: no layout rule for a {a.ndim}-D kernel")
            name = "weight"
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"{key}: unknown parameter kind {leaf!r}")
        out[".".join(parts[:-1] + [name])] = torch.from_numpy(a.copy())
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """torch state_dict -> flat Flax params: the inverse of
    ``params_from_jax`` (OIHW -> HWIO, ConvTranspose IOHW unflipped to HWIO,
    Dense transposed back), as f32 numpy arrays."""
    out = {}
    for key, tensor in state.items():
        parts = key.split(".")
        module, leaf = parts[-2], parts[-1]
        a = tensor.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if module.startswith("ConvTranspose"):
                a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"{key}: no layout rule for a {a.ndim}-D weight")
            name = "kernel"
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"{key}: unknown parameter kind {leaf!r}")
        out["/".join(parts[:-1] + [name])] = np.ascontiguousarray(a)
    return out


def save_npz(path: str, flat: Mapping[str, np.ndarray]) -> None:
    """Write flat {'/'-joined path: array} params as ``.npz``, atomically:
    into ``<path>.tmp.npz``, then renamed over ``path`` (a run stopped
    mid-write leaves the previous checkpoint whole)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.npz"  # ends in .npz, so np.savez appends nothing
    for stale in (f"{path}.tmp", tmp):
        if os.path.exists(stale):
            os.remove(stale)
    np.savez(tmp, **flat)
    os.replace(tmp, path)
