"""Weights in the JAX package's flat Flax ``.npz`` checkpoints (port of
``vfisr_tpu/utils/checkpoint.py``).

A checkpoint maps '/'-joined parameter paths (e.g. ``block0/Conv_0/kernel``)
to arrays. ``params_from_jax`` carries them to a torch ``state_dict`` whose
module names mirror Flax's (``block0.Conv_0.weight``):

- ``Conv`` kernels go HWIO -> OIHW;
- ``ConvTranspose`` kernels are flipped spatially and go HWIO -> IOHW: Flax
  ``ConvTranspose(k, strides=s, padding=p)`` (no kernel transpose) equals
  torch ``conv_transpose2d`` with the flipped kernel and ``padding=k-1-p``;
- ``Dense`` kernels go (in, out) -> (out, in) (``nn.Linear.weight``);
- ``LayerNorm`` scales become ``weight``;
- VFIMamba's S6 ``conv_w``, a depthwise causal kernel in Flax's LIO layout
  (k, 1, Di), goes to ``conv1d``'s (Di, 1, k);
- biases and the S6 parameters ``A_log`` and ``D`` carry over as they are.

``params_to_jax`` is the inverse, and ``save_npz`` writes the layout that
``vfisr_tpu.utils.checkpoint.save_params`` writes, so either package loads
what the other saved. ``load_params`` reads a checkpoint against the keys
and shapes a model expects, with the reference's ``partial`` warm start.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat {path: array} dict of a checkpoint written by ``save_params``."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


_AS_IS = ("bias", "A_log", "D")


def load_params(path: str, like: Optional[Mapping[str, np.ndarray]] = None,
                partial: bool = False) -> Dict[str, np.ndarray]:
    """Flat params of a checkpoint, checked against ``like`` (flat params of
    the model, e.g. ``params_to_jax(module.state_dict())``) when given:
    every key of ``like`` present with its shape, or a ValueError.

    partial=True: keys missing from the file keep their ``like`` values
    (with a warning) and keys ``like`` lacks are dropped. That is how a v1
    VFIMamba checkpoint warm-starts the net with the refinement pyramid:
    its zero-init stages make it output-identical to v1.
    """
    got = load_npz(path)
    if like is None:
        return got
    missing = set(like) - set(got)
    if missing:
        if not partial:
            raise ValueError(f"checkpoint {path} missing keys: {sorted(missing)[:5]}...")
        warnings.warn(f"checkpoint {path}: {len(missing)} key(s) absent, kept at fresh init "
                      f"(e.g. {sorted(missing)[0]})", stacklevel=2)
        for k in missing:
            got[k] = np.asarray(like[k])
    for k, v in like.items():
        if got[k].shape != np.shape(v):
            raise ValueError(f"checkpoint {path} key {k}: shape {got[k].shape} != {np.shape(v)}")
    return {k: got[k] for k in like} if partial else got


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat Flax params -> torch state_dict (see module docstring)."""
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        module, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
        a = np.asarray(arr, np.float32)
        name = leaf
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
        elif leaf == "scale" and module.startswith("LayerNorm"):
            name = "weight"
        elif leaf == "conv_w" and a.ndim == 3:
            a = a.transpose(2, 1, 0)
        elif leaf not in _AS_IS:
            raise ValueError(f"{key}: unknown parameter kind {leaf!r}")
        out[".".join(parts[:-1] + [name])] = torch.from_numpy(a.copy())
    return out


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """torch state_dict -> flat Flax params: the inverse of
    ``params_from_jax`` (OIHW -> HWIO, ConvTranspose IOHW unflipped to HWIO,
    Dense transposed back, LayerNorm weight -> scale, conv_w back to LIO),
    as f32 numpy arrays."""
    out = {}
    for key, tensor in state.items():
        parts = key.split(".")
        module, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
        a = tensor.detach().to("cpu", torch.float32).numpy()
        name = leaf
        if leaf == "weight" and module.startswith("LayerNorm"):
            name = "scale"
        elif leaf == "weight":
            if module.startswith("ConvTranspose"):
                a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"{key}: no layout rule for a {a.ndim}-D weight")
            name = "kernel"
        elif leaf == "conv_w" and a.ndim == 3:
            a = a.transpose(2, 1, 0)
        elif leaf not in _AS_IS:
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
