"""Training steps for the VFI and SR models (port of ``vfisr_tpu/train/train.py``).

Losses (charbonnier, soft census, ``vfi_loss``, ``sr_loss``) take NHWC
tensors in [0, 1], as the JAX ones do. ``create_train_state`` builds the
optimizer of the JAX package's ``optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(...), weight_decay))`` with optax's
semantics: ``make_train_step`` clips by the global norm with optax's formula
(scaled only when the norm exceeds the limit, no epsilon), then takes a
``torch.optim.AdamW`` step (b1 0.9, b2 0.999, eps 1e-8, every parameter
decayed, biases included) at the schedule's value for the update count
before the increment. ``use_remat`` recomputes the forward in the backward
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).
``make_sr_train_step`` is the SR step (batch {lr, hr}, no remat, as the JAX
one).

Data-parallel training (the JAX step's mesh) is not ported; one card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable

import torch
from torch.utils.checkpoint import checkpoint

MAX_GRAD_NORM = 1.0  # optax.clip_by_global_norm(1.0) in the JAX chain


def charbonnier(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.sqrt(x * x + eps)


def census_soft(x: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Soft census transform (illumination-robust structure descriptor);
    the shifts wrap around, as ``jnp.roll`` does."""
    # the mean as XLA takes it, the sum times 1/C (a torch mean divides)
    gray = x.sum(dim=-1, keepdim=True) * (1.0 / x.shape[-1]) * 255.0
    pad = window // 2
    patches = []
    for dy in range(-pad, pad + 1):
        for dx in range(-pad, pad + 1):
            if dy == 0 and dx == 0:
                continue
            d = torch.roll(torch.roll(gray, dy, dims=1), dx, dims=2) - gray
            patches.append(d / torch.sqrt(0.81 + d * d))
    return torch.cat(patches, dim=-1)


def vfi_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Charbonnier + soft-census loss for interpolation training."""
    l_char = charbonnier(pred - gt).mean()
    l_census = charbonnier(census_soft(pred) - census_soft(gt), 1e-3).mean()
    return l_char + 0.1 * l_census


def sr_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Charbonnier reconstruction loss."""
    return charbonnier(pred - gt).mean()


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from init to peak over
    ``warmup_steps``, then cosine decay to ``end_value`` at ``decay_steps``
    (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        k = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * k / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@dataclass
class TrainState:
    """The optimizer, its learning-rate schedule and the update count (the
    JAX ``TrainState``'s step and opt_state; the params live in the
    module)."""

    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(params: Iterable[torch.nn.Parameter], learning_rate: float = 2e-4,
                       weight_decay: float = 1e-4, total_steps: int = 100_000,
                       warmup_steps: int = 2000) -> TrainState:
    """AdamW with the JAX package's warmup-cosine schedule over ``params``."""
    warmup_steps = min(warmup_steps, max(total_steps // 10, 1))
    schedule = warmup_cosine_decay_schedule(0.0, learning_rate, warmup_steps,
                                            max(total_steps, warmup_steps + 1),
                                            learning_rate * 0.01)
    opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return TrainState(opt, schedule)


def clip_by_global_norm(grads: list, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: every gradient times
    max_norm/norm when the global norm is not below max_norm. Returns the
    norm (a device scalar: no host sync)."""
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def apply_gradients(state: TrainState, params: list) -> None:
    """The JAX chain's update from the parameters' ``.grad``: clip by the
    global norm, then AdamW at ``schedule(step)``; step += 1. A parameter
    without a gradient takes a zero one (optax decays it all the same)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm([p.grad for p in params], MAX_GRAD_NORM)
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.step += 1


def _make_step(module: torch.nn.Module, state: TrainState,
               loss_of: Callable[[dict], torch.Tensor]) -> Callable[[dict], torch.Tensor]:
    """``step(batch) -> loss`` (a device scalar, detached): the gradients of
    ``loss_of(batch)``, then ``apply_gradients``."""
    params = [p for p in module.parameters() if p.requires_grad]

    def step(batch: dict) -> torch.Tensor:
        for p in params:
            p.grad = None
        loss = loss_of(batch)
        loss.backward()
        apply_gradients(state, params)
        return loss.detach()

    return step


def make_train_step(module: torch.nn.Module, state: TrainState,
                    loss_fn: Callable = vfi_loss,
                    use_remat: bool = True) -> Callable[[dict], torch.Tensor]:
    """One VFI training step: ``step(batch) -> loss`` (a device scalar,
    detached). batch: {img0, img1, gt [N,H,W,3], t [N]}; the module maps
    (img0, img1, t) to its prediction or a tuple that starts with it."""

    def forward(img0, img1, t, gt):
        out = module(img0, img1, t)
        pred = out[0] if isinstance(out, tuple) else out
        return loss_fn(pred, gt)

    def loss_of(batch: dict) -> torch.Tensor:
        args = (batch["img0"], batch["img1"], batch["t"], batch["gt"])
        return checkpoint(forward, *args, use_reentrant=False) if use_remat else forward(*args)

    return _make_step(module, state, loss_of)


def make_sr_train_step(module: torch.nn.Module, state: TrainState,
                       loss_fn: Callable = sr_loss) -> Callable[[dict], torch.Tensor]:
    """One SR training step: ``step(batch) -> loss`` (a device scalar,
    detached). batch: {lr [N,h,w,3], hr [N,h*s,w*s,3]}; the module maps lr
    to its hr prediction. No remat, as the JAX SR step has none."""
    return _make_step(module, state, lambda batch: loss_fn(module(batch["lr"]), batch["hr"]))
