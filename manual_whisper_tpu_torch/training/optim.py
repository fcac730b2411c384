"""AdamW with ``optax.adamw``'s semantics and defaults, and optax's
warmup-cosine learning-rate schedule, over the port's weight trees.

``adamw(learning_rate)`` is ``optax.adamw``: ``scale_by_adam`` (b1 0.9,
b2 0.999, eps 1e-8 outside the root; bias correction at count + 1), then
``add_decayed_weights`` (weight decay 1e-4 on every leaf: optax applies
no mask), then ``scale_by_learning_rate`` (a float, or a schedule read at
the count before the increment).  Moments keep the params' dtype (bf16
params give bf16 moments) and every constant is rounded to that dtype
before it is used, as JAX's weakly typed Python scalars are.  ``update``
writes moments and params in place: one copy of the model and the
optimizer state at peak, the counterpart of the JAX step's
``donate_argnums``.

Schedules compute in float32, as the JAX ones do on int32 counts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Sequence, Union

import numpy as np
import torch

Schedule = Callable[[int], float]

# optax.adamw's moment decays and its eps (added outside the square root)
B1, B2, EPS = 0.9, 0.999, 1e-8


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a weight tree (dicts and lists), dict keys in sorted
    order, so that trees of one structure built in any key order list
    their leaves alike."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` on every tensor of a weight tree, in its structure, called in
    ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax ``warmup_cosine_decay_schedule``: linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps`` (warmup included), in
    optax's float32 arithmetic."""
    f32 = np.float32
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                         f"warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac
                         + f32(peak_value))
        c = f32(min(count - warmup_steps, cosine_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c
                                             / f32(cosine_steps)))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha)))
    return schedule


@dataclasses.dataclass
class AdamWState:
    """``count``: updates made (optax's ``count``); ``mu``, ``nu``: the
    first and second moments, trees shaped like the params, each leaf on
    its param's device, dtype and shard."""
    count: int
    mu: Any
    nu: Any


@dataclasses.dataclass
class AdamW:
    """``optax.adamw`` over a weight tree, updated in place (made by
    ``adamw``)."""
    learning_rate: Union[float, Schedule]
    weight_decay: float

    def init(self, params) -> AdamWState:
        return AdamWState(0, tree_map(torch.zeros_like, params),
                          tree_map(torch.zeros_like, params))

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else lr

    def _constants(self, count: int, dtype: torch.dtype
                   ) -> Dict[str, torch.Tensor]:
        """Every scalar of one update, rounded to ``dtype`` (0-dim CPU
        tensors, which combine with tensors on any device)."""
        n = np.float32(count + 1)
        values = {"b1": B1, "1-b1": 1 - B1, "b2": B2, "1-b2": 1 - B2,
                  "eps": EPS, "wd": self.weight_decay,
                  "-lr": -self.lr_at(count),
                  # 1 - decay ** count in float32, then the moment's dtype
                  "bc1": np.float32(1) - np.float32(B1) ** n,
                  "bc2": np.float32(1) - np.float32(B2) ** n}
        return {k: torch.tensor(float(v), dtype=dtype)
                for k, v in values.items()}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params) -> None:
        """One AdamW update of ``params`` (a tree, or its ``tree_leaves``)
        from ``grads`` (in ``tree_leaves`` order), moments and params in
        place, then ``state.count`` + 1."""
        leaves = (params if isinstance(params, list)
                  else tree_leaves(params))
        consts: Dict[torch.dtype, Dict[str, torch.Tensor]] = {}
        for p, g, m, v in zip(leaves, grads, tree_leaves(state.mu),
                              tree_leaves(state.nu), strict=True):
            c = consts.setdefault(p.dtype,
                                  self._constants(state.count, p.dtype))
            g = g.to(p.dtype)
            m.mul_(c["b1"]).add_(g * c["1-b1"])
            v.mul_(c["b2"]).add_(g * g * c["1-b2"])
            u = (m / c["bc1"]) / (torch.sqrt(v / c["bc2"]) + c["eps"])
            u.add_(p * c["wd"])
            p.add_(u * c["-lr"])
        state.count += 1


def adamw(learning_rate: Union[float, Schedule],
          weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` with its defaults (weight decay 1e-4, where torch's
    AdamW takes 1e-2)."""
    return AdamW(learning_rate, weight_decay)
