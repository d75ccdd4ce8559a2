"""The optimizer interface of the port's `optim` package, after optax's
`GradientTransformation` (optax/_src/base.py): `init(params) -> state`
and `update(updates, state, params, **extra) -> (updates, state)`, the
new parameters being `params + updates` (`apply_updates`)."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    """The state of a transformation that keeps none (optax's
    `EmptyState`, here of `scale(-1)`)."""


def apply_updates(params: torch.Tensor, updates: torch.Tensor
                  ) -> torch.Tensor:
    return params + updates


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """⟨a, b⟩ in fp32, on the device, as an elementwise product and then a
    sum: never a matmul, which could ride TF32 on the card."""
    return torch.sum(a * b)
