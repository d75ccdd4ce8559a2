"""The optimizer interface of the port's `optim` package, after optax's
`GradientTransformation` (optax/_src/base.py): `init(params) -> state`
and `update(updates, state, params, **extra) -> (updates, state)`, the
new parameters being `params + updates` (`apply_updates`).

A vector (parameters, updates, gradients) is a tensor, or a list of
tensors, one a shard (the row shards of an image, `parallel/spatial.py`),
each on its own device: optax's vectors are pytrees, and the helpers here
are its tree functions. A shard's arithmetic stays on its device; a dot
product sums the shards' partial dots on the first shard's device, in
shard order, so a rerun is bit-identical and a list of one tensor gives
exactly what the tensor gives. Scalars (0-d tensors on the first device,
or host numbers) reach a shard for its product only."""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

Vector = Union[torch.Tensor, list]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    """The state of a transformation that keeps none (optax's
    `EmptyState`, here of `scale(-1)`)."""


def tree_map(fn: Callable, *vs: Vector) -> Vector:
    """fn of the tensors, or of each shard's tensors in turn."""
    if isinstance(vs[0], torch.Tensor):
        return fn(*vs)
    return [fn(*xs) for xs in zip(*vs)]


def first_device(v: Vector) -> torch.device:
    """Where a vector's scalars live: its (first shard's) device."""
    return (v if isinstance(v, torch.Tensor) else v[0]).device


def _on(s, x: torch.Tensor):
    return s.to(x.device) if isinstance(s, torch.Tensor) else s


def scale(s, v: Vector) -> Vector:
    """s · v, the scalar s (a 0-d tensor or a number) on each shard."""
    return tree_map(lambda x: _on(s, x) * x, v)


def axpy(v: Vector, s, x: Vector) -> Vector:
    """v + s · x, shard by shard."""
    return tree_map(lambda a, b: a + _on(s, b) * b, v, x)


def apply_updates(params: Vector, updates: Vector) -> Vector:
    return tree_map(torch.add, params, updates)


def vdot(a: Vector, b: Vector) -> torch.Tensor:
    """⟨a, b⟩ in fp32 as an elementwise product and then a sum (never a
    matmul, which could ride TF32 on the card); of shards, their partial
    dots moved to the first shard's device and added in shard order."""
    if isinstance(a, torch.Tensor):
        return torch.sum(a * b)
    total = None
    for x, y in zip(a, b):
        d = torch.sum(x * y).to(a[0].device)
        total = d if total is None else total + d
    return total
