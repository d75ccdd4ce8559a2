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
or host numbers) reach a shard for its product only.

A batch of B pairs (`optim.lbfgs(pairs=True)`, the JAX package's vmapped
optimizer) is a vector with a leading pair axis on every tensor (of each
shard, `(B, rows, W, 3)`). Its scalars are (B,) tensors, one a pair,
broadcast over each pair's elements, and `pair_vdot` gives each pair's
own dot product, summed in the order `vdot` sums one pair's."""
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


def first_vec(v: Vector) -> torch.Tensor:
    """A vector's tensor, or its first shard's."""
    return v if isinstance(v, torch.Tensor) else v[0]


def first_device(v: Vector) -> torch.device:
    """Where a vector's scalars live: its (first shard's) device."""
    return first_vec(v).device


def _on(s, x: torch.Tensor):
    """The scalar s for x's product: on x's device, and a batch's (B,)
    scalars as (B, 1, ...), one a pair."""
    if not isinstance(s, torch.Tensor):
        return s
    s = s.to(x.device)
    return s.reshape(s.shape + (1,) * (x.dim() - 1)) if s.dim() == 1 else s


def scale(s, v: Vector) -> Vector:
    """s · v, the scalar s (a 0-d tensor, a batch's (B,) tensor or a
    number) on each shard."""
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


def pair_vdot(a: Vector, b: Vector) -> torch.Tensor:
    """Each pair's ⟨a_i, b_i⟩ of a batch, (B,) fp32 on the first device:
    one elementwise product, then a sum over each pair's own elements, as
    `vdot` sums one pair (so a batch of one gives `vdot`'s bits); of
    shards, each pair's partial dots added on the first device in shard
    order."""
    def per_pair(x, y):
        p = x * y
        if p.shape[0] == 1:
            return torch.sum(p[0]).reshape(1)
        return torch.stack([torch.sum(p[i]) for i in range(p.shape[0])])
    if isinstance(a, torch.Tensor):
        return per_pair(a, b)
    total = None
    for x, y in zip(a, b):
        d = per_pair(x, y).to(a[0].device)
        total = d if total is None else total + d
    return total


def pair_of(v: Vector, i: int) -> Vector:
    """Pair i of a batch vector (views)."""
    return tree_map(lambda x: x[i], v)


def _stack(xs) -> torch.Tensor:
    """The pairs xs stacked on a new leading axis, each pair in the memory
    layout of xs[0] (a gradient may come channels-first from the
    backward): a sum over a pair then runs in the order it runs over the
    pair alone."""
    x = xs[0]
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    out = x.new_empty((len(xs),) + tuple(x.shape[d] for d in order))
    out = out.permute([0] + [1 + order.index(d) for d in range(x.dim())])
    for o, y in zip(out, xs):
        o.copy_(y)
    return out


def stack_pairs(vs: list) -> Vector:
    """The batch vector of B pair vectors (the inverse of `pair_of`)."""
    return tree_map(lambda *xs: _stack(xs), *vs)


def pair_scalars(values, like: Vector) -> list:
    """Host numbers, one a pair, as a (B,) fp32 tensor on each shard's
    device (of a tensor: a list of one), each element written by a fill
    (a kernel argument, not a copy from the host, which would sync)."""
    out = []
    for x in (like if isinstance(like, list) else [like]):
        t = torch.empty(len(values), dtype=torch.float32, device=x.device)
        for i, v in enumerate(values):
            t[i].fill_(float(v))
        out.append(t)
    return out
