"""L-BFGS as `optax.lbfgs()` computes it (optax 0.2.6), in PyTorch.

`scale_by_lbfgs` is `optax/_src/transform.py:1573-1745` (memory of
parameter and gradient differences, the two-loop recursion of
`_precondition_by_lbfgs`); `lbfgs` is the chain of `alias.py:2718-2730`:
scale_by_lbfgs → scale(−1) → the zoom linesearch; and
`value_and_grad_from_state` is `utils.py:266`. The two-loop's scalars (ρ,
α, β, γ) stay on the device as 0-d fp32 tensors, so a step syncs only in
the linesearch (`optim/linesearch.py`). The parameters may be row shards
(a list of tensors, `optim/base.py`): each shard keeps its own ring of
curvature pairs on its device, the scalars stay on the first device.

`lbfgs(pairs=True)` runs B pairs of a batch vector as `jax.vmap` runs
optax's L-BFGS over them: each pair keeps its own memory (rings (M, B,
...), ρ (M, B)), γ, α and β as (B,) tensors, each dot product a pair's
own (`pair_vdot`), and the zoom linesearches run in lockstep on the host
(`linesearch.zoom_linesearch_batch`), one batched evaluation a round.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .base import (EmptyState, GradientTransformation, Vector, axpy,
                   first_device, first_vec, pair_of, pair_vdot, scale,
                   stack_pairs, tree_map, vdot)
from .linesearch import (scale_by_zoom_linesearch,
                         scale_by_zoom_linesearch_batch)

MEMORY_SIZE = 10        # optax.lbfgs()'s memory_size


class ScaleByLBFGSState(NamedTuple):
    """optax's `ScaleByLBFGSState`. The memory is a ring of Δw
    (`diff_params_memory`), Δu (`diff_updates_memory`) and ρ = 1/⟨Δu, Δw⟩
    (`weights_memory`), each (memory_size, *params.shape) or
    (memory_size,), written at (count − 1) % memory_size; of shards, a
    ring of Δw and of Δu a shard (a list), on its device."""
    count: int
    params: Vector
    updates: Vector
    diff_params_memory: Vector
    diff_updates_memory: Vector
    weights_memory: torch.Tensor


def _slot(ring: Vector, idx: int) -> Vector:
    """Slot idx of a ring (of each shard's ring)."""
    return tree_map(lambda r: r[idx], ring)


def _set_slot(ring: Vector, idx: int, v: Vector) -> None:
    def put(r, x):
        r[idx] = x
    tree_map(put, ring, v)


def _precondition_by_lbfgs(updates: Vector, diff_params_memory: Vector,
                           diff_updates_memory: Vector,
                           weights_memory: torch.Tensor,
                           identity_scale: torch.Tensor,
                           memory_idx: int, dot=vdot) -> Vector:
    """optax's `_precondition_by_lbfgs` (transform.py:1497): P_k · updates
    by the two loops of Algorithm 7.4 (Nocedal and Wright), over every
    slot of the ring in optax's order, empty slots included (ρ = 0);
    `dot` is `pair_vdot` for a batch."""
    rhos = weights_memory
    memory_size = weights_memory.shape[0]
    indices = [(memory_idx + i) % memory_size for i in range(memory_size)]
    vec = updates
    alphas = {}
    for idx in reversed(indices):            # right_product, reverse scan
        alpha = rhos[idx] * dot(_slot(diff_params_memory, idx), vec)
        vec = axpy(vec, -alpha, _slot(diff_updates_memory, idx))
        alphas[idx] = alpha
    vec = scale(identity_scale, vec)
    for idx in indices:                      # left_product
        beta = rhos[idx] * dot(_slot(diff_updates_memory, idx), vec)
        vec = axpy(vec, alphas[idx] - beta, _slot(diff_params_memory, idx))
    return vec


def scale_by_lbfgs(pairs: bool = False) -> GradientTransformation:
    """optax's `scale_by_lbfgs` with `optax.lbfgs()`'s memory_size and
    `scale_init_precond=True`: the update (a gradient) times the L-BFGS
    approximation of the inverse Hessian, the initial identity scaled by
    γ = ⟨Δu, Δw⟩ / ‖Δu‖², by min(1, 1/‖g‖) at the first step. `update`
    writes the memory of the state it is given in place. `pairs`: the
    vectors are a batch, each pair with its own memory and scalars."""
    memory_size = MEMORY_SIZE
    dot = pair_vdot if pairs else vdot

    def init_fn(params: Vector) -> ScaleByLBFGSState:
        def ring(p):
            return torch.zeros((memory_size,) + tuple(p.shape),
                               dtype=p.dtype, device=p.device)
        lead = tuple(first_vec(params).shape[:1]) if pairs else ()
        return ScaleByLBFGSState(
            count=0, params=tree_map(torch.zeros_like, params),
            updates=tree_map(torch.zeros_like, params),
            diff_params_memory=tree_map(ring, params),
            diff_updates_memory=tree_map(ring, params),
            weights_memory=torch.zeros((memory_size,) + lead,
                                       dtype=torch.float32,
                                       device=first_device(params)))

    def update_fn(updates: Vector, state: ScaleByLBFGSState, params: Vector
                  ) -> tuple[Vector, ScaleByLBFGSState]:
        memory_idx = state.count % memory_size
        prev_memory_idx = (state.count - 1) % memory_size
        dev = first_device(params)
        # 1. the memory, from the fresh params and updates (zero at count 0)
        if state.count > 0:
            diff_params = tree_map(torch.sub, params, state.params)
            diff_updates = tree_map(torch.sub, updates, state.updates)
            vdot_diff_params_updates = dot(diff_updates, diff_params)
            weight = torch.where(vdot_diff_params_updates == 0.0,
                                 torch.zeros_like(vdot_diff_params_updates),
                                 1.0 / vdot_diff_params_updates)
        else:
            diff_params = tree_map(torch.zeros_like, params)
            diff_updates = tree_map(torch.zeros_like, updates)
            weight = torch.zeros(state.weights_memory.shape[1:],
                                 dtype=torch.float32, device=dev)
        _set_slot(state.diff_params_memory, prev_memory_idx, diff_params)
        _set_slot(state.diff_updates_memory, prev_memory_idx, diff_updates)
        state.weights_memory[prev_memory_idx] = weight
        # 2. γ, the scale of the initial identity
        one = torch.ones((), dtype=torch.float32, device=dev)
        if state.count > 0:
            numerator = dot(diff_updates, diff_params)
            denominator = dot(diff_updates, diff_updates)
            identity_scale = torch.where(denominator > 0.0,
                                         numerator / denominator, one)
        else:
            update_norm = torch.sqrt(dot(updates, updates))
            identity_scale = torch.minimum(one, 1.0 / update_norm)
        # 3. P_k u_k
        precond_updates = _precondition_by_lbfgs(
            updates, state.diff_params_memory, state.diff_updates_memory,
            state.weights_memory, identity_scale, memory_idx, dot)
        return precond_updates, ScaleByLBFGSState(
            count=state.count + 1, params=params, updates=updates,
            diff_params_memory=state.diff_params_memory,
            diff_updates_memory=state.diff_updates_memory,
            weights_memory=state.weights_memory)

    return GradientTransformation(init_fn, update_fn)


def lbfgs(pairs: bool = False) -> GradientTransformation:
    """`optax.lbfgs()`: scale_by_lbfgs (memory 10) → scale(−1) → the zoom
    linesearch (at most 20 evaluations, a first guess of 1). The state is
    the chain's tuple (ScaleByLBFGSState, EmptyState,
    ScaleByZoomLinesearchState); `update(grad, state, params, *, value,
    grad, value_and_grad_fn, trace=None)` returns stepsize · direction (a
    `trace` list gets the linesearch's evaluations). `pairs`: of a
    batch vector, `jax.vmap` of the one-pair chain (value a list of the
    pairs' values, `value_and_grad_fn` giving (B,) values)."""
    precond = scale_by_lbfgs(pairs)
    linesearch = (scale_by_zoom_linesearch_batch() if pairs
                  else scale_by_zoom_linesearch())

    def init_fn(params: Vector) -> tuple:
        return (precond.init(params), EmptyState(), linesearch.init(params))

    def update_fn(updates: Vector, state: tuple, params: Vector,
                  *, value, grad: Vector, value_and_grad_fn: Callable,
                  trace: list | None = None) -> tuple[Vector, tuple]:
        direction, s0 = precond.update(updates, state[0], params)
        direction = tree_map(lambda d: d * -1.0, direction)
        updates, s2 = linesearch.update(
            direction, state[2], params, value=value, grad=grad,
            value_and_grad_fn=value_and_grad_fn, trace=trace)
        return updates, (s0, state[1], s2)

    return GradientTransformation(init_fn, update_fn)


def value_and_grad_from_state(value_and_grad_fn: Callable,
                              pairs: bool = False) -> Callable:
    """optax's `value_and_grad_from_state`: `(params, *, state) -> (value,
    grad)` that takes the linesearch's cached value and gradient where the
    value is finite, and evaluates `value_and_grad_fn(params)` otherwise
    (the first step, or after a search that ended outside the domain).
    The cached value is a host float32, a fresh one a 0-d tensor. `pairs`:
    of a batch, the values a list; where any pair's cached value is not
    finite, one batched evaluation, whose value and gradient those pairs
    take (each value a 0-d tensor) while the others keep their cache."""

    def _value_and_grad(params: Vector, *, state: tuple):
        cached = [s for s in state if hasattr(s, "value")
                  and hasattr(s, "grad")]
        if len(cached) != 1:
            raise ValueError("Value or gradient not found in the state.")
        value, grad = cached[0].value, cached[0].grad
        if not pairs:
            if np.isfinite(value):
                return value, grad
            return value_and_grad_fn(params)
        stale = [not np.isfinite(v) for v in value]
        if not any(stale):
            return value, grad
        fresh_values, fresh_grad = value_and_grad_fn(params)
        if all(stale):
            return list(fresh_values), fresh_grad
        return ([fresh_values[i] if s else value[i]
                 for i, s in enumerate(stale)],
                stack_pairs([pair_of(fresh_grad if s else grad, i)
                             for i, s in enumerate(stale)]))

    return _value_and_grad
