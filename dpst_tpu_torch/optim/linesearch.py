"""optax's zoom linesearch (optax 0.2.6, `optax/_src/linesearch.py`) in
PyTorch, with the settings `optax.lbfgs()` passes.

Algorithms 3.5 (the interval search) and 3.6 (the zoom) of Nocedal and
Wright: find a stepsize η along the update direction u that satisfies the
sufficient decrease criterion (or its approximate form) and the small
curvature criterion, by at most MAX_LINESEARCH_STEPS evaluations of the
objective.

The vectors (parameters, direction, gradients; tensors, or lists of row
shards as `optim/base.py` takes them) stay on their devices; the
scalars (stepsizes, values, slopes, the errors and the cubic or quadratic
minimizers) are float32 on the host, as optax computes them in float32
(JAX without x64): float64 arithmetic would flip branches and change the
evaluation counts. Each evaluation fetches its value and slope in one
transfer, and the loop decides `done | failed` on the host: one sync an
evaluation. Where optax computes both sides of a `jnp.where` (the cubic
and quadratic minimizers divide through zeros and give NaN), the port
computes the same expressions under `np.errstate` and takes the same
validity tests.

Each evaluation is a proposal (`_propose`: the stepsize, from the state's
scalars alone), the objective at it, and the state's update from the
value and slope found there (`_accept`). A batch of B pairs
(`zoom_linesearch_batch`, the JAX package's search under `jax.vmap`) runs
B such searches in lockstep, as vmap's `while_loop` does: every round
evaluates all B pairs at their proposals in one batched evaluation and
fetches the B values and slopes in one transfer; a pair whose search has
ended is evaluated again at its stepsize and the result is discarded.
Each pair's decisions are the one-pair search's on its own numbers.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .base import (GradientTransformation, Vector, pair_of, pair_scalars,
                   pair_vdot, stack_pairs, tree_map, vdot)

f32 = np.float32
_INF = f32(np.inf)
_ZERO = f32(0.0)

# optax.lbfgs()'s linesearch: scale_by_zoom_linesearch(max_linesearch_steps
# =20, initial_guess_strategy="one") with the defaults of its other
# arguments (max_learning_rate None), as float32 like JAX's weak Python
# constants
MAX_LINESEARCH_STEPS = 20
_TOL = f32(0.0)
_INCREASE_FACTOR = f32(2.0)
_SLOPE_RTOL = f32(1e-4)
_APPROX_SLOPE = f32(2 * 1e-4 - 1.0)       # 2 · slope_rtol − 1, in float64
_CURV_RTOL = f32(0.9)
_APPROX_DEC_RTOL = f32(1e-6)
_INTERVAL_THRESHOLD = f32(1e-5)           # stepsize_precision
_STEPSIZE_GUESS = f32(1.0)                # initial_guess_strategy="one"


def _host(*xs) -> tuple:
    """Each x as np.float32; the tensors among them come to the host in
    one transfer."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    vals = iter(torch.stack([t.reshape(()).to(torch.float32) for t in ts])
                .cpu().numpy() if ts else ())
    return tuple(f32(next(vals)) if isinstance(x, torch.Tensor) else f32(x)
                 for x in xs)


# pylint: disable=invalid-name
def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's `_cubicmin` (l.455): the critical point of the cubic through
    (a, fa), (b, fb), (c, fc) with slope fpa at a. NaN where the radical is
    negative (the point is then not taken). Powers are products, as JAX's
    `integer_pow` expands them."""
    with np.errstate(all="ignore"):
        C = fpa
        db = b - a
        dc = c - a
        dbc = db * dc
        denom = dbc * dbc * (db - dc)
        db2, dc2 = db * db, dc * dc
        db3, dc3 = db * db2, dc * dc2
        v0 = fb - fa - C * db
        v1 = fc - fa - C * dc
        A = (dc2 * v0 + (-db2) * v1) / denom
        B = ((-dc3) * v0 + db3 * v1) / denom
        radical = B * B - f32(3.0) * A * C
        return a + (-B + np.sqrt(radical)) / (f32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's `_quadmin` (l.496): the critical point of the quadratic
    through (a, fa), (b, fb) with slope fpa at a."""
    with np.errstate(all="ignore"):
        D = fa
        C = fpa
        db = b - a
        B = (fb - D - C * db) / (db * db)
        return a - C / (f32(2.0) * B)
# pylint: enable=invalid-name


def _zoom_middle(low, value_low, slope_low, high, value_high, cubic_ref,
                 value_cubic_ref) -> tuple:
    """The zoom's next stepsize (optax l.1000-1028) and which rule gave it:
    the cubic minimizer where it lies inside the interval by a fifth of
    its length, else the quadratic one inside by a tenth, else the
    bisection. NaN minimizers fail the tests."""
    with np.errstate(all="ignore"):
        delta = np.abs(high - low)
        left = np.minimum(high, low)
        right = np.maximum(high, low)
        cubic_chk = f32(0.2) * delta
        quad_chk = f32(0.1) * delta
        middle_cubic = _cubicmin(low, value_low, slope_low, high,
                                 value_high, cubic_ref, value_cubic_ref)
        if ((middle_cubic > left + cubic_chk)
                & (middle_cubic < right - cubic_chk)):
            return f32(middle_cubic), "cubic"
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        if ((middle_quad > left + quad_chk)
                & (middle_quad < right - quad_chk)):
            return f32(middle_quad), "quadratic"
    return (low + high) / f32(2.0), "bisection"


def _decrease_error(stepsize, value_step, slope_step, value_init,
                    slope_init):
    """optax l.710: the sufficient decrease error, or the approximate one
    where smaller; NaN becomes inf."""
    with np.errstate(all="ignore"):
        decrease_error = (value_step - value_init
                          - _SLOPE_RTOL * stepsize * slope_init)
        approx_decrease_error = np.maximum(
            slope_step - _APPROX_SLOPE * slope_init,
            value_step - value_init - _APPROX_DEC_RTOL * np.abs(value_init))
        decrease_error = np.maximum(
            np.minimum(approx_decrease_error, decrease_error), _ZERO)
    return _INF if np.isnan(decrease_error) else f32(decrease_error)


def _curvature_error(slope_step, slope_init):
    """optax l.752: the small curvature error; NaN becomes inf."""
    with np.errstate(all="ignore"):
        curvature_error = np.maximum(
            np.abs(slope_step) - _CURV_RTOL * np.abs(slope_init), _ZERO)
    return _INF if np.isnan(curvature_error) else f32(curvature_error)


class ZoomLinesearchState(NamedTuple):
    """optax's `ZoomLinesearchState` (without the constant stepsize guess
    and the unread `error`): tensors for params, updates and the
    gradients, np.float32 for the scalars (`count` an int, the flags
    bools). Until the first evaluation, the initial value and slope may
    still be 0-d tensors on the device (`_resolve_init`)."""
    count: int
    params: Vector
    updates: Vector
    stepsize: np.float32
    value: np.float32
    grad: Vector
    slope: np.float32
    value_init: np.float32
    slope_init: np.float32
    decrease_error: np.float32
    curvature_error: np.float32
    interval_found: bool
    done: bool
    failed: bool
    low: np.float32
    value_low: np.float32
    slope_low: np.float32
    high: np.float32
    value_high: np.float32
    slope_high: np.float32
    cubic_ref: np.float32
    value_cubic_ref: np.float32
    safe_stepsize: np.float32
    safe_value: np.float32
    safe_grad: Vector


def _value_and_slope_on_line(value_and_grad_fn: Callable,
                             state: ZoomLinesearchState, stepsize):
    """(value, grad, slope) at params + stepsize · updates, the value and
    the slope still on the device."""
    step = tree_map(lambda p, u: p + u * float(stepsize), state.params,
                    state.updates)
    value_step, grad_step = value_and_grad_fn(step)
    return value_step, grad_step, vdot(grad_step, state.updates)


def _init_scalars(state: ZoomLinesearchState, v0, s0) -> ZoomLinesearchState:
    """The state with its initial value v0 and slope s0 (host float32)
    written to every field that starts from them."""
    return state._replace(
        value=v0, slope=s0, value_init=v0, slope_init=s0, value_low=v0,
        slope_low=s0, value_high=v0, slope_high=s0, value_cubic_ref=v0,
        safe_value=v0)


def _resolve_init(state: ZoomLinesearchState, value_step, slope_step):
    """The evaluation's value and slope on the host, together with the
    initial value and slope where those are still on the device (the
    first evaluation of a step: one transfer)."""
    v0, s0, value_step, slope_step = _host(
        state.value_init, state.slope_init, value_step, slope_step)
    if isinstance(state.slope_init, torch.Tensor):
        state = _init_scalars(state, v0, s0)
    return state, value_step, slope_step


def _try_safe_step(state: ZoomLinesearchState) -> ZoomLinesearchState:
    """optax l.768: fall back to the best stepsize with sufficient
    decrease, or to 0 where the objective left its domain."""
    if state.safe_stepsize > _ZERO or np.isinf(state.decrease_error):
        return state._replace(stepsize=state.safe_stepsize,
                              value=state.safe_value, grad=state.safe_grad)
    return state


def _propose(state: ZoomLinesearchState) -> tuple:
    """The next stepsize to evaluate and the rule that gave it: the
    interval search's guess (optax l.815: 1, then twice the last; no
    max_stepsize), or the zoom's middle of the interval (l.971, "cubic",
    "quadratic" or "bisection")."""
    if state.interval_found:
        return _zoom_middle(state.low, state.value_low, state.slope_low,
                            state.high, state.value_high, state.cubic_ref,
                            state.value_cubic_ref)
    return (_STEPSIZE_GUESS if state.count == 0
            else _INCREASE_FACTOR * state.stepsize), "interval"


def _accept_interval(state: ZoomLinesearchState, new_stepsize,
                     new_value_step, new_grad_step, new_slope_step
                     ) -> ZoomLinesearchState:
    """optax l.815, Algorithm 3.5, from the value and slope at the guess."""
    iter_num = state.count
    decrease_error = _decrease_error(new_stepsize, new_value_step,
                                     new_slope_step, state.value_init,
                                     state.slope_init)
    curvature_error = _curvature_error(new_slope_step, state.slope_init)
    done = bool(max(decrease_error, curvature_error) <= _TOL)

    safe = ((new_stepsize, new_value_step, new_grad_step)
            if decrease_error <= _TOL else
            (state.safe_stepsize, state.safe_value, state.safe_grad))
    set_high_to_new = bool(decrease_error > _ZERO or (
        new_value_step >= state.value and iter_num > 0))
    set_low_to_new = bool(new_slope_step >= _ZERO) and not set_high_to_new
    new = (new_stepsize, new_value_step, new_slope_step)
    prev = (state.stepsize, state.value, state.slope)
    low, high = (new, prev) if set_low_to_new else (prev, new)
    return state._replace(
        count=iter_num + 1, stepsize=new_stepsize, value=new_value_step,
        grad=new_grad_step, slope=new_slope_step,
        decrease_error=decrease_error, curvature_error=curvature_error,
        interval_found=set_high_to_new or set_low_to_new or done,
        done=done,
        failed=iter_num + 1 >= MAX_LINESEARCH_STEPS and not done,
        low=low[0], value_low=low[1], slope_low=low[2], high=high[0],
        value_high=high[1], slope_high=high[2], cubic_ref=low[0],
        value_cubic_ref=low[1], safe_stepsize=safe[0], safe_value=safe[1],
        safe_grad=safe[2])


def _accept_zoom(state: ZoomLinesearchState, middle, value_middle,
                 grad_middle, slope_middle) -> ZoomLinesearchState:
    """optax l.971, Algorithm 3.6, from the value and slope at the
    middle."""
    iter_num = state.count
    low = (state.low, state.value_low, state.slope_low)
    high = (state.high, state.value_high, state.slope_high)
    too_small_int = bool(np.abs(high[0] - low[0]) <= _INTERVAL_THRESHOLD)
    decrease_error = _decrease_error(middle, value_middle, slope_middle,
                                     state.value_init, state.slope_init)
    curvature_error = _curvature_error(slope_middle, state.slope_init)
    done = bool(max(decrease_error, curvature_error) <= _TOL)

    safe = ((middle, value_middle, grad_middle)
            if decrease_error <= _TOL and value_middle < state.safe_value
            else (state.safe_stepsize, state.safe_value, state.safe_grad))
    set_high_to_middle = bool(decrease_error > _ZERO
                              or value_middle >= low[1])
    with np.errstate(all="ignore"):
        secant_interval = slope_middle * (high[0] - low[0])
    set_high_to_low = bool(secant_interval >= _ZERO) and (
        not set_high_to_middle)
    mid = (middle, value_middle, slope_middle)
    new_high = low if set_high_to_low else (
        mid if set_high_to_middle else high)
    new_low = low if set_high_to_middle else mid
    cubic_ref = high if set_high_to_middle or set_high_to_low else low
    presumably_failed = iter_num + 1 >= MAX_LINESEARCH_STEPS or (
        too_small_int and bool(safe[0] > _ZERO))
    return state._replace(
        count=iter_num + 1, stepsize=middle, value=value_middle,
        grad=grad_middle, slope=slope_middle, decrease_error=decrease_error,
        curvature_error=curvature_error, done=done,
        failed=presumably_failed and not done, low=new_low[0],
        value_low=new_low[1], slope_low=new_low[2], high=new_high[0],
        value_high=new_high[1], slope_high=new_high[2],
        cubic_ref=cubic_ref[0], value_cubic_ref=cubic_ref[1],
        safe_stepsize=safe[0], safe_value=safe[1], safe_grad=safe[2])


def _accept(state: ZoomLinesearchState, stepsize, value, grad: Vector,
            slope) -> ZoomLinesearchState:
    """optax's `step_fn` (l.1250) after its evaluation: the zoom's or the
    interval search's update, then the safe step where the search
    failed."""
    accept = _accept_zoom if state.interval_found else _accept_interval
    state = accept(state, stepsize, value, grad, slope)
    return _try_safe_step(state) if state.failed else state


def _trace_entry(stepsize, rule: str, value, slope,
                 state: ZoomLinesearchState) -> dict:
    """One evaluation of a search, for `optimize.record_evaluations`: the
    stepsize, the rule that proposed it, the value and slope found there,
    and the errors and verdict they gave."""
    return {"stepsize": float(stepsize), "rule": rule, "value": float(value),
            "slope": float(slope),
            "decrease_error": float(state.decrease_error),
            "curvature_error": float(state.curvature_error),
            "done": bool(state.done), "failed": bool(state.failed)}


def init_linesearch(updates: Vector, params: Vector, *, value,
                    grad: Vector, slope=None) -> ZoomLinesearchState:
    """optax's `init_fn` (l.1194). `value` is a host float32 (a cached
    value) or a 0-d tensor (a fresh evaluation); the slope ⟨updates, grad⟩
    (unless given) stays on the device until the first evaluation fetches
    it."""
    slope = vdot(updates, grad) if slope is None else slope
    value = value if isinstance(value, torch.Tensor) else f32(value)
    return ZoomLinesearchState(
        count=0, params=params, updates=updates, stepsize=_ZERO,
        value=value, grad=grad, slope=slope, value_init=value,
        slope_init=slope, decrease_error=_INF, curvature_error=_INF,
        interval_found=False, done=False, failed=False, low=_ZERO,
        value_low=value, slope_low=slope, high=_ZERO, value_high=value,
        slope_high=slope, cubic_ref=_ZERO, value_cubic_ref=value,
        safe_stepsize=_ZERO, safe_value=value, safe_grad=grad)


def step_linesearch(state: ZoomLinesearchState, value_and_grad_fn: Callable,
                    trace: list | None = None) -> ZoomLinesearchState:
    """optax's `step_fn` (l.1250): one evaluation, interval search or zoom;
    the safe step where the search failed. The search goes on while
    neither `done` nor `failed` (optax's `step_cond_fn`, l.1276). `trace`,
    where given, gets the evaluation's `_trace_entry`."""
    stepsize, rule = _propose(state)
    value_t, grad_step, slope_t = _value_and_slope_on_line(
        value_and_grad_fn, state, stepsize)
    state, value_step, slope_step = _resolve_init(state, value_t, slope_t)
    state = _accept(state, stepsize, value_step, grad_step, slope_step)
    if trace is not None:
        trace.append(_trace_entry(stepsize, rule, value_step, slope_step,
                                  state))
    return state


class ZoomLinesearchInfo(NamedTuple):
    """optax's `ZoomLinesearchInfo`: the evaluations of the step's search,
    and its final decrease and curvature errors (either positive: the
    search failed and took the safe step)."""
    num_linesearch_steps: int
    decrease_error: np.float32
    curvature_error: np.float32


class ScaleByZoomLinesearchState(NamedTuple):
    """optax's state: the stepsize taken, the value and gradient at the new
    parameters (reused by `value_and_grad_from_state`), and the info."""
    learning_rate: np.float32
    value: np.float32
    grad: Vector
    info: ZoomLinesearchInfo


def scale_by_zoom_linesearch() -> GradientTransformation:
    """optax's `scale_by_zoom_linesearch` (l.1292) as `optax.lbfgs()` sets
    it up. `update(updates, state, params, *, value, grad,
    value_and_grad_fn)` scales the direction `updates` by the stepsize
    found (l.1553-1622). Where optax takes `value_fn` and differentiates
    it, the port takes the function of the value and gradient itself (the
    caller's autograd evaluation). A list passed as `trace` gets each
    evaluation's `_trace_entry` (kept out of the state, which checkpoints
    save)."""

    def init_fn(params: Vector) -> ScaleByZoomLinesearchState:
        return ScaleByZoomLinesearchState(
            learning_rate=f32(1.0), value=_INF,
            grad=tree_map(torch.zeros_like, params),
            info=ZoomLinesearchInfo(0, _INF, _INF))

    def update_fn(updates: Vector, state: ScaleByZoomLinesearchState,
                  params: Vector, *, value, grad: Vector,
                  value_and_grad_fn: Callable, trace: list | None = None
                  ) -> tuple[Vector, ScaleByZoomLinesearchState]:
        del state   # optax reads its stepsize only for "keep" guesses
        ls = init_linesearch(updates, params, value=value, grad=grad)
        while not (ls.done or ls.failed):
            ls = step_linesearch(ls, value_and_grad_fn, trace)
        stepsize = float(ls.stepsize)
        return tree_map(lambda u: u * stepsize, updates), (
            ScaleByZoomLinesearchState(
                learning_rate=ls.stepsize, value=ls.value, grad=ls.grad,
                info=ZoomLinesearchInfo(ls.count, ls.decrease_error,
                                        ls.curvature_error)))

    return GradientTransformation(init_fn, update_fn)

# --- a batch of B pairs in lockstep ---------------------------------------

def fetch(*parts) -> list:
    """Each part as host float32: the tensors among them (0-d or (B,))
    come in one transfer, the host numbers as they are; a (B,) tensor
    gives an array."""
    ts = [p for p in parts if isinstance(p, torch.Tensor)]
    flat = (torch.cat([t.reshape(-1).to(torch.float32).to(ts[0].device)
                       for t in ts]).cpu().numpy() if ts else None)
    out, at = [], 0
    for p in parts:
        if isinstance(p, torch.Tensor):
            v = flat[at:at + p.numel()]
            out.append(f32(v[0]) if p.dim() == 0 else v.astype(f32))
            at += p.numel()
        else:
            out.append(p)
    return out


def _scaled(updates: Vector, stepsizes) -> Vector:
    """Each pair's updates times its stepsize (host numbers), elementwise
    as the one-pair `u * stepsize`."""
    ss = pair_scalars(stepsizes, updates)
    one = lambda u, t: u * t.reshape(t.shape + (1,) * (u.dim() - 1))
    if isinstance(updates, torch.Tensor):
        return one(updates, ss[0])
    return [one(u, t) for u, t in zip(updates, ss)]


def zoom_linesearch_batch(updates: Vector, params: Vector, *, values,
                          grad: Vector, value_and_grad_fn: Callable):
    """B zoom linesearches in lockstep, one a pair of a batch vector (each
    tensor with a leading pair axis). `values` holds each pair's initial
    value (a host float32, or a 0-d tensor of a fresh evaluation), `grad`
    the batch's gradient there; `value_and_grad_fn(step)` gives the (B,)
    values and the gradient of a batch point. Every round proposes each
    live pair's stepsize, evaluates all B pairs at their points (a pair
    whose search has ended at its stepsize, the result discarded), and
    fetches the values and slopes in one transfer (the first round also
    the initial values and slopes). Returns (each pair's final
    ZoomLinesearchState, its vectors views of the batch tensors; the
    rounds run; each pair's trace)."""
    b = len(values)
    slopes0 = pair_vdot(updates, grad)
    states = None
    traces = [[] for _ in range(b)]
    rounds = 0
    while states is None or not all(st.done or st.failed for st in states):
        if states is None:
            props = [(_STEPSIZE_GUESS, "interval")] * b
        else:
            props = [(st.stepsize, None) if st.done or st.failed
                     else _propose(st) for st in states]
        step = tree_map(torch.add, params,
                        _scaled(updates, [p[0] for p in props]))
        vals_t, grad_step = value_and_grad_fn(step)
        slopes_t = pair_vdot(grad_step, updates)
        rounds += 1
        if states is None:
            got = fetch(*values, slopes0, vals_t, slopes_t)
            v0, s0, vals, slopes = got[:b], got[b], got[b + 1], got[b + 2]
            states = [init_linesearch(
                pair_of(updates, i), pair_of(params, i), value=v0[i],
                grad=pair_of(grad, i), slope=s0[i]) for i in range(b)]
        else:
            vals, slopes = fetch(vals_t, slopes_t)
        for i, (stepsize, rule) in enumerate(props):
            if rule is None:
                continue
            states[i] = _accept(states[i], stepsize, vals[i],
                                pair_of(grad_step, i), slopes[i])
            traces[i].append(_trace_entry(stepsize, rule, vals[i],
                                          slopes[i], states[i]))
    return states, rounds, traces


class ScaleByZoomLinesearchBatchState(NamedTuple):
    """`ScaleByZoomLinesearchState` of a batch: lists of each pair's
    stepsize, value and info, the batch's gradient, and the rounds (batched
    evaluations) of the last search."""
    learning_rate: list
    value: list
    grad: Vector
    info: list
    rounds: int


def scale_by_zoom_linesearch_batch() -> GradientTransformation:
    """`scale_by_zoom_linesearch` for a batch of pairs: `update(updates,
    state, params, *, value, grad, value_and_grad_fn)` with each pair's
    value (a list), the batch gradient and a batched `value_and_grad_fn`
    runs `zoom_linesearch_batch` and scales each pair's direction by its
    stepsize; a `trace` list gets each pair's trace."""

    def init_fn(params: Vector) -> ScaleByZoomLinesearchBatchState:
        b = (params if isinstance(params, torch.Tensor) else params[0]
             ).shape[0]
        return ScaleByZoomLinesearchBatchState(
            learning_rate=[f32(1.0)] * b, value=[_INF] * b,
            grad=tree_map(torch.zeros_like, params),
            info=[ZoomLinesearchInfo(0, _INF, _INF)] * b, rounds=0)

    def update_fn(updates: Vector, state, params: Vector, *, value,
                  grad: Vector, value_and_grad_fn: Callable,
                  trace: list | None = None):
        del state
        states, rounds, traces = zoom_linesearch_batch(
            updates, params, values=value, grad=grad,
            value_and_grad_fn=value_and_grad_fn)
        if trace is not None:
            trace.extend(traces)
        sizes = [st.stepsize for st in states]
        return _scaled(updates, sizes), ScaleByZoomLinesearchBatchState(
            learning_rate=sizes, value=[st.value for st in states],
            grad=stack_pairs([st.grad for st in states]),
            info=[ZoomLinesearchInfo(st.count, st.decrease_error,
                                     st.curvature_error) for st in states],
            rounds=rounds)

    return GradientTransformation(init_fn, update_fn)

