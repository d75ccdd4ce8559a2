"""The port's L-BFGS (`dpst_tpu_torch/optim`, the L-BFGS half of
`dpst_tpu_torch/optimize.py`) held against `optax.lbfgs()` step by step on
analytic problems, against the committed L-BFGS goldens, and against the
JAX package's `stylize`."""
import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dpst_tpu
from dpst_tpu import optimize as jopt
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops.metrics import ssim
import dpst_tpu_torch
from dpst_tpu_torch import api as tapi
from dpst_tpu_torch import optim
from dpst_tpu_torch import optimize as topt
from dpst_tpu_torch import segmentation as tseg
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.optim import linesearch as tls

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jvgg.init_params(0)
    return jp, tvgg.params_from_numpy(jax.tree.map(np.asarray, jp))


# --- optax parity on analytic problems ------------------------------------
# Objectives of +, − and × only, summed left to right, so that JAX and
# torch evaluate them to the same bits; what differs is the optimizers'
# own reductions (vdots and norms), a few fp32 ulps a step.

def _sum(v):
    out = v[0]
    for i in range(1, v.shape[0]):
        out = out + v[i]
    return out


def _k(x, values):
    """A constant vector in x's library."""
    arr = np.asarray(values, np.float32)
    return torch.from_numpy(arr) if isinstance(x, torch.Tensor) else \
        jnp.asarray(arr)


def _quadratic(x):
    d, c = _k(x, [3.0, 1.5, 2.0, 0.8]), _k(x, [0.5, -0.4, 0.3])
    b = _k(x, [1.0, -2.0, 0.5, 3.0])
    return _sum(0.5 * d * x * x) + _sum(c * x[:-1] * x[1:]) - _sum(b * x)


PROBLEMS = {
    # convex quadratic: diagonal-dominant tridiagonal Hessian
    "quadratic": (_quadratic, [0.0, 0.0, 0.0, 0.0], 8),
    "rosenbrock": (lambda x: 100 * (x[1] - x[0] * x[0]) * (x[1] - x[0] * x[0])
                   + (1 - x[0]) * (1 - x[0]), [-1.2, 1.0], 8),
    # non-convex: a double well whose searches end in failures (17
    # evaluations, the safe step) once it sits at its minimum to fp32
    "double_well": (lambda x: _sum((x * x - 1) * (x * x - 1))
                    + 0.3 * x[0] * x[1], [0.1, -0.2, 0.05], 16),
    # non-convex sextic: long zooms through all three rules
    "sextic": (lambda x: _sum(x * x * x * x * x * x - 3 * x * x * x * x
                              + x * x * x + x), [1.7, -1.9, 0.4], 10),
}
# ρ = 1/⟨Δu, Δw⟩ of the first steps only: once an iterate sits at its
# minimum to fp32, Δu and Δw are a few ulps and ρ is their noise
RHO_STEPS = 8


def _jax_trajectory(f, x0, n):
    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(f)

    @jax.jit
    def step(x, st):
        v, g = vg(x, state=st)
        u, st = opt.update(g, st, x, value=v, grad=g, value_fn=f)
        return optax.apply_updates(x, u), st

    x = jnp.asarray(x0, jnp.float32)
    st = opt.init(x)
    out = []
    for _ in range(n):
        x, st = step(x, st)
        out.append((np.asarray(x), float(st[-1].learning_rate),
                    int(st[-1].info.num_linesearch_steps),
                    np.asarray(st[0].diff_params_memory),
                    np.asarray(st[0].diff_updates_memory),
                    np.asarray(st[0].weights_memory)))
    return out


def _torch_trajectory(f, x0, n):
    opt = optim.lbfgs()
    x = torch.tensor(x0, dtype=torch.float32)
    st = opt.init(x)

    def value_and_grad(p):
        p = p.detach().requires_grad_(True)
        v = f(p)
        (g,) = torch.autograd.grad(v, p)
        return v.detach(), g

    vg = optim.value_and_grad_from_state(value_and_grad)
    out = []
    for _ in range(n):
        v, g = vg(x, state=st)
        u, st = opt.update(g, st, x, value=v, grad=g,
                           value_and_grad_fn=value_and_grad)
        x = optim.apply_updates(x, u)
        info = st[-1].info
        out.append((x.numpy().copy(), float(st[-1].learning_rate),
                    info.num_linesearch_steps,
                    st[0].diff_params_memory.numpy().copy(),
                    st[0].diff_updates_memory.numpy().copy(),
                    st[0].weights_memory.numpy().copy(),
                    max(info.decrease_error, info.curvature_error) > 0))
    return out


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_lbfgs_matches_optax(name):
    """Step by step against optax.lbfgs() in fp32. Tolerances: the
    evaluation counts equal; parameters, Δw and Δu within 1e-4 relative
    (1e-5 of the array's largest value absolute); stepsizes and ρ (over
    the first RHO_STEPS steps) within 1e-3 relative: a zoom's cubic
    minimizer turns an ulp of a slope into a few hundred ulps of its
    stepsize (see the next tests)."""
    f, x0, n = PROBLEMS[name]
    ref = _jax_trajectory(f, x0, n)
    got = _torch_trajectory(f, x0, n)
    for i, (r, g) in enumerate(zip(ref, got)):
        msg = f"{name} step {i}"
        assert g[2] == r[2], msg + f": {g[2]} evaluations, optax {r[2]}"
        np.testing.assert_allclose(g[1], r[1], rtol=1e-3, err_msg=msg)
        for k in (0, 3, 4):
            np.testing.assert_allclose(
                g[k], r[k], rtol=1e-4,
                atol=1e-5 * float(np.abs(r[k]).max()) + 1e-30, err_msg=msg)
        if i < RHO_STEPS:
            np.testing.assert_allclose(g[5], r[5], rtol=1e-3, err_msg=msg)


def test_zoom_takes_every_rule_and_fails_safely(monkeypatch):
    """On the steps the parity test compares, the port's zoom takes the
    cubic, quadratic and bisection rules, and at least one search fails
    and returns through the safe step."""
    seen = collections.Counter()
    middle = tls._zoom_middle

    def counting(*args):
        m, rule = middle(*args)
        seen[rule] += 1
        return m, rule

    monkeypatch.setattr(tls, "_zoom_middle", counting)
    failed = sum(step[6] for f, x0, n in PROBLEMS.values()
                 for step in _torch_trajectory(f, x0, n))
    assert seen["cubic"] and seen["quadratic"] and seen["bisection"], seen
    assert failed >= 1


def test_cubic_and_quadratic_minimizers_match_optax():
    """_cubicmin and _quadmin on float32 inputs, NaN cases included (a
    negative radical, a zero-width interval): NaN where optax gives NaN;
    most results bit-equal to optax's, all within 1e-5 · (1 + |optax's|).
    The cubic's cancellations turn an ulp of the 2x2 product (optax's
    `jnp.dot`, rounded otherwise) into up to a few hundred ulps of the
    result; a float64 evaluation lies as far from either."""
    from optax._src import linesearch as ols
    r = np.random.default_rng(11)
    same = total = 0
    for _ in range(200):
        a, b, c = r.normal(size=3).astype(np.float32)
        fa, fb, fc = r.normal(size=3).astype(np.float32)
        fpa = np.float32(r.normal())
        if r.uniform() < 0.1:
            b = a
        j = [jnp.float32(v) for v in (a, fa, fpa, b, fb, c, fc)]
        ref_c = np.float32(ols._cubicmin(*j))
        ref_q = np.float32(ols._quadmin(*j[:5]))
        got_c = tls._cubicmin(a, fa, fpa, b, fb, c, fc)
        got_q = tls._quadmin(a, fa, fpa, b, fb)
        for got, ref in ((got_c, ref_c), (got_q, ref_q)):
            assert got.dtype == np.float32
            assert np.isnan(got) == np.isnan(ref)
            if np.isfinite(ref):
                assert abs(got - ref) <= 1e-5 * (1 + abs(ref)), (got, ref)
                same += bool(got == ref)
                total += 1
    assert same >= 0.8 * total, (same, total)


def test_value_and_grad_from_state_reuses_finite_cache():
    calls = []

    def vg_fn(p):
        calls.append(1)
        return torch.sum(p * p), 2 * p

    x = torch.ones(3)
    opt = optim.lbfgs()
    st = opt.init(x)
    vg = optim.value_and_grad_from_state(vg_fn)
    v, g = vg(x, state=st)                   # cached value inf: evaluates
    assert len(calls) == 1 and float(v) == 3.0
    ls_state = st[2]._replace(value=np.float32(7.0), grad=torch.zeros(3))
    v, g = vg(x, state=(st[0], st[1], ls_state))
    assert len(calls) == 1 and v == np.float32(7.0)
    nan_state = ls_state._replace(value=np.float32(np.nan))
    vg(x, state=(st[0], st[1], nan_state))
    assert len(calls) == 2


def test_logit_maps_match_jax():
    """pixels_to_logits (clipped to [1e-4, 1 − 1e-4]) and logits_to_pixels
    against JAX's: within 1e-5 relative (log1p and the sigmoid's exp round
    differently in the two libraries)."""
    r = np.random.default_rng(3)
    img = r.uniform(0, 255, (9, 7, 3)).astype(np.float32)
    img[0, 0] = [0.0, 255.0, 0.01]
    ref = np.asarray(jopt.pixels_to_logits(jnp.asarray(img)))
    got = topt.pixels_to_logits(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    u = r.normal(scale=4, size=(9, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        topt.logits_to_pixels(torch.from_numpy(u)).numpy(),
        np.asarray(jopt.logits_to_pixels(jnp.asarray(u))), rtol=1e-5,
        atol=1e-4)
    back = topt.logits_to_pixels(topt.pixels_to_logits(
        torch.from_numpy(img))).numpy()
    np.testing.assert_allclose(back, np.clip(img, 0.0255, 254.9745),
                               atol=2e-3)


def test_history_terms_resolution():
    cfg = dpst_tpu_torch.StylizeConfig
    assert topt.history_terms(cfg(history_terms="total")) == "full"
    assert topt.history_terms(cfg(optimizer="lbfgs")) == "total"
    assert topt.history_terms(cfg(optimizer="lbfgs",
                                  history_terms="full")) == "full"


# --- the committed goldens (tests/test_golden.py:77-155) ------------------

def _golden_pair():
    r = np.random.default_rng(1234)
    content = r.uniform(0, 255, (48, 48, 3)).astype(np.float32)
    style = r.uniform(0, 255, (48, 48, 3)).astype(np.float32)
    return content, style


GOLDEN_CFG = dict(use_segmentation=False, use_photorealism=True,
                  laplacian_impl="xla", compute_dtype="float32",
                  iterations=40, optimizer="lbfgs",
                  regularization_weight=100.0)


def test_golden_lbfgs_config3(params):
    """tests/test_golden.py's bounds: SSIM >= 0.98 against the golden
    image, the loss curve within 8e-2 relative (1e-2 on the first 10
    steps), a loss reduction above 10x; the history's columns 1-4 are
    zeros (history_terms "auto" records the cached total only)."""
    content, style = _golden_pair()
    cfg = dpst_tpu_torch.StylizeConfig(**GOLDEN_CFG)
    with topt.record_evaluations() as rec:
        out, hist = dpst_tpu_torch.stylize(content, style, cfg,
                                           vgg_params=params[1],
                                           return_history=True, device="cpu")
    golden = np.load(os.path.join(GOLDEN_DIR, "lbfgs_config3_48px.npy"))
    assert float(ssim(out, golden)) >= 0.98
    golden_loss = np.load(os.path.join(GOLDEN_DIR,
                                       "lbfgs_config3_48px_loss.npy"))
    np.testing.assert_allclose(hist[:, 0], golden_loss, rtol=8e-2)
    np.testing.assert_allclose(hist[:10, 0], golden_loss[:10], rtol=1e-2)
    assert hist[0, 0] / hist[-1, 0] > 10.0
    assert not hist[:, 1:].any()
    # one evaluation afresh (the first step), every other one the
    # linesearch's: E = 1 + Σ num_linesearch_steps
    assert len(rec) == 40
    assert sum(r["evaluations"] for r in rec) == 1 + sum(
        r["num_linesearch_steps"] for r in rec)


def test_golden_lbfgs_eval_counts(params):
    """lbfgs_eval_trajectory against the golden evaluation counts: ±2 a
    step, ±4 in total (tests/test_golden.py:150-155), and its loss curve
    within 8e-2 of the golden's."""
    content, style = _golden_pair()
    cfg = dpst_tpu_torch.StylizeConfig(**GOLDEN_CFG)
    mask = torch.from_numpy(tseg.uniform_masks((48, 48)))
    vgg_params = tvgg.pack_params(params[1], "float32", "xla")
    consts = dpst_tpu_torch.prepare_constants(
        torch.from_numpy(content), torch.from_numpy(style), mask, mask, cfg,
        vgg_params)
    opt = topt.make_optimizer(cfg)
    img0 = topt.init_image(cfg, torch.from_numpy(content))
    st = topt.init_opt_state(opt, cfg, img0)
    hist, evals = topt.lbfgs_eval_trajectory(
        img0, st, consts, topt.LossWeights.from_config(cfg), vgg_params,
        n_steps=40, cfg=cfg)
    golden_loss = np.load(os.path.join(GOLDEN_DIR,
                                       "lbfgs_config3_48px_loss.npy"))
    np.testing.assert_allclose(hist[:, 0].numpy(), golden_loss, rtol=8e-2)
    golden_evals = np.load(os.path.join(GOLDEN_DIR,
                                        "lbfgs_config3_48px_evals.npy"))
    evals = evals.numpy()
    assert np.abs(evals - golden_evals).max() <= 2, (
        evals.tolist(), golden_evals.tolist())
    assert abs(int(evals.sum()) - int(golden_evals.sum())) <= 4


# --- against the JAX package's stylize ------------------------------------

def test_unboxed_full_history_matches_jax(params):
    """The unboxed branch (clip_pixels=False: L-BFGS in pixel space, the
    clip only at the end) with history_terms="full" (every column from an
    extra forward), 32 px, 5 steps, against dpst_tpu's stylize. Tolerance:
    each column within 1e-2 relative (tests/test_golden.py's bound on the
    first L-BFGS steps: the Wolfe branches amplify sub-ulp differences),
    with an absolute floor of 1e-3 of its largest value; the image at SSIM
    >= 0.999 (tests/test_golden.py holds its L-BFGS image to 0.98) and
    within 0.5 of 255 on average."""
    r = np.random.default_rng(21)
    content = r.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    style = r.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    kw = dict(use_segmentation=False, use_photorealism=True,
              laplacian_impl="xla", compute_dtype="float32", iterations=5,
              optimizer="lbfgs", clip_pixels=False, history_terms="full",
              regularization_weight=100.0)
    jout, jh = dpst_tpu.stylize(content, style, dpst_tpu.StylizeConfig(**kw),
                                vgg_params=params[0], return_history=True)
    tout, th = dpst_tpu_torch.stylize(
        content, style, dpst_tpu_torch.StylizeConfig(**kw),
        vgg_params=params[1], return_history=True, device="cpu")
    assert th.shape == (5, 5) and th[:, 1:].any()
    for col in range(5):
        ref = np.asarray(jh[:, col])
        np.testing.assert_allclose(
            th[:, col], ref, rtol=1e-2,
            atol=1e-3 * float(np.abs(ref).max()) + 1e-12,
            err_msg=f"history column {col}")
    assert float(ssim(tout, np.asarray(jout))) >= 0.999
    assert float(np.abs(tout - np.asarray(jout)).mean()) <= 0.5
    assert tout.min() >= 0.0 and tout.max() <= 255.0


def test_multiscale_lbfgs_falls_in_each_stage(params):
    """scales=(16, 32, 48): every stage runs its steps and its loss falls;
    the output has the native size and stays in [0, 255]."""
    content, style = _golden_pair()
    cfg = dpst_tpu_torch.StylizeConfig(**dict(
        GOLDEN_CFG, iterations=8, scales=(16, 32, 48)))
    stages = tapi._scale_schedule(cfg, (48, 48))
    assert [s[:2] for s in stages] == [(16, 16), (32, 32), (48, 48)]
    out, hist = dpst_tpu_torch.stylize(content, style, cfg,
                                       vgg_params=params[1],
                                       return_history=True, device="cpu")
    assert hist.shape == (sum(s[2] for s in stages), 5)
    start = 0
    for h, w, iters in stages:
        seg = hist[start:start + iters, 0]
        assert np.isfinite(seg).all() and seg[-1] < seg[0], (h, seg)
        start += iters
    assert out.shape == (48, 48, 3)
    assert out.min() >= 0.0 and out.max() <= 255.0
