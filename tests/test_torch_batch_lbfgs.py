"""L-BFGS over a batch of pairs in the port (`optim.lbfgs(pairs=True)`,
`optimize.lbfgs_steps`): the JAX package `jax.vmap`s its
whole L-BFGS loop over the pairs, and the port runs the pairs in lockstep,
each with its own memory and zoom linesearch, every round of the searches
one batched evaluation of all B pairs.

Held against the JAX package's `stylize_batch(optimizer="lbfgs")` and
against the port's one-pair runs, at 48 px with B = 2-3 pairs. Tolerances:
the L-BFGS golden's (`tests/test_golden.py`): SSIM >= 0.98 between the
images, the loss history within rtol 1e-2 over its first 10 rows and 8e-2
over all (L-BFGS amplifies the last bits of an fp32 sum taken in another
order, here oneDNN's batched convolutions, into its stepsizes). Where the
batch rounds as one pair does (bf16 on the CPU, a batch of one) the pairs
equal their one-pair runs bit for bit. The lockstep itself is checked
exactly on a quartic objective whose pairs need different numbers of
evaluations a search."""
import jax
import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops.metrics import ssim
from dpst_tpu.parallel import batch as jbatch
from dpst_tpu.parallel import mesh as jmesh
import dpst_tpu_torch
from dpst_tpu_torch import optim
from dpst_tpu_torch import optimize as topt
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import laplacian as tlap
from dpst_tpu_torch.parallel import batch as tbatch
from dpst_tpu_torch.parallel import mesh as tmesh

SSIM_MIN, HIST10_RTOL, HIST_RTOL = 0.98, 1e-2, 8e-2   # the golden's
B, SIZE, K, STEPS = 3, 48, 2, 8


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


@pytest.fixture(scope="module")
def batch():
    """B distinct 48² pairs with K band masks each, moved on from pair to
    pair (no two pairs share a mask)."""
    r = np.random.default_rng(16)
    contents = r.uniform(0, 255, (B, SIZE, SIZE, 3)).astype(np.float32)
    styles = r.uniform(0, 255, (B, SIZE, SIZE, 3)).astype(np.float32)
    cm = np.zeros((B, K, SIZE, SIZE), np.float32)
    sm = np.zeros_like(cm)
    for i in range(B):
        cls = (np.arange(SIZE) + 5 * i) % SIZE * K // SIZE
        for j in range(K):
            cm[i, j, cls == j] = 1.0
            sm[i, j, :, cls == j] = 1.0
    return contents, styles, cm, sm


def _cfg(pkg, **kw):
    base = dict(use_segmentation=True, use_photorealism=True,
                laplacian_impl="xla", compute_dtype="float32",
                max_classes=K, iterations=STEPS, optimizer="lbfgs",
                regularization_weight=100.0)
    base.update(kw)
    return pkg.StylizeConfig(**base)


def _port_batch(batch, tparams, **kw):
    return dpst_tpu_torch.stylize_batch(
        *batch, _cfg(dpst_tpu_torch, **kw), vgg_params=tparams,
        device="cpu")


def _alone(batch, i, tparams, **kw):
    cfg = tbatch.resolve_config(_cfg(dpst_tpu_torch, **kw))
    return dpst_tpu_torch.stylize(
        batch[0][i], batch[1][i], cfg, content_masks=batch[2][i],
        style_masks=batch[3][i], vgg_params=tparams, return_history=True,
        device="cpu")


def _golden_bounds(img, hist, ref_img, ref_hist):
    assert img.shape == ref_img.shape and hist.shape == ref_hist.shape
    assert float(ssim(img, ref_img)) >= SSIM_MIN
    np.testing.assert_allclose(hist[:10, 0], ref_hist[:10, 0],
                               rtol=HIST10_RTOL)
    np.testing.assert_allclose(hist[:, 0], ref_hist[:, 0], rtol=HIST_RTOL)


@pytest.fixture(scope="module")
def port_run(batch, params):
    """The port's fp32 batch and its evaluation record."""
    with topt.record_evaluations() as rec:
        img, hist = _port_batch(batch, params[1])
    return img, hist, rec


def test_batch_lbfgs_matches_jax(batch, params, port_run):
    """The JAX package's stylize_batch with optimizer="lbfgs" (its vmapped
    optax L-BFGS) on a mesh of one CPU device: each pair within the
    golden's bounds; the loss falls for every pair."""
    img, hist, _ = port_run
    ref_img, ref_hist = jbatch.stylize_batch(
        *batch, cfg=_cfg(dpst_tpu), vgg_params=params[0],
        mesh=jmesh.make_mesh(1))
    assert hist.shape == (B, STEPS, 5) and not hist[..., 1:].any()
    assert (hist[:, -1, 0] < hist[:, 0, 0]).all()
    for i in range(B):
        _golden_bounds(img[i], hist[i], np.asarray(ref_img[i]),
                       np.asarray(ref_hist[i]))


def test_batch_lbfgs_matches_one_pair_runs(batch, params, port_run):
    """Each pair against the port's one-pair run of the batch's resolved
    config: the golden's bounds and, step by step, the same evaluations
    (`record_evaluations` gives each pair's own count); a round of the
    batch is one batched evaluation, as many a step as the pair that
    searched longest (plus the first step's fresh one)."""
    img, hist, rec = port_run
    assert len(rec) == STEPS
    for i in range(B):
        with topt.record_evaluations() as rec_i:
            out, h = _alone(batch, i, params[1])
        _golden_bounds(img[i], hist[i], out, h)
        assert [r["pairs"][i]["evaluations"] for r in rec] == [
            r["evaluations"] for r in rec_i]
    for s, r in enumerate(rec):
        assert r["evaluations"] == max(p["num_linesearch_steps"]
                                       for p in r["pairs"]) + (s == 0)


def test_one_pair_batch_is_the_one_pair_loop(batch, params):
    """One pair's L-BFGS in the port's loop (a batch of one through
    optim.lbfgs(pairs=True)) is the one-pair chain optim.lbfgs()
    (optax.lbfgs()) driven step by step, bit for bit: the image, the
    history, and each step's evaluations, search and trace."""
    cfg = tbatch.resolve_config(_cfg(dpst_tpu_torch, iterations=4))
    arrays = [torch.from_numpy(a[0]) for a in batch]
    consts = dpst_tpu_torch.prepare_constants(*arrays, cfg, params[1])
    weights = topt.LossWeights.from_config(cfg)
    image0 = topt.init_image(cfg, arrays[0], torch.mean(
        arrays[1], dim=(-3, -2), keepdim=True))
    with topt.record_evaluations() as rec:
        img, _, hist = topt.run_segment(
            image0, topt.init_opt_state(topt.make_optimizer(cfg), cfg,
                                        image0),
            consts, weights, params[1], 4, cfg)
    loss_fn = topt.make_loss_fn(cfg)
    calls = []

    def value_and_grad_fn(u):
        calls.append(u)
        with torch.enable_grad():
            u = u.detach().requires_grad_(True)
            total, _ = loss_fn(topt.logits_to_pixels(u), consts, weights,
                               params[1])
            (g,) = torch.autograd.grad(total, u)
        return total.detach(), g

    opt = optim.lbfgs()
    u = topt.pixels_to_logits(image0)
    st = opt.init(u)
    vg = optim.value_and_grad_from_state(value_and_grad_fn)
    rows, ref_rec = [], []
    with torch.no_grad():
        for _ in range(4):
            before = len(calls)
            value, grad = vg(u, state=st)
            rows.append(float(value))
            trace = []
            updates, st = opt.update(grad, st, u, value=value, grad=grad,
                                     value_and_grad_fn=value_and_grad_fn,
                                     trace=trace)
            u = optim.apply_updates(u, updates)
            info = st[-1].info
            ref_rec.append({
                "evaluations": len(calls) - before,
                "num_linesearch_steps": info.num_linesearch_steps,
                "decrease_error": float(info.decrease_error),
                "curvature_error": float(info.curvature_error),
                "value_finite": bool(np.isfinite(st[-1].value)),
                "trace": trace})
    np.testing.assert_array_equal(hist[:, 0].numpy(),
                                  np.asarray(rows, np.float32))
    assert not hist[:, 1:].any()
    assert torch.equal(img, topt.logits_to_pixels(u))
    assert [r["pairs"][0] for r in rec] == ref_rec
    assert [r["evaluations"] for r in rec] == [r["evaluations"]
                                               for r in ref_rec]


def test_per_pair_weights_are_each_pairs_run(batch, params):
    """The Γ sweep's form (autotune): one pair's constants shared by B
    candidates with per-pair style weights, in bf16 (where the CPU's batch
    rounds as one pair does): each candidate is the one-pair loop at its
    weight, bit for bit, evaluation counts included."""
    cfg = tbatch.resolve_config(_cfg(dpst_tpu_torch, iterations=4,
                                     compute_dtype="bfloat16"))
    arrays = [torch.from_numpy(a[0]) for a in batch]
    consts = dpst_tpu_torch.prepare_constants(*arrays, cfg, params[1])
    gammas = np.asarray([10.0, 300.0, 3000.0], np.float32)
    base = topt.LossWeights.from_config(cfg)
    weights = base._replace(style=gammas, content=np.full(3, base.content,
                                                         np.float32),
                            reg=np.full(3, base.reg, np.float32),
                            tv=np.full(3, base.tv, np.float32))
    image0 = topt.init_image(cfg, arrays[0])
    shared = consts.map(lambda t: t[None].expand(3, *t.shape))
    with topt.record_evaluations() as rec:
        images, hist = tbatch.run_batch(
            image0[None].expand(3, -1, -1, -1).contiguous(), shared, weights,
            params[1], cfg, 4, per_pair_weights=True)
    for i, g in enumerate(gammas):
        w = base._replace(style=float(g))
        opt = topt.make_optimizer(cfg)
        with topt.record_evaluations() as rec_i:
            out, _, h = topt.run_segment(
                image0, topt.init_opt_state(opt, cfg, image0), consts, w,
                params[1], 4, cfg)
        assert torch.equal(hist[i], h)
        assert torch.equal(images[i], out)
        assert [r["pairs"][i] for r in rec] == [r["pairs"][0]
                                                for r in rec_i]


def test_row_mesh_batch_takes_the_batched_loop(batch, params):
    """stylize_batch over a (1 × 2) mesh: the B pairs one share,
    row-sharded over two devices, through one batched loop (each step one
    record with every pair's own), each pair within the golden's bounds
    of the one-device batch."""
    with topt.record_evaluations() as rec:
        img, hist = dpst_tpu_torch.stylize_batch(
            *batch, _cfg(dpst_tpu_torch, iterations=5),
            vgg_params=params[1],
            mesh=tmesh.make_mesh_2d(1, 2, devices=["cpu"] * 2))
    ref_img, ref_hist = dpst_tpu_torch.stylize_batch(
        *batch, _cfg(dpst_tpu_torch, iterations=5).spmd_safe(),
        vgg_params=params[1], device="cpu")
    assert len(rec) == 5 and all(len(r["pairs"]) == B for r in rec)
    for i in range(B):
        _golden_bounds(img[i], hist[i], ref_img[i], ref_hist[i])


def test_batch_lbfgs_debug_nans_names_the_pair(batch, params):
    contents = batch[0].copy()
    contents[1, 3, 4, 1] = np.nan
    with pytest.raises(FloatingPointError, match="step 0, pair 1"):
        _port_batch((contents,) + batch[1:], params[1], debug_nans=True)


# --- the lockstep, exactly -------------------------------------------------

def _quartic(targets, scales):
    """f_i(x) = Σ s_i · (x − t_i)⁴ of each pair, one value a pair, and its
    gradient; its one-pair form on pair i."""
    def batched(x):
        d = x - targets
        return (torch.sum(scales * d ** 4, dim=(1, 2, 3)),
                4.0 * scales * d ** 3)

    def one(i):
        def f(x):
            d = x - targets[i]
            return torch.sum(scales[i] * d ** 4), 4.0 * scales[i] * d ** 3
        return f
    return batched, one


def test_lockstep_is_each_pairs_own_search():
    """optim.lbfgs(pairs=True) on pairs whose searches take different
    numbers of evaluations: each pair's updates, memory and linesearch
    trace are its own optim.lbfgs() run's bit for bit, every round
    evaluates all pairs once, and a round count is the longest search's."""
    r = np.random.default_rng(3)
    b = 3
    targets = torch.from_numpy(r.normal(size=(b, 5, 6, 3)).astype(
        np.float32))
    scales = torch.from_numpy(np.asarray(
        [1e-3, 1.0, 40.0], np.float32)).reshape(b, 1, 1, 1)
    batched, one = _quartic(targets, scales)
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return batched(x)

    opt_b = optim.lbfgs(pairs=True)
    x_b = torch.zeros((b, 5, 6, 3))
    st_b = opt_b.init(x_b)
    vg_b = optim.value_and_grad_from_state(counted, pairs=True)
    singles = []
    for i in range(b):
        opt = optim.lbfgs()
        x = torch.zeros((5, 6, 3))
        singles.append([opt, x, opt.init(x),
                        optim.value_and_grad_from_state(one(i))])
    counts = set()
    for _ in range(6):
        traces = []
        calls.clear()
        v, g = vg_b(x_b, state=st_b)
        u_b, st_b = opt_b.update(g, st_b, x_b, value=v, grad=g,
                                 value_and_grad_fn=counted, trace=traces)
        x_b = optim.apply_updates(x_b, u_b)
        assert calls and all(n == b for n in calls)
        assert st_b[2].rounds == max(i.num_linesearch_steps
                                     for i in st_b[2].info)
        for i, s in enumerate(singles):
            opt, x, st, vg = s
            tr = []
            v1, g1 = vg(x, state=st)
            u1, st = opt.update(g1, st, x, value=v1, grad=g1,
                                value_and_grad_fn=one(i), trace=tr)
            s[1], s[2] = optim.apply_updates(x, u1), st
            assert torch.equal(u_b[i], u1)
            assert traces[i] == tr
            assert torch.equal(st_b[0].weights_memory[:, i],
                               st[0].weights_memory)
            counts.add(len(tr))
    assert len(counts) > 1, "every pair searched alike: no lockstep shown"


def test_value_and_grad_from_state_refreshes_only_stale_pairs():
    """A batch whose cached values are finite for some pairs only: one
    batched evaluation, whose value and gradient the stale pairs take,
    the others keeping their cache."""
    x = torch.arange(2 * 3 * 4 * 3, dtype=torch.float32).reshape(2, 3, 4, 3)
    fresh = (torch.tensor([7.0, 8.0]), -x)
    calls = []

    def fn(p):
        calls.append(p)
        return fresh
    vg = optim.value_and_grad_from_state(fn, pairs=True)
    cached = x + 100.0
    state = (optim.linesearch.ScaleByZoomLinesearchBatchState(
        learning_rate=[1.0, 1.0], value=[np.float32(3.0),
                                         np.float32(np.inf)],
        grad=cached, info=[], rounds=0),)
    values, grad = vg(x, state=state)
    assert len(calls) == 1
    assert values[0] == np.float32(3.0) and float(values[1]) == 8.0
    assert torch.equal(grad[0], cached[0]) and torch.equal(grad[1], -x[1])
    state = (state[0]._replace(value=[np.float32(1.0), np.float32(2.0)]),)
    values, grad = vg(x, state=state)
    assert values == [np.float32(1.0), np.float32(2.0)] and grad is cached
    assert len(calls) == 1


@pytest.mark.parametrize("shards", [1, 3])
def test_pair_vdot_is_each_pairs_vdot(shards):
    """pair_vdot: each pair's dot product in the order vdot sums that pair
    alone, bit for bit, also of a channels-first gradient's layout (which
    stack_pairs keeps) and over row shards."""
    r = np.random.default_rng(shards)
    mk = lambda rows: torch.from_numpy(r.normal(size=(3, 3, rows, 7)).astype(
        np.float32)).movedim(1, -1)                # (B, rows, 7, 3), NCHW
    a = [mk(4 + i) for i in range(shards)]
    c = [mk(4 + i) for i in range(shards)]
    va, vc = (a[0], c[0]) if shards == 1 else (a, c)
    got = optim.pair_vdot(va, vc)
    for i in range(3):
        want = optim.vdot(optim.base.pair_of(va, i),
                          optim.base.pair_of(vc, i))
        assert torch.equal(got[i], want)
    st = optim.base.stack_pairs([optim.base.pair_of(va, i)
                                 for i in range(3)])
    for x, y in zip(st if shards > 1 else [st], a):
        assert x.stride() == y.stride() and torch.equal(x, y)


# --- the card's divisions (the 64² L-BFGS divergence, repaired) ------------

def test_loss_divisions_are_one_rounding_on_every_device():
    """Where the card divided by a Python scalar it multiplied by the
    reciprocal, which rounds apart from the CPU's division in about one
    element of ten: the Laplacian's window means (whose covariance cancels
    those bits into Λ ≈ 1e6: Λ differed by 2.3e-5 of its largest
    entry, card against CPU) and the logit map. Each is now `exact_div`,
    a division by a 0-d tensor on the operand's device: on the CPU the
    same bits as the division by the number, which the reciprocal's
    product does not give."""
    r = np.random.default_rng(9)
    img = torch.from_numpy(r.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    stats = tlap.precompute_stats(img)
    box = tlap._box3(img)
    assert torch.equal(stats.mu[1:-1, 1:-1], (box / 9.0)[1:-1, 1:-1])
    assert not torch.equal(box / 9.0, box * (1.0 / 9.0))
    x = torch.from_numpy(r.uniform(0, 255, (64,)).astype(np.float32))
    assert torch.equal(tlap.exact_div(x, 255.0), x / 255.0)
    assert not torch.equal(x / 255.0, x * (1.0 / 255.0))
    u = topt.pixels_to_logits(x.reshape(4, 16, 1).expand(4, 16, 3))
    p = torch.clamp(x / 255.0, 1e-4, 1 - 1e-4).reshape(4, 16, 1)
    assert torch.equal(u[..., 0:1], torch.log(p) - torch.log1p(-p))


class _AsCuda(torch.Tensor):
    """A CPU tensor that reports itself on the card (the routing only)."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("padding", [1, (0, 1)])
def test_fp32_convs_on_the_card_leave_cudnn(monkeypatch, padding):
    """cuDNN's fp32 convs rounded a 64² L-BFGS run on the card away from
    the CPU's (SSIM 0.80 after 10 steps) and a row-sharded run from the
    unsharded one (0.94): `vgg.conv2d` sends an fp32 tensor on the card to
    ATen's own convolution, cuDNN off for the forward and for the input
    gradient (the two calls under cuDNN's flag seen here), the same
    function as F.conv2d bit for bit; every tensor on the CPU keeps one
    F.conv2d; a bf16 batch on the card takes F.conv2d (cuDNN) one image a
    call, forward and input gradient each image's alone bit for bit (a
    bf16 L-BFGS batch's pairs then meet their runs alone)."""
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.normal(size=(2, 6, 7, 9)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(4, 6, 3, 3)).astype(np.float32))
    seen = []
    conv, conv_input = torch.nn.functional.conv2d, torch.nn.grad.conv2d_input

    def spy(fn, name):
        def call(*a, **kw):
            seen.append((name, torch.backends.cudnn.enabled))
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(torch.nn.functional, "conv2d", spy(conv, "fwd"))
    monkeypatch.setattr(torch.nn.grad, "conv2d_input",
                        spy(conv_input, "bwd"))
    xc = x.as_subclass(_AsCuda).requires_grad_(True)
    y = tvgg.conv2d(xc, w, padding=padding)
    g = torch.from_numpy(r.normal(size=y.shape).astype(np.float32))
    (gx,) = torch.autograd.grad(y, xc, g)
    assert seen == [("fwd", False), ("bwd", False)]
    assert torch.backends.cudnn.enabled
    xr = x.clone().requires_grad_(True)
    ref = conv(xr, w, padding=padding)
    (gref,) = torch.autograd.grad(ref, xr, g)
    assert torch.equal(y.as_subclass(torch.Tensor), ref)
    assert torch.equal(gx.as_subclass(torch.Tensor), gref)
    seen.clear()
    tvgg.conv2d(x, w, padding=padding)
    assert seen == [("fwd", True)]
    # bf16 on the card: cuDNN one image a call, forward and backward as
    # each image alone (a batch's bf16 rounds as its images alone do)
    seen.clear()
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    xbc = xb.as_subclass(_AsCuda).requires_grad_(True)
    y = tvgg.conv2d(xbc, wb, padding=padding)
    assert seen == [("fwd", True), ("fwd", True)]
    (gx,) = torch.autograd.grad(y, xbc, g.to(torch.bfloat16))
    for i in range(x.shape[0]):
        xi = xb[i:i + 1].clone().requires_grad_(True)
        yi = conv(xi, wb, padding=padding)
        (gi,) = torch.autograd.grad(yi, xi, g[i:i + 1].to(torch.bfloat16))
        assert torch.equal(y[i:i + 1].as_subclass(torch.Tensor), yi)
        assert torch.equal(gx[i:i + 1].as_subclass(torch.Tensor), gi)


def test_lbfgs_64_search_decisions_are_jax_on_the_cpu(params):
    """The 64² fp32 setting of chip_smoke's L-BFGS references (photo-like
    images, three stripe masks, regularization 100, 10 steps): on the CPU
    the port's one-pair trajectory takes the JAX package's
    `lbfgs_eval_trajectory` decisions, the same evaluations at every step,
    and stays within the golden's bounds of its history (on the card the
    same holds since its fp32 convs left cuDNN; PERF.md, PR 16)."""
    import jax.numpy as jnp
    from dpst_tpu import optimize as jopt
    r = np.random.default_rng(64)

    def photo():
        low = torch.from_numpy(r.uniform(0, 1, (1, 3, 2, 2)).astype(
            np.float32))
        img = torch.nn.functional.interpolate(
            low, size=(64, 64), mode="bicubic", align_corners=False)[0]
        img = img.permute(1, 2, 0).numpy() + 0.05 * r.normal(
            size=(64, 64, 3)).astype(np.float32)
        return (np.clip(img, 0, 1) * 255).astype(np.float32)
    content, style = photo(), photo()
    cm = np.zeros((3, 64, 64), np.float32)
    sm = np.zeros_like(cm)
    for i in range(3):
        cm[i, i * 64 // 3:(i + 1) * 64 // 3] = 1.0
        sm[i, :, i * 64 // 3:(i + 1) * 64 // 3] = 1.0
    kw = dict(compute_dtype="float32", iterations=10, optimizer="lbfgs",
              regularization_weight=100.0, laplacian_impl="xla")
    jcfg = dpst_tpu.StylizeConfig(**kw)
    jconsts = dpst_tpu.prepare_constants(
        jnp.asarray(content), jnp.asarray(style), jnp.asarray(cm),
        jnp.asarray(sm), jcfg, params[0])
    jloop = jcfg.loop_config()
    jopt_ = jopt.make_optimizer(jloop)
    jimg0 = jopt.init_image(jcfg, jnp.asarray(content))
    jhist, jevals = jopt.lbfgs_eval_trajectory(
        jimg0, jopt.init_opt_state(jopt_, jloop, jimg0), jconsts,
        jopt.LossWeights.from_config(jcfg), params[0], n_steps=10,
        cfg=jloop)
    tcfg = dpst_tpu_torch.StylizeConfig(**kw)
    arrays = [torch.from_numpy(a) for a in (content, style, cm, sm)]
    tconsts = dpst_tpu_torch.prepare_constants(*arrays, tcfg, params[1])
    timg0 = topt.init_image(tcfg, arrays[0])
    opt = topt.make_optimizer(tcfg)
    thist, tevals = topt.lbfgs_eval_trajectory(
        timg0, topt.init_opt_state(opt, tcfg, timg0), tconsts,
        topt.LossWeights.from_config(tcfg), params[1], n_steps=10, cfg=tcfg)
    assert tevals.tolist() == np.asarray(jevals).tolist()
    np.testing.assert_allclose(thist[:, 0].numpy(), np.asarray(jhist[:, 0]),
                               rtol=HIST10_RTOL)
