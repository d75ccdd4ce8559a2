"""The port's batched stylization (`dpst_tpu_torch.stylize_batch`,
`parallel/batch.py`) against the JAX package's `stylize_batch` on a
1-device mesh, against the port's own `stylize` pair by pair, and the
batched wrappers of the five kernels with a batch grid dimension against
loops of their one-pair calls and the JAX kernels under `jax.vmap`.

Every batch holds distinct pairs AND distinct masks per pair (bands moved
on by a few pixels from one pair to the next), so that a kernel or a loss
that read another pair's operands would show. Weights are the JAX
package's He init carried across with `vgg.params_from_numpy`.

Tolerances (fp32): histories rtol 1e-3 per column with a floor of 1e-3 of
the column's largest value (`tests/test_torch_stylize.py`); images rtol
1e-2, atol 0.25 of [0, 255] and histories rtol 1e-3 — the JAX package's own
batch ≡ sequential bounds (`tests/test_sharding.py`). Port batch ≡ port
sequential: those bounds in fp32 (oneDNN's fp32 convolutions round a batch
apart from one image: `test_torch_autotune.py::
test_fp32_batch_rounding_is_the_convs`), bit for bit in bf16. Batched plain
kernels ≡ a loop of their 2-D calls: bit for bit; against the JAX kernels
under vmap (interpreted off-TPU): rtol 1e-5 with a floor of 1e-5 of
max|ref|, as the one-pair kernel tests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpst_tpu
from dpst_tpu import optimize as jopt
from dpst_tpu.models import vgg as jvgg
from dpst_tpu.ops import gram_stream as jgs
from dpst_tpu.ops import laplacian as jlap
from dpst_tpu.ops import laplacian_pallas as jlap_pallas
from dpst_tpu.parallel import batch as jbatch
from dpst_tpu.parallel import mesh as jmesh
import dpst_tpu_torch
from dpst_tpu_torch import optimize as topt
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import conv_cuda as tconv
from dpst_tpu_torch.ops import gram_pallas as tgp
from dpst_tpu_torch.ops import gram_s2d as tg2
from dpst_tpu_torch.ops import gram_stream as tgs
from dpst_tpu_torch.ops import kernels
from dpst_tpu_torch.ops import laplacian as tlap
from dpst_tpu_torch.ops import laplacian_cuda as tlapc
from dpst_tpu_torch.parallel import batch as tbatch

HIST_RTOL = 1e-3
PIX_RTOL, PIX_ATOL = 1e-2, 0.25
KERNEL_RTOL = 1e-5


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


def _masks(b, k, h, w, shift=3):
    """k band masks a pair, distinct per pair: content bands across the
    rows, style bands across the columns, both moved on by `shift` pixels
    from one pair to the next."""
    cm = np.zeros((b, k, h, w), np.float32)
    sm = np.zeros((b, k, h, w), np.float32)
    for i in range(b):
        rows = np.minimum((np.arange(h) + i * shift) % h * k // h, k - 1)
        cols = np.minimum((np.arange(w) + i * shift) % w * k // w, k - 1)
        for j in range(k):
            cm[i, j, rows == j] = 1.0
            sm[i, j, :, cols == j] = 1.0
    return cm, sm


@pytest.fixture(scope="module")
def toy_batch():
    """test_sharding.py's toy batch (B = 4, 24², K = 2), with masks
    distinct per pair."""
    r = np.random.default_rng(31)
    b, h, w, k = 4, 24, 24, 2
    contents = r.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    styles = r.uniform(0, 255, (b, h, w, 3)).astype(np.float32)
    return (contents, styles) + _masks(b, k, h, w)


def _cfg(pkg, **kw):
    base = dict(use_segmentation=True, use_photorealism=True,
                laplacian_impl="xla", compute_dtype="float32",
                max_classes=2, iterations=8)
    base.update(kw)
    return pkg.StylizeConfig(**base)


def _close_hist(got, ref, msg=""):
    for col in range(ref.shape[-1]):
        r = ref[..., col]
        np.testing.assert_allclose(
            got[..., col], r, rtol=HIST_RTOL,
            atol=HIST_RTOL * float(np.abs(r).max()) + 1e-12,
            err_msg=f"{msg} history column {col}")


def _jax_batch(batch, cfg_kw, jparams, **kw):
    images, hist = jbatch.stylize_batch(
        *batch, cfg=_cfg(dpst_tpu, **cfg_kw), vgg_params=jparams,
        mesh=jmesh.make_mesh(1), **kw)
    return np.asarray(images), np.asarray(hist)


def _port_batch(batch, cfg_kw, tparams, **kw):
    return dpst_tpu_torch.stylize_batch(
        *batch, _cfg(dpst_tpu_torch, **cfg_kw), vgg_params=tparams,
        device="cpu", **kw)


def test_batch_matches_jax(toy_batch, params):
    """B = 4, 24², K = 2, fp32, eight Adam steps: images and every history
    column against the JAX package's stylize_batch."""
    ref_img, ref_hist = _jax_batch(toy_batch, {}, params[0])
    img, hist = _port_batch(toy_batch, {}, params[1])
    assert img.shape == (4, 24, 24, 3) and hist.shape == (4, 8, 5)
    _close_hist(hist, ref_hist)
    np.testing.assert_allclose(img, ref_img, rtol=PIX_RTOL, atol=PIX_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_matches_sequential(toy_batch, params, dtype):
    """Each pair of the batch against the port's `stylize` of that pair
    alone, under the batch's resolved config: bit for bit in bf16; in fp32
    within the JAX package's batch ≡ sequential bounds."""
    cfg_kw = dict(compute_dtype=dtype)
    img, hist = _port_batch(toy_batch, cfg_kw, params[1])
    cfg = tbatch.resolve_config(_cfg(dpst_tpu_torch, **cfg_kw))
    contents, styles, cm, sm = toy_batch
    for i in range(contents.shape[0]):
        out, h = dpst_tpu_torch.stylize(
            contents[i], styles[i], cfg, content_masks=cm[i],
            style_masks=sm[i], vgg_params=params[1], return_history=True,
            device="cpu")
        if dtype == "bfloat16":
            np.testing.assert_array_equal(img[i], out)
            np.testing.assert_array_equal(hist[i], h)
        else:
            np.testing.assert_allclose(img[i], out, rtol=PIX_RTOL,
                                       atol=PIX_ATOL, err_msg=f"pair {i}")
            np.testing.assert_allclose(hist[i, :, 0], h[:, 0],
                                       rtol=HIST_RTOL, err_msg=f"pair {i}")


def test_pallas_route_batch_matches_sequential(toy_batch, params):
    """conv_impl="pallas" and gram_impl="pallas" on a batch of two (the
    conv kernel and gram_wbwd each one launch for both pairs on the card,
    the pair a grid index, each pair split as one pair's plan splits it),
    bf16: each pair equals its `stylize` run alone bit for bit."""
    small = tuple(a[:2] for a in toy_batch)
    cfg_kw = dict(compute_dtype="bfloat16", conv_impl="pallas",
                  gram_impl="pallas", iterations=2)
    img, hist = _port_batch(small, cfg_kw, params[1])
    cfg = tbatch.resolve_config(_cfg(dpst_tpu_torch, **cfg_kw))
    for i in range(2):
        out, h = dpst_tpu_torch.stylize(
            small[0][i], small[1][i], cfg, content_masks=small[2][i],
            style_masks=small[3][i], vgg_params=params[1],
            return_history=True, device="cpu")
        np.testing.assert_array_equal(img[i], out)
        np.testing.assert_array_equal(hist[i], h)


def test_per_pair_weights(toy_batch, params):
    """test_sharding.py:72's two properties (zero Γ: total = content at
    every step; Γ rising: the first total rising), and the run against
    JAX's with the same per-pair weights."""
    gammas = np.asarray([0.0, 10.0, 100.0, 1000.0], np.float32)
    cfg_kw = dict(use_photorealism=False, iterations=5)
    jw = jopt.LossWeights(content=jnp.ones(4), style=jnp.asarray(gammas),
                          reg=jnp.zeros(4), tv=jnp.zeros(4))
    tw = topt.LossWeights(content=np.ones(4, np.float32), style=gammas,
                          reg=np.zeros(4, np.float32),
                          tv=np.zeros(4, np.float32))
    img, hist = _port_batch(toy_batch, cfg_kw, params[1], weights=tw,
                            per_pair_weights=True)
    np.testing.assert_allclose(hist[0, :, 0], hist[0, :, 1], rtol=1e-5)
    assert np.all(np.diff(hist[:, 0, 0]) > 0), hist[:, 0, 0]
    ref_img, ref_hist = _jax_batch(toy_batch, cfg_kw, params[0], weights=jw,
                                   per_pair_weights=True)
    _close_hist(hist, ref_hist)
    np.testing.assert_allclose(img, ref_img, rtol=PIX_RTOL, atol=PIX_ATOL)
    with pytest.raises(ValueError, match=r"\(4,\)"):
        _port_batch(toy_batch, cfg_kw, params[1], weights=tw._replace(
            style=gammas[:3]), per_pair_weights=True)


def test_batch_multiscale_matches_jax(toy_batch, params):
    """scales=(12, 24), five steps a stage, as test_sharding.py:157: the
    final images at the native size, ten history rows, against JAX's."""
    cfg_kw = dict(iterations=5, scales=(12, 24))
    img, hist = _port_batch(toy_batch, cfg_kw, params[1])
    assert img.shape == toy_batch[0].shape and hist.shape == (4, 10, 5)
    ref_img, ref_hist = _jax_batch(toy_batch, cfg_kw, params[0])
    _close_hist(hist, ref_hist)
    np.testing.assert_allclose(img, ref_img, rtol=PIX_RTOL, atol=PIX_ATOL)


def test_fused_block1_route_matches_jax(params):
    """test_sharding.py:195 at 128², B = 2: the JAX package's run_batch
    with s2d_gram="pallas" (its vmapped s2d Gram kernel, interpreted)
    against the port's run_batch, which sends conv1_1 to the fused
    bias+ReLU Gram pair (`gram_relu_fwd` / `gram_relu_bwd`, their plain
    versions here), three steps."""
    r = np.random.default_rng(7)
    b, size = 2, 128
    contents = r.uniform(0, 255, (b, size, size, 3)).astype(np.float32)
    styles = r.uniform(0, 255, (b, size, size, 3)).astype(np.float32)
    cm, sm = _masks(b, 2, size, size, shift=9)
    kw = dict(s2b_strips=0, block1_impl="s2d", s2d_gram="pallas",
              iterations=3)
    jcfg = _cfg(dpst_tpu, **kw)
    mesh = jmesh.make_mesh(1)
    p = jmesh.replicate(params[0], mesh)
    jb = [jax.device_put(jnp.asarray(a), s) for a, s in zip(
        (contents, styles, cm, sm),
        (jmesh.image_sharding(mesh),) * 2 + (jmesh.mask_sharding(mesh),) * 2)]
    consts, cs, smean = jbatch.prepare_batch_stage(
        *jb, p, (size, size), jcfg.prepare_config())
    images = jax.vmap(lambda c, m: jopt.init_image(jcfg, c, m))(cs, smean)
    _, ref = jbatch.run_batch(
        images, consts, jmesh.replicate(jopt.LossWeights.from_config(jcfg),
                                        mesh), p, jcfg.loop_config(), 3)

    tcfg = _cfg(dpst_tpu_torch, **kw)
    tp = tvgg.pack_params(params[1], "float32")
    tb = [torch.from_numpy(a) for a in (contents, styles, cm, sm)]
    tconsts, tcs, tmean = tbatch.prepare_batch_stage(*tb, tp, (size, size),
                                                     tcfg)
    assert topt.fused_block1_taps(tcfg, (size, size, 3), {
        l: m[0] for l, m in tconsts.masks.items()}) == ("conv1_1",)
    kernels_before = dict(kernels.LAUNCHES)
    calls = []
    real = tg2.GramReluRaw.apply
    tg2.GramReluRaw.apply = lambda *a: (calls.append(a[0].shape), real(*a))[1]
    try:
        _, hist = tbatch.run_batch(topt.init_image(tcfg, tcs, tmean),
                                   tconsts,
                                   topt.LossWeights.from_config(tcfg), tp,
                                   tcfg, 3)
    finally:
        tg2.GramReluRaw.apply = real
    assert calls == [(b, 64, size * size)] * 3     # one batched call a step
    assert kernels.LAUNCHES == kernels_before      # CPU: plain versions
    _close_hist(hist.numpy(), np.asarray(ref))


def test_routing(toy_batch, params, monkeypatch):
    """The config a batch runs (test_sharding.py:244, one device):
    s2d_gram "auto" → "pallas", s2b_strips → 0, laplacian_impl "spmd" →
    the XLA stencil (where `stylize` outside an ambient mesh raises the
    JAX package's ValueError), others kept."""
    seen = []
    real = tbatch.batch_steps
    monkeypatch.setattr(tbatch, "batch_steps",
                        lambda *a, **k: (seen.append(a[4]), real(*a, **k))[1])
    small = (toy_batch[0][:2, :16, :16], toy_batch[1][:2, :16, :16],
             toy_batch[2][:2, :, :16, :16], toy_batch[3][:2, :, :16, :16])
    cfg_kw = dict(iterations=1, s2b_strips=-1, laplacian_impl="spmd")
    _port_batch(small, cfg_kw, params[1])
    cfg = seen[-1]
    assert (cfg.s2d_gram, cfg.s2b_strips, cfg.laplacian_impl) == (
        "pallas", 0, "xla")
    with pytest.raises(ValueError, match="ambient mesh"):
        dpst_tpu_torch.stylize(small[0][0], small[1][0],
                               _cfg(dpst_tpu_torch, **cfg_kw),
                               content_masks=small[2][0],
                               style_masks=small[3][0],
                               vgg_params=params[1], device="cpu")
    kept = _cfg(dpst_tpu_torch, s2d_gram="nd", s2b_strips=0)
    assert tbatch.resolve_config(kept) is kept
    # prepare_batch: the batched precompute at the images' own size
    tb = [torch.from_numpy(a) for a in small]
    tp = tvgg.pack_params(params[1], "float32")
    direct = tbatch.prepare_batch(*tb, tp, cfg)
    staged = tbatch.prepare_batch_stage(*tb, tp, (16, 16), cfg)[0]
    for a, b in zip(jax.tree.leaves(direct), jax.tree.leaves(staged)):
        assert torch.equal(a, b)


def test_mesh_raises(toy_batch, params):
    """A 2-D mesh whose batch axis does not divide B raises the JAX
    package's ValueError; a one-device mesh runs as `device` does, bit for
    bit."""
    from dpst_tpu_torch.parallel import mesh as tmesh
    with pytest.raises(ValueError, match="does not divide"):
        _port_batch(tuple(a[:3] for a in toy_batch), {}, params[1],
                    mesh=tmesh.make_mesh_2d(2, 2, devices=["cpu"] * 4))
    two = tuple(a[:2] for a in toy_batch)
    ref = _port_batch(two, dict(iterations=2), params[1])
    got = dpst_tpu_torch.stylize_batch(
        *two, _cfg(dpst_tpu_torch, iterations=2), vgg_params=params[1],
        mesh=tmesh.make_mesh(devices=["cpu"]))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_batch_debug_nans_names_the_pair(toy_batch, params):
    contents = toy_batch[0].copy()
    contents[2, 3, 4, 1] = np.nan
    with pytest.raises(FloatingPointError, match="step 0, pair 2"):
        _port_batch((contents,) + toy_batch[1:], dict(debug_nans=True),
                    params[1])


def test_lbfgs_batch_runs_the_pairs_one_by_one(toy_batch, params):
    """With optimizer="lbfgs" the pairs run as one batched loop (each
    pair's own memory and linesearch, one batched evaluation a round) that
    takes each pair as the one-pair L-BFGS does: each pair's rows, image
    and evaluations a step equal its `stylize` run alone, bit for bit (in
    bf16, where the batch's convolutions round as one image's do); a step
    runs as many batched evaluations as its longest search."""
    small = tuple(a[:2] for a in toy_batch)
    cfg_kw = dict(optimizer="lbfgs", iterations=3, compute_dtype="bfloat16")
    with topt.record_evaluations() as rec:
        img, hist = _port_batch(small, cfg_kw, params[1])
    cfg = tbatch.resolve_config(_cfg(dpst_tpu_torch, **cfg_kw))
    for i in range(2):
        with topt.record_evaluations() as rec_i:
            out, h = dpst_tpu_torch.stylize(
                small[0][i], small[1][i], cfg, content_masks=small[2][i],
                style_masks=small[3][i], vgg_params=params[1],
                return_history=True, device="cpu")
        np.testing.assert_array_equal(hist[i], h)
        np.testing.assert_array_equal(img[i], out)
        assert [r["pairs"][i] for r in rec] == [r["pairs"][0]
                                                for r in rec_i]
    assert [r["evaluations"] for r in rec] == [
        max(p["evaluations"] for p in r["pairs"]) for r in rec]


# --- the batched wrappers -------------------------------------------------

def _gram_operands(b, c, p, k, dtype, seed):
    r = np.random.default_rng(seed)
    f = torch.from_numpy(np.abs(r.normal(size=(b, c, p))).astype(np.float32))
    m2 = torch.from_numpy(r.uniform(size=(b, k, p)).astype(np.float32) ** 2)
    s = torch.from_numpy(r.normal(size=(b, k, c, c)).astype(np.float32))
    s = s + s.transpose(-1, -2)
    z = torch.from_numpy(r.normal(size=(b, c, p)).astype(np.float32))
    bias = torch.from_numpy(r.normal(scale=0.5, size=(c,)).astype(
        np.float32))
    z[:, :, ::7] = -bias[:, None]          # exact zeros of z + b
    return [t.to(dtype) for t in (f, m2, s, z, bias)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,p,k", [(3, 16, 200, 2), (2, 37, 333, 5)])
def test_batched_gram_wrappers_equal_their_loops(b, c, p, k, dtype):
    """gram_fwd, gram_bwd, gram_relu_fwd, gram_relu_bwd and gram_wbwd on a
    batch, bit for bit a loop of their 2-D calls; on the CPU they launch
    nothing."""
    f, m2, s, z, bias = _gram_operands(b, c, p, k, dtype, seed=c * p)
    before = dict(kernels.LAUNCHES)
    cases = ((tgs.gram_fwd, (f, m2)), (tgs.gram_bwd, (f, m2, s)),
             (tg2.gram_relu_fwd, (z, bias, m2)),
             (tg2.gram_relu_bwd, (z, bias, m2, s)),
             (tgp.gram_wbwd, (f, m2, s)))
    for fn, args in cases:
        got = fn(*args)
        loop = torch.stack([fn(*(a[i] if a.dim() > 1 else a for a in args))
                            for i in range(b)])
        assert torch.equal(got, loop), fn.__name__
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,cin,cout,h,w", [(3, 16, 24, 9, 13),
                                           (2, 70, 8, 12, 35)])
def test_batched_conv_equals_its_loop(n, cin, cout, h, w, dtype):
    """conv3x3_same on an (N, Cin, H, W) batch, with OIHW or packed
    weights, is bit for bit a loop of its one-image calls; on the CPU it
    launches nothing."""
    r = np.random.default_rng(cin * h)
    x = torch.from_numpy(r.normal(size=(n, cin, h, w)).astype(
        np.float32)).to(dtype)
    wt = torch.from_numpy(r.normal(size=(cout, cin, 3, 3)).astype(
        np.float32)).to(dtype)
    before = dict(kernels.LAUNCHES)
    for weights in (wt, tconv.pack_weights(wt)):
        got = tconv.conv3x3_same(x, weights)
        assert got.shape == (n, cout, h, w)
        loop = torch.stack([tconv.conv3x3_same(xi, weights) for xi in x])
        assert torch.equal(got, loop)
    assert kernels.LAUNCHES == before


def test_batched_grams_match_jax_kernel_under_vmap():
    """The batched masked Grams (through `losses.masked_grams`: gram_fwd,
    and gram_bwd for the gradient) against the JAX package's streamed
    Pallas Gram kernels under jax.vmap, values and input gradients."""
    from dpst_tpu_torch.ops import losses as tlosses
    r = np.random.default_rng(3)
    b, c, k, h, w = 3, 24, 3, 12, 10
    feat = r.normal(size=(b, h, w, c)).astype(np.float32)
    masks = r.uniform(size=(b, k, h, w)).astype(np.float32)
    tgt = r.normal(size=(b, k, c, c)).astype(np.float32)
    jfn = jax.vmap(jgs.masked_grams_stream)
    ref = np.asarray(jfn(jnp.asarray(feat), jnp.asarray(masks)))
    jgrad = np.asarray(jax.grad(lambda x: jnp.sum(
        (jfn(x, jnp.asarray(masks)) - tgt) ** 2))(jnp.asarray(feat)))
    x = torch.from_numpy(np.ascontiguousarray(feat.transpose(0, 3, 1, 2)))
    x.requires_grad_(True)
    got = tlosses.masked_grams(x, torch.from_numpy(masks))
    (g,) = torch.autograd.grad(torch.sum((got - torch.from_numpy(tgt)) ** 2),
                               x)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=KERNEL_RTOL,
                               atol=KERNEL_RTOL * float(np.abs(ref).max()))
    np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), jgrad,
                               rtol=KERNEL_RTOL,
                               atol=KERNEL_RTOL * float(np.abs(jgrad).max()))


def _stats(b, h, w, seed):
    r = np.random.default_rng(seed)
    imgs = r.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    packed = torch.stack([tlapc.pack_stats(tlap.precompute_stats(
        torch.from_numpy(i), eps=1e-5)) for i in imgs])
    v = r.normal(size=(b, 3, h, w)).astype(np.float32)
    return imgs, packed, torch.from_numpy(v)


def test_batched_lap_matvec_equals_its_loop_and_jax_under_vmap():
    """lap_matvec on (B, 14, H, W) stats, on one (14, H, W) stack shared by
    every pair, and on that stack expanded with a batch stride of 0: bit
    for bit a loop of 2-D calls; and against the JAX package's Pallas
    matvec under jax.vmap."""
    imgs, packed, v = _stats(3, 13, 17, seed=11)
    got = tlapc.lap_matvec(packed, v)
    assert torch.equal(got, torch.stack([tlapc.lap_matvec(packed[i], v[i])
                                         for i in range(3)]))
    shared = tlapc.lap_matvec(packed[0], v)
    assert torch.equal(shared, tlapc.lap_matvec(
        packed[:1].expand(3, -1, -1, -1), v))
    assert torch.equal(shared, torch.stack([tlapc.lap_matvec(packed[0], v[i])
                                            for i in range(3)]))
    js = jax.vmap(lambda i: jlap.precompute_stats(i, eps=1e-5))(
        jnp.asarray(imgs))
    ref = np.asarray(jax.vmap(jlap_pallas.matvec_pallas)(
        js, jnp.asarray(v.permute(0, 2, 3, 1).numpy())))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=KERNEL_RTOL,
                               atol=KERNEL_RTOL * float(np.abs(ref).max()))
    with pytest.raises(ValueError):
        tlapc.lap_matvec(packed, v[0])
    with pytest.raises(ValueError):
        tlapc.lap_matvec(packed[:2], v)


class _Recorder:
    """A stand-in for the kernel library that records each entry point's
    arguments (the batch axis among them) and launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_wrappers_launch_once_for_the_batch(monkeypatch, dtype):
    """Tensors taken as on the card: each batched wrapper (the five Gram
    kernels, `lap_matvec` and `conv3x3`) calls its entry point once with B
    and counts one launch, whatever B is."""
    rec = _Recorder()
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kernels, "library", lambda: rec)
    monkeypatch.setattr(kernels, "stream_ptr", lambda t: None)
    b, c, p, k = 5, 64, 4096, 4
    f, m2, s, z, bias = _gram_operands(b, c, p, k, dtype, seed=1)
    _, packed, v = _stats(b, 16, 16, seed=2)
    monkeypatch.setattr(kernels, "LAUNCHES", dict.fromkeys(kernels.KERNELS,
                                                           0))
    tgs.gram_fwd(f, m2)
    tgs.gram_bwd(f, m2, s)
    tg2.gram_relu_fwd(z, bias, m2)
    tg2.gram_relu_bwd(z, bias, m2, s)
    tgp.gram_wbwd(f, m2, s)
    x = torch.zeros((b, 96, 24, 40), dtype=dtype)
    wp = tconv.pack_weights(torch.zeros((72, 96, 3, 3), dtype=dtype))
    tconv.conv3x3_same(x, wp)
    if dtype == torch.float32:
        tlapc.lap_matvec(packed, v)
        tlapc.lap_matvec(packed[:1].expand(b, -1, -1, -1), v)
    names = [n for n, _ in rec.calls]
    lap = ["dpst_lap_matvec"] * 2 if dtype == torch.float32 else []
    assert names == (["dpst_gram_fwd", "dpst_gram_bwd", "dpst_gram_relu_fwd",
                      "dpst_gram_relu_bwd", "dpst_gram_wbwd", "dpst_conv3x3"]
                     + lap)
    args = dict(rec.calls[:6])
    # (C, P, K, B) follow the pointers of each batched entry point
    assert args["dpst_gram_fwd"][4:8] == (c, p, k, b)
    assert args["dpst_gram_bwd"][5:9] == (c, p, k, b)
    assert args["dpst_gram_relu_fwd"][5:9] == (c, p, k, b)
    assert args["dpst_gram_relu_bwd"][6:10] == (c, p, k, b)
    assert args["dpst_gram_wbwd"][5:9] == (c, p, k, b)
    # (Cin, Cout, H, W, B, bn, splits, cps) follow the conv's pointers
    plan = (tconv.conv_plan(96, 72, 24, 40, b) if dtype == torch.bfloat16
            else (0, 1, 1))
    assert args["dpst_conv3x3"][4:12] == (96, 72, 24, 40, b, *plan)
    if dtype == torch.float32:
        (_, a1), (_, a2) = rec.calls[-2:]
        assert a1[3:] == (16, 16, tlapc.lap_plan(16, 16, b), b,
                          14 * 16 * 16, None)
        assert a2[6:8] == (b, 0)        # the shared stack: stride 0
    assert kernels.LAUNCHES["gram_fwd"] == kernels.LAUNCHES["gram_bwd"] == 1
    assert kernels.LAUNCHES["gram_relu_fwd"] == 1
    assert kernels.LAUNCHES["gram_relu_bwd"] == 1
    assert kernels.LAUNCHES["gram_wbwd"] == kernels.LAUNCHES["conv3x3"] == 1
    assert kernels.LAUNCHES["lap_matvec"] == (2 if lap else 0)
