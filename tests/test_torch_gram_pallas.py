"""The port's Grams whose backward weights by m² after the product
(`ops/gram_pallas.py`: the plain path of the `gram_wbwd` kernel and the
`WeightedGrams` Function) against the JAX package's Pallas Grams
(`gram_pallas.masked_grams_pallas`) and streamed Grams
(`gram_stream.masked_grams_stream`, `masked_grams_hybrid`), all interpreted
off-TPU; and the port's `gram_route` against the JAX one on a TPU.

Tolerance: Grams at rtol 1e-5 and 1e-5 of max|G| in both dtypes (fp32 sums
of the same exact products in different orders); their VJPs at 1e-5 of
max|dF| in fp32 and one bf16 ulp of max|dF| in bf16 (both sides round the
same fp32 class sum once). Masks are soft: where m² multiplies (before or
after the product) only shows there."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpst_tpu.ops import gram_pallas as jgp
from dpst_tpu.ops import gram_stream as jgs
from dpst_tpu.ops import losses as jlosses
from dpst_tpu_torch.ops import gram_pallas as tgp
from dpst_tpu_torch.ops import gram_stream as tgs
from dpst_tpu_torch.ops import kernels
from dpst_tpu_torch.ops import losses as tlosses


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(h, w, c, k, seed=0):
    """A post-ReLU-like tap (H, W, C) in the JAX layout, soft masks (K, H,
    W) and a Gram cotangent (K, C, C)."""
    r = np.random.default_rng(seed)
    feat = np.abs(r.normal(size=(h, w, c))).astype(np.float32)
    masks = r.uniform(size=(k, h, w)).astype(np.float32)
    cot = r.normal(size=(k, c, c)).astype(np.float32)
    return feat, masks, cot


def _chw(feat):
    return torch.from_numpy(np.ascontiguousarray(feat.transpose(2, 0, 1)))


def _bf16_ulp(ref: np.ndarray) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _value_and_vjp_jax(fn, feat, masks, cot):
    g, vjp = jax.vjp(lambda f: fn(f, jnp.asarray(masks)), jnp.asarray(feat))
    (df,) = vjp(jnp.asarray(cot))
    return np.asarray(g), np.asarray(df, np.float32)


def _value_and_vjp_torch(fn, feat, masks, cot):
    x = _chw(feat).requires_grad_(True)
    g = fn(x, torch.from_numpy(masks))
    (df,) = torch.autograd.grad(g, x, grad_outputs=torch.from_numpy(cot))
    return g.detach().numpy(), df.permute(1, 2, 0).numpy()


def _check(got, ref, dtype):
    g_t, df_t = got
    g_j, df_j = ref
    np.testing.assert_allclose(g_t, g_j, rtol=1e-5,
                               atol=1e-5 * float(np.abs(g_j).max()))
    tol = (1e-5 * float(np.abs(df_j).max()) if dtype == "float32"
           else _bf16_ulp(df_j))
    assert float(np.abs(df_t - df_j).max()) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["m2", "m1"])
@pytest.mark.parametrize("h,w,c,k", [(40, 56, 16, 3), (32, 32, 64, 4)])
def test_masked_grams_pallas_match_jax_kernels(h, w, c, k, norm, dtype):
    feat, masks, cot = _inputs(h, w, c, k, seed=c + k)
    ref = _value_and_vjp_jax(functools.partial(
        jgp.masked_grams_pallas, compute_dtype=dtype, norm=norm,
        interpret=True), feat, masks, cot)
    got = _value_and_vjp_torch(functools.partial(
        tgp.masked_grams_pallas, compute_dtype=dtype, norm=norm),
        feat, masks, cot)
    _check(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["stream", "hybrid"])
def test_streamed_routes_match_jax_kernels(impl, dtype):
    """gram_impl "stream" and "hybrid": the streamed backward kernel
    (gram_stream._bwd_kernel) is the function gram_wbwd computes; the
    stream forward puts the weighted operand on the left, the hybrid's
    fused forward on the right."""
    feat, masks, cot = _inputs(24, 40, 32, 3, seed=9)
    jfn = (jgs.masked_grams_stream if impl == "stream"
           else jgs.masked_grams_hybrid)
    ref = _value_and_vjp_jax(functools.partial(jfn, compute_dtype=dtype),
                             feat, masks, cot)
    got = _value_and_vjp_torch(functools.partial(
        tlosses.route_grams, impl, compute_dtype=dtype), feat, masks, cot)
    _check(got, ref, dtype)


def test_backward_weights_after_the_product():
    """In bf16 the two backwards differ: gram_bwd rounds F ∘ m²_k before
    one product, gram_wbwd weights each class's fp32 product after it."""
    feat, masks, cot = _inputs(16, 16, 32, 3, seed=10)
    f = _chw(feat).reshape(32, -1).to(torch.bfloat16)
    m2 = torch.from_numpy(masks * masks).reshape(3, -1).to(torch.bfloat16)
    s = torch.from_numpy(cot + cot.transpose(0, 2, 1)).to(torch.bfloat16)
    after = tgp.gram_wbwd(f, m2, s)
    acc = torch.zeros(f.shape)
    for k in range(3):
        acc = acc + torch.matmul(s[k].float(), f.float()) * m2[k].float()
    assert torch.equal(after, acc.to(torch.bfloat16))
    assert not torch.equal(after, tgs.gram_bwd(f, m2, s))


def test_no_mask_gradient_and_cpu_counts_nothing():
    feat, masks, _ = _inputs(6, 5, 8, 2, seed=11)
    f = _chw(feat).reshape(8, -1).requires_grad_(True)
    m2 = torch.from_numpy(masks * masks).reshape(2, -1).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    g = tgp.WeightedGrams.apply(f, m2)
    gf, gm = torch.autograd.grad(g.sum(), (f, m2), allow_unused=True)
    assert gm is None and gf.shape == f.shape
    assert kernels.LAUNCHES == before


def test_wrapper_validates_operands():
    f, m2, s = torch.zeros(4, 10), torch.zeros(2, 10), torch.zeros(2, 4, 4)
    with pytest.raises(ValueError):
        tgp.gram_wbwd(f, torch.zeros(2, 9), s)
    with pytest.raises(ValueError):
        tgp.gram_wbwd(f, m2, torch.zeros(2, 4, 5))
    with pytest.raises(ValueError):
        tgp.gram_wbwd(f, m2, s.to(torch.bfloat16))
    with pytest.raises(ValueError):                         # never falls back
        tgp.gram_wbwd(f.to("meta"), m2, s)


# --- routing ------------------------------------------------------------------

IMPLS = ["auto", "pallas", "xla", "dotg", "stream", "hybrid"]
SIZES = [(512, 512, 4, 64),        # 2^26: well inside the fused bound
         (2048, 2048, 4, 32),      # 2^29: the bound itself (fused)
         (2048, 2048, 4, 64)]      # 2^30: past it


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("impl", IMPLS)
def test_gram_route_matches_jax_on_tpu(monkeypatch, impl, size):
    monkeypatch.setattr(jgs.jax, "default_backend", lambda: "tpu")
    assert tlosses.FUSED_MAX_ELEMENTS == jlosses._FUSED_MAX_ELEMENTS
    assert tlosses.gram_route(*size, impl) == jlosses.gram_route(*size, impl)


@pytest.mark.parametrize("impl,bound,kernel", [
    ("pallas", None, "gram_wbwd"), ("stream", None, "gram_wbwd"),
    ("hybrid", None, "gram_wbwd"), ("auto", 1000, "gram_wbwd"),
    ("auto", None, "gram_bwd"), ("xla", None, "gram_bwd"),
    ("dotg", None, "gram_bwd"), ("xla", 1000, "gram_bwd")])
def test_route_table_picks_the_backward(monkeypatch, impl, bound, kernel):
    """The style loss of an (8, 10, 12) tap with K = 3 takes gram_wbwd on
    the Pallas and streamed routes, "auto" past the fused bound included
    (the bound lowered to 1000 elements here), and gram_bwd on the fused,
    "dotg" and "scan" routes."""
    if bound is not None:
        monkeypatch.setattr(tlosses, "FUSED_MAX_ELEMENTS", bound)
    calls = []
    for mod, name in ((tgp, "gram_wbwd_plain"), (tgs, "gram_bwd_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    feat, masks, cot = _inputs(10, 12, 8, 3, seed=12)
    x = _chw(feat).requires_grad_(True)
    loss = tlosses.style_layer_loss(
        x, torch.from_numpy(cot), torch.from_numpy(masks),
        torch.full((3,), 1.0 / 3), gram_impl=impl)
    torch.autograd.grad(loss, x)
    assert calls == [kernel + "_plain"]
