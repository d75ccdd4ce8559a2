"""What the block12 backwards' Gram cotangent stage (csrc/block12.cu: in bf16
gram_bwd's Hopper body with an epilogue that adds the conv term and relu′)
and the backwards' scratch are handed, checked on the CPU: the stage's
operand form against the plain per-class sum and the JAX kernel's
`_gram_df`, the plain stage against the form the plain backwards had
before it was factored out, the rows the kernels skip, the stage's plan
and the scratch layout. The kernels themselves run only on the card
(chip_smoke.py holds them against the plain versions).

The operand checks use small integers and masks in {0, ¼, ½, 1}: every
product and every partial sum is exact in fp32, so the results must agree
bit for bit whatever order the sums take. The other checks compare one
plain computation with another in the same order: bit for bit too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dpst_tpu.ops import block12_pallas as jb
from dpst_tpu_torch.ops import block12_pallas as tb
from dpst_tpu_torch.ops import kernels
from dpst_tpu_torch.ops.conv_cuda import conv3x3_acc, flip_transpose_weights
from dpst_tpu_torch.ops.gram_stream import s_matrix

# The band heights the walk tests take
HEIGHTS = (32, 64, 128)


def _stage(which, rows):
    """(C, rows a band, width divisor) of a backward's stage on bands of
    `rows` own rows."""
    r0 = rows + 2 * tb.HALO
    return (64, r0, 1) if which == "shallow" else (128, r0 // 2, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exact(c, r, w, k, dtype, seed):
    """A tap f (C, r, W) of integers 0…8, m² (K, r, W) in {0, ¼, ½, 1} and
    dG (K, C, C) of integers −4…4 (numpy), the first two in `dtype`."""
    g = np.random.default_rng(seed)
    cdt = getattr(torch, dtype)
    f = torch.from_numpy(g.integers(0, 9, (c, r, w)).astype(np.float32))
    msq = torch.from_numpy(g.choice([0.0, 0.25, 0.5, 1.0], (k, r, w))
                           .astype(np.float32))
    dg = g.integers(-4, 5, (k, c, c)).astype(np.float32)
    return f.to(cdt), msq.to(cdt), dg


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k", [1, 4, 5])
def test_stage_operand_form_equals_plain_and_jax(dtype, k):
    """s_matrix(symmetrize(dG)) (C, K·C) times the stacked round(round(m²_k)
    ∘ f) (K·C, P), the product the bf16 body forms, equals the plain
    `_gram_df`'s per-class sum and the JAX kernel's `_gram_df`."""
    c, r, w = 16, 6, 8
    f, msq, dg = _exact(c, r, w, k, dtype, seed=k)
    cdt = getattr(torch, dtype)
    s = tb.symmetrize(torch.from_numpy(dg), dtype)
    wk = torch.stack([(msq[q].to(cdt)[None] * f).reshape(c, r * w)
                      for q in range(k)]).reshape(k * c, r * w)
    got = torch.matmul(s_matrix(s).float(), wk.float()).reshape(c, r, w)
    plain = tb._gram_df(f, msq, s, cdt)
    ref = jb._gram_df(jnp.asarray(f.float().numpy(), dtype),
                      jnp.asarray(msq.float().numpy(), dtype),
                      jnp.asarray(dg), jnp.dtype(dtype))
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(ref))


# --- the plain backwards before and after the stage was factored out

def _params(seed):
    """Random He-scaled weights and small biases of conv1_1 … conv2_2."""
    g = np.random.default_rng(seed)
    out = {}
    for name, (cin, cout) in tb._CINOUT.items():
        w = g.normal(size=(cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))
        out[name] = {"w": torch.from_numpy(w.astype(np.float32)),
                     "b": torch.from_numpy(
                         (g.normal(size=cout) * 0.1).astype(np.float32))}
    return out


def _deep_inputs(h, w, k, dtype, seed):
    g = np.random.default_rng(seed)
    cdt = getattr(torch, dtype)

    def t(*shape, relu=False):
        x = torch.from_numpy(g.normal(size=shape).astype(np.float32))
        return (x.clamp_min(0) if relu else x).to(cdt)
    m2 = torch.from_numpy((g.uniform(size=(k, h // 2, w // 2)) ** 2)
                          .astype(np.float32))
    s2 = tb.symmetrize(torch.from_numpy(
        g.normal(size=(k, 128, 128)).astype(np.float32)), dtype)
    return (t(128, h // 2, w // 2, relu=True), t(128, h // 2, w // 2, relu=True),
            t(128, h // 4, w // 4), m2, s2)


def _shallow_inputs(h, w, k, dtype, seed):
    g = np.random.default_rng(seed)
    cdt = getattr(torch, dtype)
    a11 = torch.from_numpy(g.normal(size=(64, h, w)).astype(np.float32))
    dp1 = torch.from_numpy(g.normal(size=(64, h // 2, w // 2))
                           .astype(np.float32))
    m1 = torch.from_numpy((g.uniform(size=(k, h, w)) ** 2).astype(np.float32))
    s1 = tb.symmetrize(torch.from_numpy(
        g.normal(size=(k, 64, 64)).astype(np.float32)), dtype)
    return a11.clamp_min(0).to(cdt), dp1.to(cdt), m1, s1


def _deep_before(a21, a22, dp2, m2sq, s2, weights, pooling, cdt, rows):
    """`block12_bwd_deep_plain` as it read before the Gram cotangent stage
    was factored out, in bands of `rows` rows."""
    ft21 = flip_transpose_weights(weights[4])
    ft22 = flip_transpose_weights(weights[6])
    h2 = a21.shape[1]
    tb2, h1 = rows // 2, tb.HALO // 2
    outs = []
    for i in range(2 * h2 // rows):
        a21e = tb._band(a21, i, tb2, h1)
        a22e = tb._band(a22, i, tb2, h1)
        dp2e = tb._band(dp2, i, rows // 4, tb.HALO // 4)
        m2e = tb._band(m2sq, i, tb2, h1)
        dz22 = (tb._pool_bwd(dp2e, a22e, pooling, cdt)
                * tb._relu_grad(a22e).to(cdt))
        da21 = conv3x3_acc(dz22, ft22) + tb._gram_df(a21e, m2e, s2, cdt)
        dz21 = (da21 * tb._relu_grad(a21e)).to(cdt)
        outs.append(conv3x3_acc(dz21, ft21)[:, h1:h1 + tb2].to(cdt))
    return torch.cat(outs, dim=1)


def _shallow_before(a11, dp1, m1sq, s1, weights, pooling, cdt, rows):
    """`block12_bwd_shallow_plain` as it read before the stage was
    factored out, in bands of `rows` rows."""
    ft11 = flip_transpose_weights(weights[0])
    ft12 = flip_transpose_weights(weights[2])
    h = a11.shape[1]
    outs = []
    for i in range(h // rows):
        a11e = tb._band(a11, i, rows, tb.HALO)
        dp1e = tb._band(dp1, i, rows // 2, tb.HALO // 2)
        m1e = tb._band(m1sq, i, rows, tb.HALO)
        rm0 = tb._row_mask(i, rows, tb.HALO, h, a11e.shape[1], a11.device)
        a12e = tb._conv_bias_relu(a11e, weights[2], weights[3], rm0, cdt)
        dz12 = (tb._pool_bwd(dp1e, a12e, pooling, cdt)
                * tb._relu_grad(a12e).to(cdt))
        da11 = conv3x3_acc(dz12, ft12) + tb._gram_df(a11e, m1e, s1, cdt)
        dz11 = (da11 * tb._relu_grad(a11e)).to(cdt)
        outs.append(conv3x3_acc(dz11, ft11)[:, tb.HALO:tb.HALO + rows])
    return torch.cat(outs, dim=1)


def _run(which, h, w, k, dtype, pooling, seed, rows):
    """The plain backward `which` in bands of `rows` rows on seeded
    inputs, and its inputs."""
    weights = tb.pack_weights(_params(seed), dtype)
    if which == "deep":
        args = _deep_inputs(h, w, k, dtype, seed)
        return tb.block12_bwd_deep_plain(*args, weights, pooling, dtype,
                                         tb=rows), args, weights
    args = _shallow_inputs(h, w, k, dtype, seed)
    return tb.block12_bwd_shallow_plain(*args, weights, pooling, dtype,
                                        tb=rows), args, weights


@pytest.mark.parametrize("rows", HEIGHTS)
@pytest.mark.parametrize("which", ["deep", "shallow"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_plain_stage_equals_the_backwards_before(which, dtype, pooling,
                                                 rows):
    """The plain backwards that call `gram_dz_plain` give what they gave
    when they computed round((t + g) · (a > 0)) inline, in bands of `rows`
    rows: one band at rows = 32, two at 64, three at 128."""
    h = {32: 32, 64: 128, 128: 384}[rows]
    got, args, weights = _run(which, h, 64, 3, dtype, pooling, seed=11,
                              rows=rows)
    before = _deep_before if which == "deep" else _shallow_before
    ref = before(*args, weights, pooling, getattr(torch, dtype), rows)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("which", ["deep", "shallow"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pooling", ["max", "avg"])
@pytest.mark.parametrize("h,w,rows", [
    (2 * rows, 256, rows) for rows in HEIGHTS] + [
    (rows, 260, rows) for rows in HEIGHTS])
def test_rows_outside_dz_rows_reach_no_own_row(monkeypatch, which, dtype,
                                               pooling, h, w, rows):
    """The bf16 kernels compute the Gram cotangent only on `dz_rows` of
    each band: with dz NaN on every other row, the own rows of dp1 (deep)
    and dx (shallow) stay bit-identical and finite, in bands of `rows`
    rows (two bands at W = 256, one at W = 260)."""
    ref, _, _ = _run(which, h, w, 2, dtype, pooling, seed=h + w, rows=rows)
    lo, hi = tb.dz_rows(which, rows)
    plain, calls = tb.gram_dz_plain, []

    def poisoned(f, msq, s, t, cdt):
        dz = plain(f, msq, s, t, cdt).clone()
        assert dz.shape[1] == _stage(which, rows)[1]
        dz[:, :lo] = float("nan")
        dz[:, hi:] = float("nan")
        calls.append(1)
        return dz

    monkeypatch.setattr(tb, "gram_dz_plain", poisoned)
    got, _, _ = _run(which, h, w, 2, dtype, pooling, seed=h + w, rows=rows)
    assert len(calls) == h // rows
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, ref)


# --- the stage's plan and the scratch

def _groups(h, w, rows):
    """Band counts of the groups the entry points walk at an h × w image
    in bands of `rows` rows."""
    nb, bands = tb.group_bands(h, w, rows), h // rows
    return sorted({nb} | ({bands % nb} if bands % nb else set()))


GEOMS = sorted({(h, w) for h, w, *_ in chip_smoke.B12_CASES}
               | {(chip_smoke.B12_SIZE, chip_smoke.B12_SIZE)})


@pytest.mark.parametrize("h,w,rows", [
    (h, w, rows) for h, w in GEOMS for rows in (None,) + HEIGHTS
    if rows is None or h % rows == 0])
@pytest.mark.parametrize("which", ["shallow", "deep"])
def test_stage_plan_covers_the_needed_pixels_once(h, w, which, rows):
    """The stage's plan at every group shape of the walk, in bands of
    `rows` rows (None: the height `band_rows` picks)."""
    rows = rows or tb.band_rows(h, w)
    c, r, div = _stage(which, rows)
    wl = w // div
    lo, hi = tb.dz_rows(which, rows)
    for nb in _groups(h, w, rows):
        tile, groups, splits, pb, pe, tpb, ptiles = tb.gram_dz_plan(
            c, nb, r, wl, (lo, hi))
        assert splits == 1                # the epilogue sees the whole sum
        assert tile == (64 if c <= 64 else 128) and c % tile == 0
        assert (nb * r * wl) % 8 == 0 and (r * wl) % 8 == 0
        assert pb % 8 == 0 and pe % 8 == 0
        assert pb <= lo * wl < pb + 8 and hi * wl <= pe < hi * wl + 8
        assert pe <= r * wl and ptiles == nb * tpb
        assert 1 <= groups <= ptiles
        hits = np.zeros(nb * r * wl, np.int64)
        for bx in range(groups):            # each block's tiles, as the body
            for tile_i in range(bx, ptiles, groups):
                band, v = divmod(tile_i, tpb)
                p0 = band * r * wl + pb + v * 64
                hits[p0:min(p0 + 64, band * r * wl + pe)] += 1
        hits = hits.reshape(nb, r, wl)
        assert (hits[:, lo:hi] == 1).all()  # every needed pixel once
        assert hits.max() == 1
        assert hits.sum() == nb * (pe - pb)


def _scratch_before(which, k, h, w, group, dtype, rows):
    """The backwards' scratch before this layout: the gathered masks in
    fp32 whatever the compute dtype."""
    isz = getattr(torch, dtype).itemsize
    nb = min(group, h // rows)
    r0 = rows + 2 * tb.HALO
    p0, p1 = nb * r0 * w, nb * (r0 // 2) * (w // 2)
    p2 = nb * (r0 // 4) * (w // 4)
    if which == 1:
        parts = [(128 * p1, isz)] * 2 + [(128 * p2, isz), (128 * p1, isz),
                                         (k * p1, 4), (128 * p1, 4)]
    else:
        parts = [(64 * p0, isz), (64 * p1, isz), (64 * p0, isz),
                 (64 * p0, isz), (k * p0, 4), (64 * p0, 4)]
    return sum(-(-n * sz // 256) * 256 for n, sz in parts)


@pytest.mark.parametrize("h,w,k,dtype", sorted(
    {(h, w, k, dtype) for h, w, k, dtype, *_ in chip_smoke.B12_CASES}
    | {(chip_smoke.B12_SIZE, chip_smoke.B12_SIZE, chip_smoke.K,
        "bfloat16")}))
def test_scratch_does_not_grow(h, w, k, dtype):
    rows = tb.band_rows(h, w)
    group = tb.group_bands(h, w)
    for which in (1, 2):
        new = tb.scratch_bytes(which, k, h, w, group, dtype)
        old = _scratch_before(which, k, h, w, group, dtype, rows)
        assert new < old if dtype == "bfloat16" else new == old
    assert tb.scratch_bytes(0, k, h, w, group, dtype) > 0


def test_stage_wrapper_takes_the_plain_version_on_cpu():
    f, msq, dg = _exact(16, 12, 8, 3, "bfloat16", seed=2)
    s = tb.symmetrize(torch.from_numpy(dg), "bfloat16")
    t = torch.randn(16, 12, 8)
    before = dict(kernels.LAUNCHES)
    got = tb.block12_gram_dz(f, msq, s, t, band_rows=6, rows=(1, 5))
    assert torch.equal(got, tb.gram_dz_plain(f, msq, s, t, torch.bfloat16))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError):       # 12 rows are not bands of 5
        tb.block12_gram_dz(f, msq, s, t, band_rows=5)
    with pytest.raises(ValueError):
        tb.block12_gram_dz(f, msq, s, t, band_rows=6, rows=(4, 7))
    with pytest.raises(ValueError):       # masks in another dtype
        tb.block12_gram_dz(f, msq.float(), s, t, band_rows=6)
    assert torch.equal(tb._cotangent(s), s_matrix(s))
    assert torch.equal(tb._cotangent(s.float()), s.float())
