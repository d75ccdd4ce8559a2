"""The block12 entry points on a batch of B pairs (`ops/block12_pallas.py`,
a leading pair axis; one launch of each entry point on the card):

  * the batched plain versions, the wrappers and the autograd Function on
    the CPU against B one-pair calls, bit for bit (B = 1, 2, 3; bf16 and
    fp32; max and avg pooling);
  * a Python mirror of csrc/block12.cu's walk over units (pair, band),
    pair-major, a group of them at a time: every (pair, band) once, groups
    that run from one pair into the next, a scratch of one pair's group
    whatever B is; and the walk itself, with the kernels' index math (the
    band gathers and scatters with their unit's pair, the conv epilogues'
    row mask with the band taken modulo H / tb, each pair's Gram partials
    folded into its own sums from its first band, the Gram cotangent stage
    with its pair's cotangent) on the plain versions' per-band arithmetic,
    equal to the batched plain versions bit for bit at a group that spans
    pairs; both at bands of 32, 64 and 128 rows, and at the height
    `band_rows` picks.

Every pair has its own image, masks and cotangents, drawn with numpy from
a seed, so that a stage reading another pair's operands would show."""
import numpy as np
import pytest
import torch

from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import block12_pallas as tb
from dpst_tpu_torch.ops import kernels
from dpst_tpu_torch.ops.conv_cuda import conv3x3_acc, flip_transpose_weights

HALO = tb.HALO
# The band heights the walk tests take besides `band_rows`' own pick
HEIGHTS = (32, 64, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return tvgg.init_params(0)


def _batch(b, h, w, k, dtype, seed):
    """b pairs: images in the preprocessed range (B, 3, H, W), m1² (B, K,
    H, W) and m2² (B, K, H/2, W/2) of soft masks, the forward's Gram and
    pool2 cotangents, all distinct per pair."""
    r = np.random.default_rng(seed)
    cdt = getattr(torch, dtype)

    def t(*shape, lo=None):
        a = (r.uniform(lo, 130, shape) if lo is not None
             else r.normal(size=shape))
        return torch.from_numpy(a.astype(np.float32))

    x = t(b, 3, h, w, lo=-120)
    m1 = t(b, k, h, w, lo=0) / 130
    m2 = t(b, k, h // 2, w // 2, lo=0) / 130
    dg1, dg2 = t(b, k, 64, 64), t(b, k, 128, 128)
    dp2 = t(b, 128, h // 4, w // 4).to(cdt)
    return x, m1 * m1, m2 * m2, dg1, dg2, dp2


def _equal(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{what} output {i}"


@pytest.mark.parametrize("pooling", ["max", "avg"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b", [1, 2, 3])
def test_batch_equals_one_pair_calls(params, b, dtype, pooling):
    """Wrappers (the CPU route: the plain versions), the plain versions and
    the Function's VJP on a batch equal a loop of one-pair calls."""
    h, w, k = 96, 64, 2
    x, m1, m2, dg1, dg2, dp2 = _batch(b, h, w, k, dtype, seed=10 * b + k)
    wts = tb.pack_weights(params, dtype)
    kw = dict(pooling=pooling, compute_dtype=dtype)
    before = dict(kernels.LAUNCHES)
    fwd = tb.block12_fwd_res(x, m1, m2, wts, **kw)
    one = [tb.block12_fwd_res(x[i], m1[i], m2[i], wts, **kw)
           for i in range(b)]
    _equal(fwd, tuple(torch.stack(c) for c in zip(*one)), "block12_fwd_res")
    _equal(tb.block12_fwd(x, m1, m2, wts, **kw), fwd[:3], "block12_fwd")
    _equal(tb.block12_fwd_plain(x, m1, m2, wts, pooling, dtype), fwd,
           "block12_fwd_plain")
    _, _, _, a11, a21, a22 = fwd
    s1, s2 = tb.symmetrize(dg1, dtype), tb.symmetrize(dg2, dtype)
    dp1 = tb.block12_bwd_deep(a21, a22, dp2, m2, s2, wts, **kw)
    _equal(dp1, torch.stack([tb.block12_bwd_deep(
        a21[i], a22[i], dp2[i], m2[i], s2[i], wts, **kw) for i in range(b)]),
        "block12_bwd_deep")
    _equal(tb.block12_bwd_deep_plain(a21, a22, dp2, m2, s2, wts, pooling,
                                     dtype), dp1, "block12_bwd_deep_plain")
    dx = tb.block12_bwd_shallow(a11, dp1, m1, s1, wts, **kw)
    _equal(dx, torch.stack([tb.block12_bwd_shallow(
        a11[i], dp1[i], m1[i], s1[i], wts, **kw) for i in range(b)]),
        "block12_bwd_shallow")
    _equal(tb.block12_bwd_shallow_plain(a11, dp1, m1, s1, wts, pooling,
                                        dtype), dx, "block12_bwd_shallow_plain")
    _equal(tb.block12_bwd(a11, a21, a22, dp2, m1, m2, dg1, dg2, wts, **kw),
           dx, "block12_bwd")
    assert kernels.LAUNCHES == before

    fused = tb.make_block12_fused(**kw)
    xg = x.clone().requires_grad_(True)
    out = fused(xg, m1, m2, wts)
    _equal(tuple(o.detach() for o in out), fwd[:3], "make_block12_fused")
    (grad,) = torch.autograd.grad(out, xg, [dg1, dg2, dp2.float()])
    for i in range(b):
        xi = x[i].clone().requires_grad_(True)
        (gi,) = torch.autograd.grad(fused(xi, m1[i], m2[i], wts), xi,
                                    [dg1[i], dg2[i], dp2[i].float()])
        assert torch.equal(grad[i], gi), f"VJP pair {i}"


def test_wrappers_validate_a_batch(params):
    wts = tb.pack_weights(params, "float32")
    x = torch.zeros((2, 3, 64, 64))
    m1, m2 = torch.zeros((2, 1, 64, 64)), torch.zeros((2, 1, 32, 32))
    with pytest.raises(ValueError):          # masks of another batch
        tb.block12_fwd(x, m1[:1], m2[:1], wts, compute_dtype="float32")
    with pytest.raises(ValueError):          # a pair axis too many
        tb.block12_fwd(x[None], m1[None], m2[None], wts,
                       compute_dtype="float32")
    with pytest.raises(ValueError):          # one pair's cotangent
        tb.block12_bwd_deep(torch.zeros((2, 128, 32, 32)),
                            torch.zeros((2, 128, 32, 32)),
                            torch.zeros((2, 128, 16, 16)), m2,
                            torch.zeros((1, 128, 128)), wts,
                            compute_dtype="float32")


# --- the unit walk -----------------------------------------------------------

WALK_SHAPES = [(64, 64), (320, 4096), (384, 4096), (4096, 4096),
               (1024, 2048), (96, 16384)]


@pytest.mark.parametrize("b", [1, 2, 3, 8])
@pytest.mark.parametrize("h,w,rows", [
    (h, w, rows) for h, w in WALK_SHAPES for rows in (None,) + HEIGHTS
    if rows is None or h % rows == 0])
def test_unit_walk_covers_each_band_once(b, h, w, rows):
    """Every (pair, band) once, pair-major, in groups of group_bands(h, w,
    rows) units (the last group shorter), the scratch one pair's group
    whatever b is; where the bands of a pair are not a whole number of
    groups and b > 1, some group runs from one pair into the next. rows
    None: the height `band_rows(h, w)` picks."""
    groups = tb.unit_groups(b, h, w, tb=rows)
    rows = rows or tb.band_rows(h, w)
    nb, group = h // rows, tb.group_bands(h, w, rows)
    assert group == max(1, min(nb, tb.GROUP_PIXELS // (rows * w)))
    assert [u for g in groups for u in g] == [(i, j) for i in range(b)
                                              for j in range(nb)]
    assert all(len(g) == group for g in groups[:-1])
    assert 1 <= len(groups[-1]) <= group <= nb
    spans = [g for g in groups if g[0][0] != g[-1][0]]
    assert bool(spans) == (b > 1 and nb % group != 0)
    assert all(g[-1][0] - g[0][0] <= 1 for g in groups)


def test_real_sizes_have_a_group_that_spans_pairs():
    """The shapes the card's checks use: 320 × 4096 (5 bands of 64 rows a
    pair, groups of 4) spans pairs at B = 2 and 3; config6's 4096² does not
    (16 bands of 256 rows, groups of 1)."""
    assert (tb.band_rows(320, 4096), tb.group_bands(320, 4096)) == (64, 4)
    assert (tb.band_rows(4096, 4096), tb.group_bands(4096, 4096)) == (256, 1)
    for b in (2, 3):
        assert any(g[0][0] != g[-1][0] for g in tb.unit_groups(b, 320, 4096))
    assert not any(g[0][0] != g[-1][0]
                   for g in tb.unit_groups(2, 4096, 4096))


class _Unit:
    """csrc/block12.cu's Unit: unit u is band u % nb of pair u // nb."""

    def __init__(self, u, nb):
        self.pair, self.band = divmod(u, nb)


def _gather(src, u0, n, r, tbl, halo, nb):
    """block12_gather_kernel: src (B, C, Hs, W) -> the stack (C, n·R, W),
    stacked row rr = row band·tb − halo + rr % R of unit u0 + rr // R's
    pair, zero outside [0, Hs)."""
    hs = src.shape[2]
    out = src.new_zeros((src.shape[1], n * r, src.shape[3]))
    for rr in range(n * r):
        un = _Unit(u0 + rr // r, nb)
        g = un.band * tbl - halo + rr % r
        if 0 <= g < hs:
            out[:, rr] = src[un.pair, :, g]
    return out


def _scatter(stack, dst, u0, n, r, tbl, halo, nb):
    """block12_scatter_kernel: the own rows of each stacked band into its
    unit's pair's rows of dst (B, C, Hd, W)."""
    for b in range(n):
        un = _Unit(u0 + b, nb)
        dst[un.pair, :, un.band * tbl:(un.band + 1) * tbl] = \
            stack[:, b * r + halo:b * r + halo + tbl]


def _band_rows(r, tbl, halo, hg, band0, nb, rows):
    """conv::BandRows.inside on stacked rows `rows`: (1, len, 1) fp32."""
    inside = []
    for hh in rows:
        b = band0 + hh // r
        b -= nb if b >= nb else 0
        g = b * tbl - halo + hh % r
        inside.append(0 <= g < hg)
    return torch.tensor(inside, dtype=torch.float32)[None, :, None]


def _reduce_units(slots, out, u0, n, nb):
    """reduce_units: the group's slots folded in unit order into each
    unit's pair's sums, from zero at a pair's first band."""
    u = u0
    while u < u0 + n:
        un = _Unit(u, nb)
        end = min(u0 + n, (un.pair + 1) * nb)
        acc = torch.zeros_like(out[0]) if un.band == 0 else out[un.pair]
        for j in range(u - u0, end - u0):
            acc = acc + slots[j]
        out[un.pair] = acc
        u = end


def _walk(x, m1, m2, s1, s2, dp2, wts, pooling, cdt, group, rows):
    """The forward, deep and shallow backward as csrc/block12.cu walks a
    batch: bands of `rows` own rows, groups of `group` units, each stage
    with the kernels' index math; each band's arithmetic the plain version's.
    Returns (g1, g2, p2, a11, a21, a22, dp1, dx)."""
    b, _, h, w = x.shape
    k, nb = m1.shape[1], h // rows
    r0 = rows + 2 * HALO
    r1, r2 = r0 // 2, r0 // 4
    w11, b11, w12, b12, w21, b21, w22, b22 = wts[:8]
    # the Gram sums start unwritten, as the wrapper's torch.empty
    g1 = torch.full((b, k, 64, 64), float("nan"))
    g2 = torch.full((b, k, 128, 128), float("nan"))
    p2 = torch.empty((b, 128, h // 4, w // 4), dtype=cdt)
    a11 = torch.empty((b, 64, h, w), dtype=cdt)
    a21 = torch.empty((b, 128, h // 2, w // 2), dtype=cdt)
    a22 = torch.empty_like(a21)
    dp1 = torch.empty((b, 64, h // 2, w // 2), dtype=cdt)
    dx = torch.empty((b, 3, h, w))
    units = b * nb
    for u0 in range(0, units, group):
        n = min(group, units - u0)
        xe = _gather(x, u0, n, r0, rows, HALO, nb).to(cdt)
        st = {name: [] for name in ("a11", "a21", "a22", "p2", "s1", "s2")}
        for i in range(n):
            rows0 = range(i * r0, (i + 1) * r0)
            rm0 = _band_rows(r0, rows, HALO, h, u0 % nb, nb, rows0)
            rm1 = _band_rows(r1, rows // 2, HALO // 2, h // 2, u0 % nb, nb,
                             range(i * r1, (i + 1) * r1))
            e11 = tb._conv_bias_relu(xe[:, i * r0:(i + 1) * r0], w11, b11,
                                     rm0, cdt)
            e12 = tb._conv_bias_relu(e11, w12, b12, rm0, cdt)
            e21 = tb._conv_bias_relu(tb._pool(e12, pooling), w21, b21, rm1,
                                     cdt)
            e22 = tb._conv_bias_relu(e21, w22, b22, rm1, cdt)
            for name, t in (("a11", e11), ("a21", e21), ("a22", e22),
                            ("p2", tb._pool(e22, pooling))):
                st[name].append(t)
        stack = {name: torch.cat(t, dim=1) for name, t in st.items() if t}
        _scatter(stack["p2"], p2, u0, n, r2, rows // 4, HALO // 4, nb)
        _scatter(stack["a11"], a11, u0, n, r0, rows, HALO, nb)
        _scatter(stack["a21"], a21, u0, n, r1, rows // 2, HALO // 2, nb)
        _scatter(stack["a22"], a22, u0, n, r1, rows // 2, HALO // 2, nb)
        # the mask kernel: each band's own rows of its pair's m²
        own1 = _gather(m1, u0, n, rows, rows, 0, nb)
        own2 = _gather(m2, u0, n, rows // 2, rows // 2, 0, nb)
        slots1 = [tb._partial_gram(
            stack["a11"][:, i * r0 + HALO:i * r0 + HALO + rows],
            own1[:, i * rows:(i + 1) * rows], cdt) for i in range(n)]
        slots2 = [tb._partial_gram(
            stack["a21"][:, i * r1 + HALO // 2:i * r1 + HALO // 2 + rows // 2],
            own2[:, i * rows // 2:(i + 1) * rows // 2], cdt) for i in range(n)]
        _reduce_units(slots1, g1, u0, n, nb)
        _reduce_units(slots2, g2, u0, n, nb)
    ft21, ft22 = flip_transpose_weights(w21), flip_transpose_weights(w22)
    ft11, ft12 = flip_transpose_weights(w11), flip_transpose_weights(w12)
    for u0 in range(0, units, group):                  # the deep backward
        n = min(group, units - u0)
        sa21 = _gather(a21, u0, n, r1, rows // 2, HALO // 2, nb)
        sa22 = _gather(a22, u0, n, r1, rows // 2, HALO // 2, nb)
        sdp2 = _gather(dp2, u0, n, r2, rows // 4, HALO // 4, nb)
        sm2 = _gather(m2, u0, n, r1, rows // 2, HALO // 2, nb)
        outs = []
        for i in range(n):
            band = slice(i * r1, (i + 1) * r1)
            dz22 = (tb._pool_bwd(sdp2[:, i * r2:(i + 1) * r2], sa22[:, band],
                                 pooling, cdt)
                    * tb._relu_grad(sa22[:, band]).to(cdt))
            dz21 = tb.gram_dz_plain(sa21[:, band], sm2[:, band],
                                    s2[_Unit(u0 + i, nb).pair],
                                    conv3x3_acc(dz22, ft22), cdt)
            outs.append(conv3x3_acc(dz21, ft21).to(cdt))
        _scatter(torch.cat(outs, dim=1), dp1, u0, n, r1, rows // 2, HALO // 2,
                 nb)
    for u0 in range(0, units, group):                  # the shallow one
        n = min(group, units - u0)
        sa11 = _gather(a11, u0, n, r0, rows, HALO, nb)
        sdp1 = _gather(dp1, u0, n, r1, rows // 2, HALO // 2, nb)
        sm1 = _gather(m1, u0, n, r0, rows, HALO, nb)
        outs = []
        for i in range(n):
            band = slice(i * r0, (i + 1) * r0)
            rm0 = _band_rows(r0, rows, HALO, h, u0 % nb, nb,
                             range(i * r0, (i + 1) * r0))
            e12 = tb._conv_bias_relu(sa11[:, band], w12, b12, rm0, cdt)
            dz12 = (tb._pool_bwd(sdp1[:, i * r1:(i + 1) * r1], e12, pooling,
                                 cdt) * tb._relu_grad(e12).to(cdt))
            dz11 = tb.gram_dz_plain(sa11[:, band], sm1[:, band],
                                    s1[_Unit(u0 + i, nb).pair],
                                    conv3x3_acc(dz12, ft12), cdt)
            outs.append(conv3x3_acc(dz11, ft11))
        _scatter(torch.cat(outs, dim=1), dx, u0, n, r0, rows, HALO, nb)
    return g1, g2, p2, a11, a21, a22, dp1, dx


@pytest.mark.parametrize("rows", HEIGHTS)
@pytest.mark.parametrize("dtype,pooling", [("bfloat16", "max"),
                                           ("float32", "avg")])
def test_walk_with_groups_across_pairs_is_the_plain_batch(params, dtype,
                                                          pooling, rows):
    """Three pairs of 3·rows × 64 (3 bands of `rows` each, the height
    `band_rows` picks there) walked two units a group, so that a group runs
    from pair 0's last band into pair 1's first and the next starts
    mid-pair: the walk's outputs equal the batched plain versions' bit for
    bit."""
    b, h, w, k, group = 3, 3 * rows, 64, 2, 2
    assert tb.band_rows(h, w) == rows
    assert [[u[0] for u in g]
            for g in tb.unit_groups(b, h, w, group, rows)] == [
        [0, 0], [0, 1], [1, 1], [2, 2], [2]]
    x, m1, m2, dg1, dg2, dp2 = _batch(b, h, w, k, dtype, seed=31)
    wts = tb.pack_weights(params, dtype)
    cdt = getattr(torch, dtype)
    s1, s2 = tb.symmetrize(dg1, dtype), tb.symmetrize(dg2, dtype)
    got = _walk(x, m1, m2, s1, s2, dp2, wts, pooling, cdt, group, rows)
    fwd = tb.block12_fwd_plain(x, m1, m2, wts, pooling, dtype, tb=rows)
    dp1 = tb.block12_bwd_deep_plain(fwd[4], fwd[5], dp2, m2, s2, wts,
                                    pooling, dtype, tb=rows)
    dx = tb.block12_bwd_shallow_plain(fwd[3], dp1, m1, s1, wts, pooling,
                                      dtype, tb=rows)
    names = ("g1", "g2", "p2", "a11", "a21", "a22", "dp1", "dx")
    for name, g, want in zip(names, got, fwd + (dp1, dx)):
        assert torch.equal(g, want), name
