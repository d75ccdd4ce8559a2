"""What the bf16 Gram kernels (csrc/gram_wgmma.cuh) are handed, checked on
the CPU: the forward's split plan, the cotangent matrix of the backward and
the zero columns that pad P to a multiple of 8. The kernels themselves run
only on the card (chip_smoke.py holds them against the plain versions).

The padding and layout checks use small integers and masks in {0, ¼, ½, 1}:
every product and every partial sum is exact in fp32, so the results must
agree bit for bit whatever order the sums take."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpst_tpu.ops import losses as jlosses
from dpst_tpu_torch.ops import gram_stream as tgs
from dpst_tpu_torch.ops import kernels

SMS = 132          # streaming multiprocessors of the H100
# (C, P) of the taps conv1_1 … conv5_1 that take gram_fwd on the main paths
TAPS = {
    "512²": ((64, 1 << 18), (128, 1 << 16), (256, 1 << 14), (512, 1 << 12),
             (512, 1 << 10)),
    "1024²": ((64, 1 << 20), (128, 1 << 18), (256, 1 << 16), (512, 1 << 14),
              (512, 1 << 12)),
    "4096²": ((64, 1 << 24), (128, 1 << 22), (256, 1 << 20), (512, 1 << 18),
              (512, 1 << 16)),
}


def _exact_operands(c, p, k, seed):
    r = np.random.default_rng(seed)
    f = torch.from_numpy(r.integers(0, 9, (c, p)).astype(np.float32))
    m2 = torch.from_numpy(r.choice([0.0, 0.25, 0.5, 1.0], (k, p)).astype(
        np.float32))
    s = torch.from_numpy(r.integers(-4, 5, (k, c, c)).astype(np.float32))
    s = s + s.transpose(1, 2)
    return f.bfloat16(), m2.bfloat16(), s.bfloat16()


def _covered(splits, chunk, p):
    """Pixels each split covers, as the kernel's [split·chunk, min(P,
    (split+1)·chunk)) ranges."""
    return [(i * chunk, min(p, (i + 1) * chunk)) for i in range(splits)]


@pytest.mark.parametrize("size,c,p", [(size, c, p)
                                      for size, taps in TAPS.items()
                                      for c, p in taps])
def test_forward_plan_covers_p_once_and_fills_card(size, c, p):
    splits, chunk = tgs.fwd_plan(c, p, 4)
    assert chunk % 128 == 0
    ranges = _covered(splits, chunk, p)
    assert ranges[0][0] == 0 and ranges[-1][1] == p
    assert all(b == a2 for (_, b), (a2, _) in zip(ranges, ranges[1:]))
    assert all(b > a for a, b in ranges)          # no empty split
    assert tgs.fwd_blocks(c, 4, splits) >= SMS


@pytest.mark.parametrize("size,c,p", [(size, c, p)
                                      for size, taps in TAPS.items()
                                      for c, p in taps])
def test_backward_plan_fills_card(size, c, p):
    tile, groups, splits = tgs.bwd_plan(c, p, 4)
    ptiles, items = -(-p // 64), -(-c // 64) * 4
    assert tile == (64 if c <= 64 else 128)
    assert 1 <= groups <= ptiles
    per = -(-items // splits)
    assert (splits - 1) * per < items            # every split has items
    assert groups * -(-c // tile) * splits >= SMS


@pytest.mark.parametrize("c,p,k", [(96, 1008, 3), (8, 40, 1), (200, 3000, 5),
                                   (512, 16, 4), (64, 64, 1), (37, 336, 2)])
def test_forward_plan_small_shapes(c, p, k):
    splits, chunk = tgs.fwd_plan(c, p, k)
    covered = np.zeros(p, np.int64)
    for a, b in _covered(splits, chunk, p):
        covered[a:b] += 1
    assert chunk % 128 == 0 and (covered == 1).all()


def _uncapped_plan(c, p, k, b=1):
    """(splits, chunk) of the bf16 forward without FWD_SPLIT_MAX: one wave
    of 2 × 132 blocks, splits at least two 128-pixel stages deep."""
    blocks = tgs.fwd_blocks(c, k, 1) * b
    splits = max(1, min(2 * SMS // blocks, -(-p // 256)))
    chunk = -(-(-(-p // splits)) // 128) * 128
    return -(-p // chunk), chunk


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("size,c,p", [(size, c, p)
                                      for size, taps in TAPS.items()
                                      for c, p in taps])
def test_forward_plan_caps_a_split(b, size, c, p):
    """No split of the bf16 forward sums more than FWD_SPLIT_MAX pixels in
    its accumulators. Where it does not bind (every 512² tap, one pair or
    eight), the plan is the uncapped one; every 4096² tap binds."""
    splits, chunk = tgs.fwd_plan(c, p, 4, b)
    assert chunk % 128 == 0 and chunk <= tgs.FWD_SPLIT_MAX
    ranges = _covered(splits, chunk, p)
    assert ranges[-1][1] == p and all(hi > lo for lo, hi in ranges)
    assert b * splits <= 65535                   # the grid's z extent
    uncapped = _uncapped_plan(c, p, 4, b)
    if uncapped[1] <= tgs.FWD_SPLIT_MAX:
        assert (splits, chunk) == uncapped
    if size == "512²":
        assert (splits, chunk) == uncapped
    if size == "4096²":
        assert uncapped[1] > tgs.FWD_SPLIT_MAX


def test_capped_order_is_the_plain_version():
    """The capped plan of a long P (264 → 521 splits of 8064 pixels),
    emulated as the grid runs it (each split's partial, then the partials
    summed in split order) on exact operands (every partial sum an integer
    below 2^24), equals the plain version bit for bit."""
    c, p, k = 8, 1 << 22, 2
    r = np.random.default_rng(11)
    f = torch.from_numpy(r.integers(0, 2, (1, c, p)).astype(
        np.float32)).bfloat16()
    m2 = torch.from_numpy(r.choice([0.0, 1.0], (1, k, p)).astype(
        np.float32)).bfloat16()
    splits, chunk = tgs.fwd_plan(c, p, k)
    assert chunk <= tgs.FWD_SPLIT_MAX < _uncapped_plan(c, p, k)[1]
    got = _fwd_emulated(f, m2, splits, chunk)
    assert torch.equal(got, tgs.gram_fwd_plain(f, m2))


def _truncating_split(f, w):
    """One split of the bf16 forward under a model of the tensor cores'
    accumulation: each 16-pixel step's products (exact) are added to the
    fp32 accumulators and the sum is cut toward zero, not rounded."""
    acc = np.zeros((f.shape[0],) * 2, np.float32)
    for q in range(0, f.shape[1], 16):
        exact = acc.astype(np.float64) + f[:, q:q + 16] @ w[:, q:q + 16].T
        t = exact.astype(np.float32)
        high = np.abs(t.astype(np.float64)) > np.abs(exact)
        t[high] = np.nextafter(t[high], np.float32(0))
        acc = t
    return acc


def test_cap_bounds_a_truncating_accumulators_low_bias():
    """Why the plan caps a split. Under truncating accumulation a split of
    positive products comes out low by about its k16 steps × 2⁻²⁵ of its
    size: the 4096² taps' 63616-pixel splits (3976 steps) against the
    capped 8064 (504 steps), their partials summed in fp32 with
    round-to-nearest adds: the mean signed error falls below a quarter of
    the uncapped one, the max below 1e-4 of max |G| (chip_smoke.py holds
    the card to 1e-4 at 4096²)."""
    r = np.random.default_rng(3)
    c, p = 8, 63616
    f = torch.from_numpy(np.abs(r.normal(size=(c, p))).astype(
        np.float32)).bfloat16().float().numpy().astype(np.float64)
    m2 = torch.from_numpy(r.uniform(0, 1, p).astype(
        np.float32)).bfloat16().float().numpy().astype(np.float64)
    w = torch.from_numpy((f * m2).astype(np.float32)).bfloat16(
        ).float().numpy().astype(np.float64)
    ref = f @ w.T
    whole = _truncating_split(f, w)
    capped = np.zeros((c, c), np.float32)
    for a in range(0, p, 8064):
        capped = capped + _truncating_split(f[:, a:a + 8064],
                                            w[:, a:a + 8064])
    errs = {}
    for name, g in (("whole", whole), ("capped", capped)):
        d = g.astype(np.float64) - ref
        errs[name] = (d.mean() / np.abs(ref).mean(),
                      np.abs(d).max() / np.abs(ref).max())
    assert errs["whole"][0] < 0 and errs["whole"][1] > 5e-5
    assert abs(errs["capped"][0]) <= abs(errs["whole"][0]) / 4
    assert errs["capped"][1] <= 1e-4


@pytest.mark.parametrize("c,k", [(64, 4), (96, 3), (8, 1), (37, 2), (200, 5)])
def test_s_matrix_is_the_plain_versions_a(c, k):
    s = torch.from_numpy(np.random.default_rng(c).normal(
        size=(k, c, c)).astype(np.float32)).bfloat16()
    a = tgs.s_matrix(s)
    plain = s.permute(1, 0, 2).reshape(c, k * c)      # gram_bwd_plain's a
    cp = -(-c // 8) * 8
    assert a.shape == (c, k * cp)
    blocks = a.reshape(c, k, cp)
    assert torch.equal(blocks[:, :, :c].reshape(c, k * c), plain)
    assert not blocks[:, :, c:].any()
    if c % 8 == 0:
        assert torch.equal(a, plain)


@pytest.mark.parametrize("c,p,k", [(96, 1001, 3), (512, 9, 4), (37, 333, 2)])
def test_pixel_padding_is_exact(c, p, k):
    f, m2, s = _exact_operands(c, p, k, seed=p)
    fp, mp = tgs.pad_pixels(f), tgs.pad_pixels(m2)
    assert fp.shape == (c, -(-p // 8) * 8) and mp.shape[1] == fp.shape[1]
    assert not fp[:, p:].any() and not mp[:, p:].any()
    assert torch.equal(tgs.gram_fwd_plain(fp, mp), tgs.gram_fwd_plain(f, m2))
    assert torch.equal(tgs.gram_bwd_plain(fp, mp, s)[:, :p],
                       tgs.gram_bwd_plain(f, m2, s))
    assert tgs.pad_pixels(fp) is fp                   # no copy when aligned


@pytest.mark.parametrize("c,p,k", [(37, 333, 2), (64, 1000, 4)])
def test_backward_layout_contract(c, p, k):
    """dF from what the bf16 backward reads (the padded F and m², the
    matrix s_matrix(S) against the (K·Cp, P) weighted block whose padded
    rows are zero) equals the plain version's."""
    f, m2, s = _exact_operands(c, p, k, seed=c)
    fp, mp, a = tgs.pad_pixels(f), tgs.pad_pixels(m2), tgs.s_matrix(s)
    cp = a.shape[1] // k
    w = torch.zeros((k, cp, fp.shape[1]), dtype=torch.bfloat16)
    w[:, :c] = fp.unsqueeze(0) * mp.unsqueeze(1)
    got = torch.matmul(a.float(), w.reshape(k * cp, -1).float())
    assert torch.equal(got.bfloat16()[:, :p], tgs.gram_bwd_plain(f, m2, s))


def test_padded_forward_matches_jax_at_odd_p():
    c, p, k = 16, 333, 3
    f, m2, _ = _exact_operands(c, p, k, seed=5)
    got = tgs.gram_fwd_plain(tgs.pad_pixels(f), tgs.pad_pixels(m2)).numpy()
    ref = np.asarray(jlosses._grams_raw_flat(
        jnp.asarray(f.float().numpy().T, jnp.bfloat16),
        jnp.asarray(m2.float().numpy(), jnp.bfloat16)))
    np.testing.assert_array_equal(got, ref.reshape(c, k, c).transpose(1, 0, 2))


def test_gram_wrappers_refuse_other_devices():
    f, m2 = torch.zeros(8, 16, device="meta", dtype=torch.bfloat16), \
        torch.zeros(2, 16, dtype=torch.bfloat16)
    s = torch.zeros(2, 8, 8, dtype=torch.bfloat16)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        tgs.gram_fwd(f, m2)
    with pytest.raises(ValueError):
        tgs.gram_bwd(f, m2, s)
    assert kernels.LAUNCHES == before


# --- a batch of B pairs: the pair an index of the grid ---------------------

def _exact_batch(b, c, p, k, seed):
    parts = [_exact_operands(c, p, k, seed + i) for i in range(b)]
    return tuple(torch.stack([q[j] for q in parts]) for j in range(3))


@pytest.mark.parametrize("b", [2, 8])
@pytest.mark.parametrize("c,p", TAPS["512²"])
def test_batched_plans_fill_the_card_with_fewer_splits(b, c, p):
    """B pairs share the card: the forward's grid of tiles × class groups ×
    B × splits and the backward's grid still fill it, each with no more
    splits than one pair takes."""
    splits, chunk = tgs.fwd_plan(c, p, 4, b)
    assert splits <= tgs.fwd_plan(c, p, 4)[0]
    assert tgs.fwd_blocks(c, 4, splits) * b >= SMS
    ranges = _covered(splits, chunk, p)
    assert ranges[0][0] == 0 and ranges[-1][1] == p
    assert all(hi > lo for lo, hi in ranges)
    tile, groups, bsplits = tgs.bwd_plan(c, p, 4, b)
    assert bsplits <= tgs.bwd_plan(c, p, 4)[2]
    assert 1 <= groups <= -(-p // 64)
    assert groups * -(-c // tile) * bsplits * b >= SMS


def _fwd_emulated(f, m2, splits, chunk):
    """gram.cu's batched bf16 forward as the grid runs it: block z = pair ·
    splits + split reads F and m² at the pair's offsets (C·P and K·P
    elements on, gram90::FwdArgs' band strides) from flat buffers, writes
    its partial at work[z] (B, splits, K, C, C), and gram_reduce_kernel
    sums each pair's partials in split order from 0."""
    b, c, p = f.shape
    k = m2.shape[1]
    ff, mf = f.float().reshape(-1), m2.float().reshape(-1)
    n = k * c * c
    work = torch.full((b * splits * n,), float("nan"))
    for z in range(b * splits):
        pair, split = divmod(z, splits)
        lo, hi = split * chunk, min(p, (split + 1) * chunk)
        fz = ff[pair * c * p:(pair + 1) * c * p].reshape(c, p)[:, lo:hi]
        mz = mf[pair * k * p:(pair + 1) * k * p].reshape(k, p)[:, lo:hi]
        wz = (fz.unsqueeze(0) * mz.unsqueeze(1)).bfloat16().float()
        work[z * n:(z + 1) * n] = torch.matmul(
            fz, wz.transpose(1, 2)).reshape(-1)
    out = torch.empty(b * n)
    for idx in range(0, b * n, n):
        pair = idx // n
        acc = torch.zeros(n)
        for sp in range(splits):
            acc = acc + work[(pair * splits + sp) * n:
                             (pair * splits + sp + 1) * n]
        out[idx:idx + n] = acc
    return out.reshape(b, k, c, c)


def _bwd_emulated(f, m2, s, tile, splits):
    """gram.cu's batched bf16 backward as the grid runs it: block z = pair
    · splits + split (nsplit = gridDim.z / pairs) takes the split's items
    (64-channel chunk j, class k) of the pair's operands at C·P, K·P and
    C·K·Cp elements on, writes its fp32 partial at work[split][pair] (the
    split-major (splits, B, C, P)), and gram_bwd_reduce_kernel sums over
    the splits for all B·C·P elements at once and rounds once."""
    b, c, p = f.shape
    k = m2.shape[1]
    a = tgs.s_matrix(s).float()                        # (B, C, K·Cp)
    cpad = a.shape[-1] // k
    nit = -(-c // 64) * k
    ipb = -(-nit // splits)
    ff, mf = f.float().reshape(-1), m2.float().reshape(-1)
    af = a.reshape(-1)
    n = b * c * p
    work = torch.full((splits * n,), float("nan"))
    for z in range(b * splits):
        pair, split = divmod(z, splits)
        fz = ff[pair * c * p:(pair + 1) * c * p].reshape(c, p)
        mz = mf[pair * k * p:(pair + 1) * k * p].reshape(k, p)
        az = af[pair * c * k * cpad:(pair + 1) * c * k * cpad].reshape(
            c, k * cpad)
        acc = torch.zeros(c, p)
        for it in range(split * ipb, min(nit, (split + 1) * ipb)):
            j, kk = divmod(it, k)
            rows = slice(64 * j, min(c, 64 * j + 64))
            w = (fz[rows] * mz[kk]).bfloat16().float()
            cols = slice(kk * cpad + 64 * j, kk * cpad + 64 * j
                         + (rows.stop - rows.start))
            acc = acc + torch.matmul(az[:, cols], w)
        base = (split * b + pair) * c * p
        work[base:base + c * p] = acc.reshape(-1)
    out = torch.zeros(n)
    for sp in range(splits):
        out = out + work[sp * n:(sp + 1) * n]
    return out.bfloat16().reshape(b, c, p)


@pytest.mark.parametrize("b,c,p,k,splits", [(3, 96, 1000, 3, 2),
                                            (2, 37, 333, 2, 1),
                                            (3, 130, 520, 4, 3)])
def test_batched_index_math_is_the_plain_version(b, c, p, k, splits):
    """The batched forward and backward, emulated with the kernels' pair
    offsets, grid order and split-major work layout on exact operands,
    equal the plain versions pair by pair bit for bit (a pair offset or a
    work slot off by one pair would show: every pair's operands differ)."""
    f, m2, s = _exact_batch(b, c, p, k, seed=p)
    fp, mp = tgs.pad_pixels(f), tgs.pad_pixels(m2)
    chunk = -(-(-(-fp.shape[-1] // splits)) // 128) * 128
    fsplits = -(-fp.shape[-1] // chunk)
    got = _fwd_emulated(fp, mp, fsplits, chunk)
    assert torch.equal(got, tgs.gram_fwd_plain(f, m2))
    dz = _bwd_emulated(fp, mp, s, 64 if c <= 64 else 128, splits)
    assert torch.equal(dz[..., :p], tgs.gram_bwd_plain(f, m2, s))


def test_batched_s_matrix_is_each_pairs():
    s = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 2, 37, 37)).astype(np.float32)).bfloat16()
    a = tgs.s_matrix(s)
    assert a.shape == (3, 37, 2 * 40)
    for i in range(3):
        assert torch.equal(a[i], tgs.s_matrix(s[i]))
