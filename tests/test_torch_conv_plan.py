"""What the bf16 conv body (csrc/conv3x3_wgmma.cuh) and block12's bf16 Gram
partials are handed, checked on the CPU: the packed weights, the conv
plan, conv1_1's packed-K form and the per-band Gram split. The kernels
themselves run only on the card (chip_smoke.py holds them against the
plain versions).

Operands are small integers (and masks in {0, ¼, ½, 1}): every product and
every partial sum is exact in fp32, so the compared results must agree
bit for bit whatever order the sums take."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dpst_tpu.ops import block12_pallas as jb
from dpst_tpu.ops import conv_pallas as jconv
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import block12_pallas as tb
from dpst_tpu_torch.ops import conv_cuda as tconv
from dpst_tpu_torch.ops import gram_stream as tgs
from dpst_tpu_torch.ops import kernels

SMS = 132


def _int_weights(cin, cout, seed):
    """HWIO numpy weights in {−2, …, 2} and the same values OIHW."""
    w = np.random.default_rng(seed).integers(-2, 3, (3, 3, cin, cout))
    w = w.astype(np.float32)
    return w, torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


# --- packed weights

@pytest.mark.parametrize("cin,cout", [(64, 64), (3, 64), (64, 3), (72, 40),
                                      (128, 256), (5, 11)])
def test_packed_weights_equal_oihw_and_jax_flip(cin, cout):
    jw, tw = _int_weights(cin, cout, cin + cout)
    cinp = -(-cin // 8) * 8
    wp = tconv.pack_weights(tw.bfloat16())
    assert wp.shape == (9, cout, cinp) and wp.is_contiguous()
    got = wp.float().numpy()
    for dy in range(3):
        for dx in range(3):
            np.testing.assert_array_equal(got[3 * dy + dx, :, :cin],
                                          jw[dy, dx].T)
    assert not got[:, :, cin:].any()
    assert torch.equal(tconv.unpack_weights(wp, cin), tw.bfloat16())
    # the input-gradient conv's weights, packed once: JAX's
    # flip_transpose_weights (HWIO (3, 3, Cout, Cin)) element for element
    jft = np.asarray(jconv.flip_transpose_weights(jnp.asarray(jw)))
    tp = tconv.pack_grad_weights(tw.bfloat16())
    assert tp.is_contiguous() and torch.equal(
        tp, tconv.pack_weights(tconv.flip_transpose_weights(tw.bfloat16())))
    assert tp.shape == (9, cin, -(-cout // 8) * 8)
    ft = tp.float().numpy()
    for dy in range(3):
        for dx in range(3):
            np.testing.assert_array_equal(ft[3 * dy + dx, :, :cout],
                                          jft[dy, dx].T)
    assert not ft[:, :, cout:].any()


@pytest.mark.parametrize("cout", [64, 8, 3])
def test_packed_k27_weights(cout):
    jw, tw = _int_weights(3, cout, cout)
    wk = tconv.pack_k27(tw).numpy()
    assert wk.shape == (cout, 32)
    for dy in range(3):
        for dx in range(3):
            for ci in range(3):
                np.testing.assert_array_equal(
                    wk[:, 3 * (3 * dy + dx) + ci], jw[dy, dx, ci])
    assert not wk[:, 27:].any()


# --- the plan

def _conv_cases():
    """(Cin, Cout, H, W) of every bf16 conv on the paths: chip_smoke's 512²
    shapes and their input gradients, and block12's stacked group shapes
    at 4096² (8 bands of 48 rows; conv1_x at 384 × 4096, conv2_x at 192 ×
    2048), forward and input gradient."""
    out = []
    for cin, cout, hw in chip_smoke.CONV_SHAPES:
        out += [(cin, cout, hw, hw), (cout, cin, hw, hw)]
    out += [(64, 64, 384, 4096), (64, 3, 384, 4096),
            (64, 128, 192, 2048), (128, 128, 192, 2048), (128, 64, 192, 2048)]
    return sorted(set(out))


def _ranges(n, step):
    return [(a, min(n, a + step)) for a in range(0, n, step)]


@pytest.mark.parametrize("cin,cout,h,w", _conv_cases())
def test_plan_covers_once_fills_card_and_fits(cin, cout, h, w):
    bn, splits, cps = tconv.conv_plan(cin, cout, h, w)
    th, tw = tconv.TILE
    # the kernel's grid: pixel tiles × channel tiles × splits
    rows, cols, chans = _ranges(h, th), _ranges(w, tw), _ranges(cout, bn)
    for rs, n in ((rows, h), (cols, w), (chans, cout)):
        assert rs[0][0] == 0 and rs[-1][1] == n
        assert all(b == a2 for (_, b), (a2, _) in zip(rs, rs[1:]))
    chunks = -(-cin // tconv.CHUNK)
    cover = np.zeros(chunks, np.int64)
    for z in range(splits):
        a, b = z * cps, min(chunks, (z + 1) * cps)
        assert b > a                                  # no empty split
        cover[a:b] += 1
    assert (cover == 1).all()
    assert bn % 8 == 0 and bn <= 128 and (bn == 128 or bn < cout + 8)
    blocks = len(rows) * len(cols) * len(chans) * splits
    assert blocks == tconv.conv_blocks(cout, h, w) * splits
    assert blocks >= 0.9 * SMS                        # one block an SM
    smem = tconv.conv_smem_bytes(bn, cps)
    assert smem <= tconv.SMEM_LIMIT
    if bn <= 64 and cps == 1:                         # two blocks an SM
        assert 2 * smem <= tconv.SMEM_LIMIT
    if h * w >= 384 * 4096 // 4:                      # block12: one split
        assert splits == 1


@pytest.mark.parametrize("cout,bn", [(3, 8), (40, 40), (64, 64), (72, 72),
                                     (128, 128), (512, 128)])
def test_width_pads_to_multiple_of_8(cout, bn):
    assert tconv.conv_width(cout) == bn


# --- conv1_1 as one K of 32

@pytest.mark.parametrize("r,w", [(48, 32), (12, 20)])
def test_k27_form_matches_jax_conv_bias_relu_exactly(r, w):
    rng = np.random.default_rng(r + w)
    x = rng.integers(-3, 4, (3, r, w)).astype(np.float32)
    jw, tw = _int_weights(3, 64, r)
    b = rng.integers(-4, 5, (64,)).astype(np.float32)
    rowmask = (rng.random((1, r, 1)) < 0.8).astype(np.float32)
    ref = np.asarray(jb._conv_bias_relu(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(jw, jnp.bfloat16),
        jnp.asarray(b), jnp.asarray(rowmask), jnp.bfloat16), np.float32)
    tx = torch.from_numpy(x).bfloat16()
    acc = tconv.conv3x3_k27_acc(tx, tconv.pack_k27(tw.bfloat16()))
    assert torch.equal(acc, tconv.conv3x3_acc(tx, tw.bfloat16()))
    got = ((torch.clamp_min(acc + torch.from_numpy(b)[:, None, None], 0.0)
            * torch.from_numpy(rowmask)).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(), ref)


# --- block12's Gram partials, band by band

def _sparse_params(seed):
    """VGG params whose blocks 1-2 weights are sparse 0/1 and biases 0, so
    that the activations stay small integers (exact in bf16)."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, (cin, cout) in tvgg.CONV_SHAPES.items():
        dens = {"conv1_1": 0.1, "conv1_2": 0.01, "conv2_1": 0.004}.get(name,
                                                                        0.0)
        w = (rng.random((cout, cin, 3, 3)) < dens).astype(np.float32)
        params[name] = {"w": torch.from_numpy(w),
                        "b": torch.zeros(cout)}
    return params


@pytest.mark.parametrize("h,w,k", [(64, 32, 2), (96, 16, 3)])
def test_band_split_gram_matches_block12_plain_exactly(h, w, k):
    rng = np.random.default_rng(h + w + k)
    x = torch.from_numpy(rng.integers(0, 3, (3, h, w)).astype(np.float32))
    quarter = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    m1 = torch.from_numpy(rng.choice(quarter, (k, h, w)))
    m2 = torch.from_numpy(rng.choice(quarter, (k, h // 2, w // 2)))
    wts = tb.pack_weights(_sparse_params(h), "bfloat16")
    rows = 32                                   # bands of 32 rows
    g1, g2, _, a11, a21, _ = tb.block12_fwd_plain(x, m1, m2, wts, "max",
                                                  "bfloat16", True, rows)
    assert float(a11.float().abs().max()) <= 256
    assert float(a21.float().abs().max()) <= 256
    for g, f, m, tbl in ((g1, a11, m1, rows), (g2, a21, m2, rows // 2)):
        c = f.shape[0]
        want = torch.zeros((k, c, c))
        for band in range(h // rows):
            own = slice(band * tbl, (band + 1) * tbl)
            want = want + tgs.gram_fwd_plain(
                f[:, own].reshape(c, -1),
                m[:, own].reshape(k, -1).bfloat16())
        assert float(want.abs().max()) < 2 ** 24          # exact sums
        assert torch.equal(want, g)


# --- the per-run packing

def test_pack_params_once_gives_the_same_features_and_gradient():
    """extract_features on `pack_params`' packed weights (conv_impl
    "pallas": the kernel's path, plain on the CPU) against the raw dict,
    and the image gradient through both."""
    params = tvgg.init_params(3)
    packed = tvgg.pack_params(params, "float32", "pallas")
    assert "wp" not in packed["conv1_1"]              # conv1_1 stays cuDNN
    assert packed["conv2_1"]["wp"].shape == (9, 128, 64)
    assert packed["conv2_1"]["ftp"].shape == (9, 64, 128)
    assert len(packed.block12) == len(tb.Block12Weights._fields)
    assert tvgg.pack_params(packed, "float32", "pallas") is packed
    assert "wp" not in tvgg.pack_params(packed, "float32")["conv2_1"]
    for a, b in zip(tvgg.pack_params(params, "float32").block12,
                    packed.block12):
        assert torch.equal(a, b)
    img = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 255, (16, 24, 3)).astype(np.float32))
    outs = []
    for p in (params, packed):
        x = img.clone().requires_grad_(True)
        f = tvgg.extract_features(p, x, ("conv1_2", "conv3_1"),
                                  conv_impl="pallas")
        (g,) = torch.autograd.grad(f["conv3_1"].sum(), x)
        outs.append((f["conv1_2"], f["conv3_1"], g))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_conv_takes_packed_weights_and_counts_nothing_on_cpu():
    _, tw = _int_weights(12, 16, 1)
    x = torch.from_numpy(np.random.default_rng(2).integers(
        -3, 4, (12, 9, 10)).astype(np.float32))
    before = dict(kernels.LAUNCHES)
    y = tconv.conv3x3_same(x, tconv.pack_weights(tw))
    assert torch.equal(y, tconv.conv3x3_same(x, tw))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError):                   # Cinp must be 16
        tconv.conv3x3_same(x, torch.zeros(9, 16, 12))


# --- conv3x3's batch grid dimension -----------------------------------------

@pytest.mark.parametrize("b", [2, 8])
@pytest.mark.parametrize("cin,cout,h,w", [c for c in _conv_cases()
                                          if c[2] * c[3] <= 512 * 512])
def test_batched_plan_covers_once_and_fills_card(b, cin, cout, h, w):
    """conv_plan(b=…): the grid of pixel tiles × channel tiles × (B pairs
    × splits) visits every (pair, tile, chunk of Cin) once, fills the
    card, and cuts Cin as one image's plan does (each image's sums then
    round in the batch as alone)."""
    bn, splits, cps = tconv.conv_plan(cin, cout, h, w, b)
    assert (bn, splits, cps) == tconv.conv_plan(cin, cout, h, w)
    chunks = -(-cin // tconv.CHUNK)
    cover = np.zeros((b, chunks), np.int64)
    for z in range(b * splits):                     # blockIdx.z
        pair, split = divmod(z, splits)
        a, e = split * cps, min(chunks, (split + 1) * cps)
        assert e > a
        cover[pair, a:e] += 1
    assert (cover == 1).all()
    assert b * tconv.conv_blocks(cout, h, w) * splits >= 0.9 * SMS
    assert tconv.conv_smem_bytes(bn, cps) <= tconv.SMEM_LIMIT


def _conv_emulated(x, wp, splits, cps):
    """conv3x3.cu's batched bf16 launch as its grid runs: block z = pair ·
    splits + split reads the pair's image at Cin·H·W elements on, sums its
    split's 64-channel chunks of Cin tap by tap in fp32, and writes its
    partial at work[z] (the (B, splits, Cout, H, W) layout) or, with one
    split, rounds into y at the pair's Cout·H·W elements; the reduction,
    a grid row a pair, sums each pair's partials in split order and
    rounds once."""
    b, cin, h, w = x.shape
    cout = wp.shape[1]
    xf = x.float().reshape(-1)
    xp_all = torch.nn.functional.pad(
        xf.view(b, cin, h, w), (1, 1, 1, 1))
    n = cout * h * w
    work = torch.full((b * splits * n,), float("nan"))
    for z in range(b * splits):
        pair, split = divmod(z, splits)
        xp = xp_all[pair]
        acc = torch.zeros(cout, h * w)
        for c0 in range(split * cps * 64, min(cin, (split + 1) * cps * 64),
                        64):
            chans = slice(c0, min(cin, c0 + 64))
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                tap_x = xp[chans, dy:dy + h, dx:dx + w].reshape(-1, h * w)
                acc = acc + torch.matmul(wp[tap, :, chans].float(), tap_x)
        work[z * n:(z + 1) * n] = acc.reshape(-1)
    y = torch.empty(b * n)
    for pair in range(b):                           # blockIdx.y
        s = torch.zeros(n)
        for sp in range(splits):
            s = s + work[(pair * splits + sp) * n:(pair * splits + sp + 1)
                         * n]
        y[pair * n:(pair + 1) * n] = s
    return y.view(b, cout, h, w).to(x.dtype)


@pytest.mark.parametrize("b,cin,cout,h,w,splits", [(3, 128, 40, 9, 13, 2),
                                                   (2, 70, 24, 8, 11, 1),
                                                   (2, 200, 16, 5, 7, 4)])
def test_batched_conv_index_math_is_the_plain_version(b, cin, cout, h, w,
                                                      splits):
    """The batched conv, emulated with its pair offsets, grid order and
    (B, splits, ...) partials on integer operands, equals the plain
    version image by image bit for bit, and each image its own one-image
    launch."""
    r = np.random.default_rng(cin + h)
    x = torch.from_numpy(r.integers(-3, 4, (b, cin, h, w)).astype(
        np.float32)).bfloat16()
    _, wt = _int_weights(cin, cout, seed=w)
    wt = wt.bfloat16()
    wp = tconv.pack_weights(wt)
    chunks = -(-cin // tconv.CHUNK)
    cps = -(-chunks // splits)
    got = _conv_emulated(x, wp, -(-chunks // cps), cps)
    assert torch.equal(got, tconv.conv3x3_plain(x, wt))
    for i in range(b):
        one = _conv_emulated(x[i:i + 1], wp, -(-chunks // cps), cps)
        assert torch.equal(one[0], got[i])
