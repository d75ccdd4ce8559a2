"""What the bf16 Hopper bodies of `gram_relu_fwd` and `gram_wbwd`
(csrc/gram_wgmma.cuh) are handed, and the order in which `gram_wbwd`'s body
sums, checked on the CPU. The kernels themselves run only on the card
(chip_smoke.py holds them against the plain versions).

- `gram_relu_fwd`: z and m² padded to P % 8 == 0 with zero columns; with
  b > 0 the padding cooks to relu(b) > 0, and adds nothing only because its
  m² is zero. Held to the plain version on the unpadded operands (bit for
  bit) and to dpst_tpu/ops/gram_s2d.py's v2 and v1 kernels in interpret
  mode (rtol 1e-5, atol 1e-5 of max|G|, as tests/test_torch_gram_s2d.py).
- `gram_wbwd`: a torch emulation of the body's class-outer walk (per split
  of whole classes, per 128-pixel tile, classes outer and 64-channel chunks
  inner, each class's product complete before it meets its mask, split
  partials summed in split order and rounded once) against
  `gram_wbwd_plain` (bit for bit) and against
  dpst_tpu/ops/gram_pallas.py:_bwd_call in interpret mode (one bf16 ulp of
  max|dF|, as tests/test_torch_gram_pallas.py).
- The plans: `fwd_plan` at the relu shapes and `wbwd_plan` at every shape
  that takes `gram_wbwd` on the main paths cover their work once and fill
  the H100's 132 SMs.

Operands are exact (small integers, masks in {0, ¼, ½, 1}): every product
and partial sum is exact in fp32, so results agree bit for bit whatever
order the sums take."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpst_tpu.ops import gram_pallas as jgp
from dpst_tpu.ops import gram_s2d as jg2
from dpst_tpu_torch.ops import gram_pallas as tgp
from dpst_tpu_torch.ops import gram_s2d as tg2
from dpst_tpu_torch.ops import gram_stream as tgs
from dpst_tpu_torch.ops import kernels
from dpst_tpu_torch.ops import losses as tlosses

SMS = 132          # streaming multiprocessors of the H100
# (C, P) of conv1_1, the tap that takes gram_relu_fwd: on the 512² pallas
# route, at config4's 1024² stage and at 4096²
RELU_TAPS = ((64, 1 << 18), (64, 1 << 20), (64, 1 << 24))
# (C, P) of the taps that take gram_wbwd: conv2_1 … conv5_1 on the 512²
# pallas route, conv2_1 and conv3_1 on the 4096² standard path (the "auto"
# stream route past the fused bound), conv3_1 on config6's stream12 route
WBWD_TAPS = {
    "512² pallas route": ((128, 1 << 16), (256, 1 << 14), (512, 1 << 12),
                          (512, 1 << 10)),
    "4096² stream taps": ((128, 1 << 22), (256, 1 << 20)),
    "config6 conv3_1": ((256, 1 << 20),),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exact(shape, r, lo, hi):
    return torch.from_numpy(r.integers(lo, hi, shape).astype(np.float32))


def _masks(k, p, r):
    return torch.from_numpy(r.choice([0.0, 0.25, 0.5, 1.0], (k, p)).astype(
        np.float32)).bfloat16()


def _wbwd_operands(c, p, k, seed):
    r = np.random.default_rng(seed)
    f = _exact((c, p), r, 0, 9).bfloat16()
    s = _exact((k, c, c), r, -4, 5)
    return f, _masks(k, p, r), (s + s.transpose(1, 2)).bfloat16()


def _relu_operands(c, p, k, seed):
    """Raw tap z in -4 … 4, a positive bias in {½, 1, …, 2}, exact masks."""
    r = np.random.default_rng(seed)
    z = _exact((c, p), r, -4, 5).bfloat16()
    b = (_exact((c,), r, 1, 5) / 2).bfloat16()
    return z, b, _masks(k, p, r)


# --- gram_relu_fwd -----------------------------------------------------------

def _jax_s2d_grams(z, b, m2, v2):
    """G_k of relu(z + b) by dpst_tpu/ops/gram_s2d.py's kernels (interpret
    mode off the TPU): (C, P) becomes the s2d operand (P/4, 4C), pixel 4q +
    par at row q, lane group par; m² the lane stack par·K + j."""
    c, p = z.shape
    k = m2.shape[0]
    q = p // 4
    zp = jnp.asarray(z.float().reshape(c, q, 4).permute(1, 2, 0)
                     .reshape(q, 4 * c).numpy(), jnp.bfloat16)
    m2t = m2.float().reshape(k, q, 4).permute(1, 2, 0).reshape(q, 4 * k)
    m2t = jnp.asarray(np.pad(m2t.numpy(), ((0, 0), (0, 128 - 4 * k))),
                      jnp.bfloat16)
    bias8 = jnp.broadcast_to(jnp.asarray(np.tile(b.float().numpy(), 4),
                                         jnp.bfloat16), (8, 4 * c))
    if v2:
        raw = jg2._gram_s2d2_raw(zp, bias8, m2t,
                                 jg2._e2h_const(k, c, jnp.bfloat16), k, c)
        g4 = np.asarray(raw).reshape(2, k, 2 * c, 2 * c)
        return sum(g4[h, :, g * c:(g + 1) * c, g * c:(g + 1) * c]
                   for h in range(2) for g in range(2))
    g256 = np.asarray(jg2._gram_s2d_raw(
        zp, bias8, m2t, jg2._e2_const(k, c, jnp.bfloat16), k, c))
    return sum(g256[:, i * c:(i + 1) * c, i * c:(i + 1) * c]
               for i in range(4))


@pytest.mark.parametrize("v2", [True, False], ids=["v2", "v1"])
@pytest.mark.parametrize("p,k", [(1021, 3), (1017, 1), (1023, 4)])
def test_relu_forward_padding_is_exact(p, k, v2):
    """The wrapper's padded operands give the unpadded Grams bit for bit,
    though the zero columns cook to relu(b) > 0, and the JAX package's
    kernels on the padded operands give the same (C = 64, their width)."""
    c = 64
    z, b, m2 = _relu_operands(c, p, k, seed=p + k)
    zp, mp = tgs.pad_pixels(z), tgs.pad_pixels(m2)
    assert zp.shape == (c, 1024) and mp.shape == (k, 1024)
    assert not zp[:, p:].any() and not mp[:, p:].any()
    assert bool((tg2._cook(zp, b)[:, p:] > 0).all())
    ref = tg2.gram_relu_fwd_plain(z, b, m2)
    assert torch.equal(tg2.gram_relu_fwd_plain(zp, b, mp), ref)
    got = _jax_s2d_grams(zp, b, mp, v2)
    np.testing.assert_allclose(ref.numpy(), got, rtol=1e-5,
                               atol=1e-5 * float(np.abs(got).max()))


@pytest.mark.parametrize("c,p", RELU_TAPS)
def test_relu_forward_plan_covers_p_once_and_fills_card(c, p):
    splits, chunk = tgs.fwd_plan(c, p, 4)
    assert chunk % 128 == 0
    ranges = [(i * chunk, min(p, (i + 1) * chunk)) for i in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == p
    assert all(b == a2 for (_, b), (a2, _) in zip(ranges, ranges[1:]))
    assert all(b > a for a, b in ranges)
    assert tgs.fwd_blocks(c, 4, splits) >= SMS


# --- gram_wbwd ---------------------------------------------------------------

def _class_outer(f, m2, s, plan):
    """gram_wbwd_body's sums, in its order, on the operands the wrapper
    hands it (padded F and m², the matrix s_matrix(S))."""
    _, _, splits = plan
    c, p = f.shape
    k = m2.shape[0]
    fp, mp = tgs.pad_pixels(f).float(), tgs.pad_pixels(m2).float()
    a = tgs.s_matrix(s).float()
    cpad = a.shape[1] // k
    kps = -(-k // splits)
    out = torch.zeros(fp.shape)
    for split in range(splits):
        part = torch.zeros(fp.shape)
        for p0 in range(0, fp.shape[1], tgp.WBWD_PIXELS):
            px = slice(p0, p0 + tgp.WBWD_PIXELS)
            tot = torch.zeros((c, fp[:, px].shape[1]))
            for kk in range(split * kps, min(k, (split + 1) * kps)):
                prod = torch.zeros_like(tot)
                for j in range(0, c, 64):
                    cols = slice(kk * cpad + j, kk * cpad + min(c, j + 64))
                    prod = prod + torch.matmul(a[:, cols], fp[j:j + 64, px])
                tot = tot + prod * mp[kk, px]
            part[:, px] = tot
        out = out + part
    return out.bfloat16()[:, :p]


def _jax_wbwd(f, m2, s):
    df = jgp._bwd_call(jnp.asarray(f.float().numpy().T, jnp.bfloat16),
                       jnp.asarray(m2.float().numpy().T, jnp.bfloat16),
                       jnp.asarray(s.float().numpy()), interpret=True)
    return np.asarray(df, np.float32).T


@pytest.mark.parametrize("c,p,k", [(37, 333, 1), (37, 333, 3), (100, 1000, 5),
                                   (64, 520, 3), (200, 300, 5), (130, 129, 1)])
def test_class_outer_fold_is_the_plain_versions(c, p, k):
    """The body's walk under its own plan, and under one split and under a
    split a class, equals gram_wbwd_plain bit for bit and the JAX
    package's Pallas backward within one bf16 ulp."""
    f, m2, s = _wbwd_operands(c, p, k, seed=c * k + p)
    ref = tgp.gram_wbwd_plain(f, m2, s)
    plan = tgp.wbwd_plan(c, tgs.pad_pixels(f).shape[1], k)
    for splits in sorted({plan[2], 1, k}):
        got = _class_outer(f, m2, s, plan[:2] + (splits,))
        assert torch.equal(got, ref), splits
    jx = _jax_wbwd(f, m2, s)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jx).max())) - 7)
    assert float(np.abs(ref.float().numpy() - jx).max()) <= ulp


def test_the_shapes_that_take_gram_wbwd():
    """At 4096² with K = 4 the "auto" route streams conv2_1 and conv3_1
    (past the fused bound) and keeps conv4_1 and conv5_1 fused; the pallas
    route takes every tap it is given."""
    taps = ((2048, 128), (1024, 256), (512, 512), (256, 512))
    stream = tuple((c, h * h) for h, c in taps
                   if tlosses.gram_route(h, h, 4, c, "auto") == "stream")
    assert stream == WBWD_TAPS["4096² stream taps"]
    assert all(tlosses.gram_route(int(p ** 0.5), int(p ** 0.5), 4, c,
                                  "pallas") == "pallas"
               for c, p in WBWD_TAPS["512² pallas route"])


def _wbwd_plan_walks_whole_classes(c, p, k):
    tile, groups, splits = tgp.wbwd_plan(c, p, k)
    ptiles = -(-p // tgp.WBWD_PIXELS)
    assert tile == (64 if c <= 64 else 128)
    assert 1 <= groups <= ptiles
    assert splits == 1 or groups == ptiles     # a block a p tile and split
    kps = -(-k // splits)
    classes = [list(range(i * kps, min(k, (i + 1) * kps)))
               for i in range(splits)]
    assert all(classes) and sum(classes, []) == list(range(k))
    return tile, groups, splits


@pytest.mark.parametrize("path,c,p", [(path, c, p)
                                      for path, taps in WBWD_TAPS.items()
                                      for c, p in taps])
def test_wbwd_plan_fills_card_with_whole_classes(path, c, p):
    """K = 4, as on the main paths: the grid fills at least 90 % of the
    SMs (one block each), conv5_1 at 512² by a split a class."""
    tile, groups, splits = _wbwd_plan_walks_whole_classes(c, p, 4)
    assert groups * -(-c // tile) * splits >= 0.9 * SMS


@pytest.mark.parametrize("c,p,k", [(64, 8192, 3), (37, 336, 5), (512, 16, 4),
                                   (200, 3000, 5), (512, 1024, 5),
                                   (512, 1024, 1), (512, 4096, 3)])
def test_wbwd_plan_of_short_grids_splits_whole_classes(c, p, k):
    """Where the p tiles × c tiles do not fill the SMs, the splits make
    the grid's waves × the classes a block walks least."""
    tile, groups, splits = _wbwd_plan_walks_whole_classes(c, p, k)
    blocks = -(-p // tgp.WBWD_PIXELS) * -(-c // tile)
    assert blocks < SMS
    waves = lambda n: -(-blocks * n // SMS) * -(-k // n)
    assert waves(splits) == min(waves(n) for n in range(1, k + 1))


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    f, m2, s = _wbwd_operands(600, 100, 3, seed=1)    # C past the kernel's 512
    z, b, m2r = _relu_operands(37, 333, 2, seed=2)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(tgp.gram_wbwd(f, m2, s), tgp.gram_wbwd_plain(f, m2, s))
    assert torch.equal(tg2.gram_relu_fwd(z, b, m2r),
                       tg2.gram_relu_fwd_plain(z, b, m2r))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError):                   # never falls back
        tgp.gram_wbwd(f.to("meta"), m2, s)
    with pytest.raises(ValueError):
        tg2.gram_relu_fwd(z.to("meta"), b, m2r)
