"""What the bf16 Hopper bodies of `gram_relu_bwd` (csrc/gram_wgmma.cuh:
`gram_relu_bwd64_body` at C <= 64, `gram_wbwd_body` with its bias+ReLU steps
above) are handed, and the order in which they sum, checked on the CPU. The
kernels themselves run only on the card (chip_smoke.py holds them against
the plain version).

- A torch emulation of the bodies' walk on the wrapper's operands (z and m²
  padded to P % 8 == 0 with zero columns, the cotangent as `s_matrix(S)`):
  per p tile (of RELU_BWD_PIXELS on the C <= 64 body, of WBWD_PIXELS on
  `gram_wbwd`'s) and split of whole classes, each 64-channel chunk of z
  cooked where it lands (rows past C with b = 0), classes outer and the
  chunks inner, each class's complete product folded into the weighted sum
  by its mask in class order, relu′ taken from the raw z + b (exact ties at
  z = −b get ½), the split partials summed in split order and rounded
  once. Held to `gram_relu_bwd_plain` bit for bit, and to
  dpst_tpu/ops/gram_s2d.py's v2 and v1 backward kernels in interpret mode
  within one bf16 ulp of max|dz| (the tolerance of
  tests/test_torch_gram_weighted_plan.py's weighted-after backward).
- `relu_bwd_plan`: at the three conv1_1 shapes of the main paths it walks
  every p tile once and fills the H100's 132 SMs; above C = 64 it is
  `gram_wbwd`'s plan.
- The bf16 wrapper raises for C > 512 before it reaches the kernel.

Operands are exact (small integers, b in halves, masks in {0, ¼, ½, 1}):
every product and partial sum is exact in fp32, so the results agree bit
for bit whatever order the sums take."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpst_tpu.ops import gram_s2d as jg2
from dpst_tpu_torch.ops import gram_pallas as tgp
from dpst_tpu_torch.ops import gram_s2d as tg2
from dpst_tpu_torch.ops import gram_stream as tgs
from dpst_tpu_torch.ops import kernels

SMS = 132          # streaming multiprocessors of the H100
# (C, P) of conv1_1, the tap that takes gram_relu_bwd: on the 512² pallas
# route, at config4's 1024² stage and on the 4096² standard path
RELU_TAPS = ((64, 1 << 18), (64, 1 << 20), (64, 1 << 24))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(c, p, k, seed):
    """Raw tap z in −4 … 4, bias b in −2 … 2 by halves (integer b meets
    z = −b: exact zeros of z + b), exact masks, a symmetric integer
    cotangent."""
    r = np.random.default_rng(seed)
    z = torch.from_numpy(r.integers(-4, 5, (c, p)).astype(np.float32))
    b = torch.from_numpy(r.integers(-4, 5, (c,)).astype(np.float32) / 2)
    m2 = torch.from_numpy(r.choice([0.0, 0.25, 0.5, 1.0], (k, p)).astype(
        np.float32))
    s = torch.from_numpy(r.integers(-4, 5, (k, c, c)).astype(np.float32))
    return (z.bfloat16(), b.bfloat16(), m2.bfloat16(),
            (s + s.transpose(1, 2)).bfloat16())


def _relu_walk(z, b, m2, s, plan):
    """gram_relu_bwd's bf16 sums in the bodies' order on the operands the
    wrapper hands them."""
    _, _, splits = plan
    c, p = z.shape
    k = m2.shape[0]
    zp, mp = tgs.pad_pixels(z), tgs.pad_pixels(m2).float()
    a = tgs.s_matrix(s).float()
    cpad = a.shape[1] // k
    kps = -(-k // splits)
    rows = -(-c // 64) * 64           # the chunks' rows, past C zero-filled
    zr = torch.zeros((rows, zp.shape[1]), dtype=torch.bfloat16)
    zr[:c] = zp
    br = torch.zeros(rows)
    br[:c] = b.float()                # rows past C take b = 0
    x = zr.float() + br[:, None]      # z + b in fp32
    f = torch.clamp_min(x, 0).bfloat16().float()
    relu_grad = (x > 0).float() + 0.5 * (x == 0).float()
    own_body = c <= 64 and k <= tg2.RELU_BWD_MAX_K and splits == 1
    width = tg2.RELU_BWD_PIXELS if own_body else tgp.WBWD_PIXELS
    out = torch.zeros((c, zp.shape[1]))
    for split in range(splits):
        part = torch.zeros_like(out)
        for p0 in range(0, zp.shape[1], width):
            px = slice(p0, p0 + width)
            tot = torch.zeros((c, f[:, px].shape[1]))
            for kk in range(split * kps, min(k, (split + 1) * kps)):
                prod = torch.zeros_like(tot)
                for j in range(0, rows, 64):
                    cols = slice(kk * cpad + j, kk * cpad + min(cpad, j + 64))
                    prod = prod + torch.matmul(
                        a[:, cols], f[j:j + cols.stop - cols.start, px])
                tot = tot + prod * mp[kk, px]
            part[:, px] = tot * relu_grad[:c, px]
        out = out + part
    return out.bfloat16()[:, :p]


@pytest.mark.parametrize("c,p,k", [(64, 2304, 4), (64, 2301, 3),
                                   (37, 333, 2), (8, 40, 1), (96, 1000, 3),
                                   (200, 300, 5), (64, 520, 9)])
def test_relu_walk_is_the_plain_version(c, p, k):
    """The walk under the plan, under one split and under a split a class,
    equals gram_relu_bwd_plain bit for bit; the operands hold exact ties
    z = −b, and the padded pixels cook to relu(b) under zero masks."""
    z, b, m2, s = _operands(c, p, k, seed=c * k + p)
    assert int(((z.float() + b.float()[:, None]) == 0).sum()) > 0
    ref = tg2.gram_relu_bwd_plain(z, b, m2, s)
    plan = tg2.relu_bwd_plan(c, tgs.pad_pixels(z).shape[1], k)
    for splits in sorted({plan[2], 1, k}):
        got = _relu_walk(z, b, m2, s, plan[:2] + (splits,))
        assert torch.equal(got, ref), splits


def _jax_s2d_bwd(z, b, m2, s, v2):
    """dz by dpst_tpu/ops/gram_s2d.py's backward kernels (interpret mode off
    the TPU) through their VJP: (C, P) becomes the s2d operand (P/4, 4C),
    pixel 4q + par at row q, lane group par; m² the lane stack par·K + j;
    the cotangent dG_j = S_j / 2 on every parity's diagonal block, which
    the kernels symmetrize to S_j."""
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
    half = s.float().numpy() / 2
    if v2:
        fn = lambda x: jg2._gram_s2d2_raw(
            x, bias8, m2t, jg2._e2h_const(k, c, jnp.bfloat16), k, c)
        dg = np.zeros((2, k, 2 * c, 2 * c), np.float32)
        for g in range(2):
            dg[:, :, g * c:(g + 1) * c, g * c:(g + 1) * c] = half[None]
        dg = dg.reshape(2 * k * 128, 128)
    else:
        fn = lambda x: jg2._gram_s2d_raw(
            x, bias8, m2t, jg2._e2_const(k, c, jnp.bfloat16), k, c)
        dg = np.zeros((k, 4 * c, 4 * c), np.float32)
        for par in range(4):
            dg[:, par * c:(par + 1) * c, par * c:(par + 1) * c] = half
    _, vjp = jax.vjp(fn, zp)
    (df,) = vjp(jnp.asarray(dg))
    df = np.asarray(df, np.float32).reshape(q, 4, c)
    return df.transpose(2, 0, 1).reshape(c, p)


@pytest.mark.parametrize("v2", [True, False], ids=["v2", "v1"])
@pytest.mark.parametrize("k", [1, 4])
def test_relu_walk_matches_the_jax_s2d_kernels(k, v2):
    """C = 64 (the TPU kernels' width), a 48 × 48 tap."""
    c, p = 64, 48 * 48
    z, b, m2, s = _operands(c, p, k, seed=k + 10 * v2)
    got = _relu_walk(z, b, m2, s, tg2.relu_bwd_plan(c, p, k))
    jx = _jax_s2d_bwd(z, b, m2, s, v2)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jx).max())) - 7)
    assert float(np.abs(got.float().numpy() - jx).max()) <= ulp


@pytest.mark.parametrize("c,p", RELU_TAPS)
def test_plan_walks_each_tile_once_and_fills_the_card(c, p):
    tile, groups, splits = tg2.relu_bwd_plan(c, p, 4)
    ptiles = -(-p // tg2.RELU_BWD_PIXELS)
    assert (tile, splits) == (64, 1) and groups == SMS
    walked = sorted(t for g in range(groups)
                    for t in range(g, ptiles, groups))
    assert walked == list(range(ptiles))


@pytest.mark.parametrize("c,p,k", [(64, 256, 4), (37, 1001, 8),
                                   (64, 8192, 9), (96, 8192, 4),
                                   (512, 4096, 4), (256, 1 << 20, 4)])
def test_plan_takes_wbwd_plan_past_the_resident_body(c, p, k):
    plan = tg2.relu_bwd_plan(c, p, k)
    if c <= 64 and k <= tg2.RELU_BWD_MAX_K:
        assert plan == (64, min(-(-p // tg2.RELU_BWD_PIXELS), SMS), 1)
    else:
        assert plan == tgp.wbwd_plan(c, p, k)


def test_bf16_wrapper_raises_past_512_channels(monkeypatch):
    """Tensors taken as on the card: the bf16 wrapper refuses C > 512 (the
    F chunks of gram_wbwd's body fit shared memory up to there) before it
    reaches the kernel library; fp32 is not refused."""
    z, b, m2, s = _operands(520, 16, 1, seed=5)
    monkeypatch.setattr(kernels, "on_cuda", lambda *t: True)

    def no_library():
        raise AssertionError("reached the kernel library")

    monkeypatch.setattr(kernels, "library", no_library)
    with pytest.raises(ValueError, match="C <= 512"):
        tg2.gram_relu_bwd(z, b, m2, s)
    with pytest.raises(AssertionError, match="kernel library"):
        tg2.gram_relu_bwd(z.float(), b.float(), m2.float(), s.float())


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    z, b, m2, s = _operands(600, 40, 2, seed=6)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(tg2.gram_relu_bwd(z, b, m2, s),
                       tg2.gram_relu_bwd_plain(z, b, m2, s))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("b", [2, 8])
@pytest.mark.parametrize("c,p", RELU_TAPS)
def test_batched_plan_shares_the_sms_among_the_pairs(b, c, p):
    """B pairs: `groups` blocks a pair, at most one an SM in all, and every
    p tile of every pair walked once by its pair's blocks (the grid's y
    index is the pair)."""
    tile, groups, splits = tg2.relu_bwd_plan(c, p, 4, b)
    ptiles = -(-p // tg2.RELU_BWD_PIXELS)
    assert (tile, splits) == (64, 1)
    assert groups * b <= SMS and groups == min(ptiles, SMS // b)
    for pair in range(b):
        walked = sorted(t for g in range(groups)
                        for t in range(g, ptiles, groups))
        assert walked == list(range(ptiles)), pair


@pytest.mark.parametrize("c,p,k", [(64, 2301, 3), (96, 1000, 3),
                                   (64, 520, 9)])
def test_batched_relu_walk_is_the_plain_version(c, p, k):
    """The walk of each pair of a batch (its operands at the pair's offsets,
    under the batched plan) equals the batched plain version bit for
    bit."""
    parts = [_operands(c, p, k, seed=c * k + p + i) for i in range(3)]
    z = torch.stack([q[0] for q in parts])
    b = parts[0][1]
    m2 = torch.stack([q[2] for q in parts])
    s = torch.stack([q[3] for q in parts])
    ref = tg2.gram_relu_bwd_plain(z, b, m2, s)
    plan = tg2.relu_bwd_plan(c, tgs.pad_pixels(z).shape[-1], k, 3)
    got = torch.stack([_relu_walk(z[i], b, m2[i], s[i], plan)
                       for i in range(3)])
    assert torch.equal(got, ref)


def test_batched_wbwd_plan_counts_the_pairs():
    """Past the resident body the plan is gram_wbwd's for B pairs: the
    class splits one pair takes (each pair's dF then rounds as alone);
    with one split the SMs shared among the pairs' c tiles, else every p
    tile of every pair its block."""
    for c, p, k in ((128, 4096, 4), (256, 1 << 14, 4), (512, 4096, 4),
                    (512, 1024, 4)):
        one, eight = tgp.wbwd_plan(c, p, k), tgp.wbwd_plan(c, p, k, 8)
        assert tg2.relu_bwd_plan(c, p, k, 8) == eight
        assert eight[0] == one[0] and eight[2] == one[2]
        ctiles, ptiles = -(-c // eight[0]), -(-p // tgp.WBWD_PIXELS)
        if one[2] == 1:
            assert eight[1] == min(ptiles, max(1, SMS // (ctiles * 8)))
        else:
            assert eight[1] == ptiles
