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
