"""Every batched kernel plan splits a pair's reductions as one pair's plan
does: `gram_stream.fwd_plan` (P of `gram_fwd` and `gram_relu_fwd`),
`bwd_plan` (the (k, c') items of `gram_bwd`), `gram_pallas.wbwd_plan` and
`gram_s2d.relu_bwd_plan` (the classes of `gram_wbwd` and `gram_relu_bwd`)
and `conv_cuda.conv_plan` (Cin of the batched `conv3x3`), at B = 2 and 8,
at the taps and convs of a 512², 1024² and 4096² VGG. B may change only
what cuts independent outputs: the backwards' blocks over p tiles.

Then the kernels' batched grids, emulated in torch on random bf16
operands (`tests/test_torch_gram_plan.py`'s and `test_torch_conv_plan.py`'s
emulators: pair offsets, grid order, split partials and their fixed-order
reductions), under the batch's plan equal B one-pair emulations under one
pair's plan bit for bit: each pair's sums round in a batch as they do
alone. On random operands a split of another length rounds apart, so a
plan that split a batch's pairs otherwise would show."""
import numpy as np
import pytest
import torch

import chip_smoke
from dpst_tpu_torch.ops import conv_cuda as tconv
from dpst_tpu_torch.ops import gram_pallas as tgp
from dpst_tpu_torch.ops import gram_s2d as tg2
from dpst_tpu_torch.ops import gram_stream as tgs
from test_torch_conv_plan import _conv_emulated
from test_torch_gram_plan import (TAPS, _bwd_emulated, _fwd_emulated,
                                  _wbwd_emulated)

BATCHES = (2, 8)
TAP_CASES = [(size, c, p) for size, taps in TAPS.items() for c, p in taps]
# (Cin, Cout, H·W side) of VGG-19's 3×3 convs at a side of 512 (forward),
# and their input gradients, at 512², 1024² and 4096²
CONV_CASES = sorted({(cin, cout, hw * side // 512)
                     for side in (512, 1024, 4096)
                     for a, b, hw in chip_smoke.CONV_SHAPES
                     for cin, cout in ((a, b), (b, a))})


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("size,c,p", TAP_CASES)
def test_gram_plans_split_each_pair_as_one_pair(b, k, size, c, p):
    """The forward's (splits, chunk) is one pair's; each backward keeps one
    pair's c tile and splits, and with one split its `groups` still cover
    a pair's p tiles (at least one block each, at most one a p tile)."""
    assert tgs.fwd_plan(c, p, k, b) == tgs.fwd_plan(c, p, k)
    for plan, pixels in ((tgs.bwd_plan, 64), (tgp.wbwd_plan, tgp.WBWD_PIXELS),
                         (tg2.relu_bwd_plan, None)):
        tile, groups, splits = plan(c, p, k, b)
        one = plan(c, p, k)
        assert (tile, splits) == (one[0], one[2]), plan.__name__
        if pixels is None:   # relu_bwd_plan: its own body or wbwd_plan's
            pixels = (tg2.RELU_BWD_PIXELS
                      if c <= 64 and k <= tg2.RELU_BWD_MAX_K
                      else tgp.WBWD_PIXELS)
        assert 1 <= groups <= -(-p // pixels), plan.__name__


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("cin,cout,hw", CONV_CASES)
def test_conv_plan_splits_each_image_as_one_image(b, cin, cout, hw):
    assert tconv.conv_plan(cin, cout, hw, hw, b) == tconv.conv_plan(
        cin, cout, hw, hw)


def _random(shape, seed):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.normal(size=shape).astype(np.float32)
                            ).bfloat16()


def _pairs(b, c, p, k, seed):
    """b pairs of a random tap (B, C, P), m² (B, K, P) and a symmetric
    cotangent (B, K, C, C), bf16, P padded as the wrappers pad it."""
    f = _random((b, c, p), seed)
    m2 = (_random((b, k, p), seed + 1).float() ** 2).bfloat16()
    s = _random((b, k, c, c), seed + 2).float()
    s = (s + s.transpose(-1, -2)).bfloat16()
    return tgs.pad_pixels(f), tgs.pad_pixels(m2), s


# (B, C, P, K): shapes at which the plans before this rule gave a batch
# fewer splits than one pair (forward, backward and weighted backward)
EMULATED = [(8, 128, 1 << 12, 4), (8, 256, 1 << 10, 4), (2, 64, 1 << 12, 4)]


@pytest.mark.parametrize("b,c,p,k", EMULATED)
def test_batched_grams_equal_one_pair_emulations(b, c, p, k):
    f, m2, s = _pairs(b, c, p, k, seed=c + k)
    pp = f.shape[-1]
    got = _fwd_emulated(f, m2, *tgs.fwd_plan(c, pp, k, b))
    one = tgs.fwd_plan(c, pp, k)
    for i in range(b):
        assert torch.equal(got[i], _fwd_emulated(f[i:i + 1], m2[i:i + 1],
                                                 *one)[0]), f"fwd pair {i}"
    tile, _, splits = tgs.bwd_plan(c, pp, k, b)
    got = _bwd_emulated(f, m2, s, tile, splits)
    one = tgs.bwd_plan(c, pp, k)
    for i in range(b):
        assert torch.equal(got[i], _bwd_emulated(
            f[i:i + 1], m2[i:i + 1], s[i:i + 1], one[0], one[2])[0]), (
            f"bwd pair {i}")
    tile, groups, splits = tgp.wbwd_plan(c, pp, k, b)
    got = _wbwd_emulated(f, m2, s, tile, groups, splits)
    one = tgp.wbwd_plan(c, pp, k)
    for i in range(b):
        assert torch.equal(got[i], _wbwd_emulated(
            f[i:i + 1], m2[i:i + 1], s[i:i + 1], *one)[0]), f"wbwd pair {i}"


@pytest.mark.parametrize("b,cin,cout,hw", [(2, 512, 512, 32),
                                           (8, 256, 256, 32)])
def test_batched_conv_equals_one_image_emulations(b, cin, cout, hw):
    x = _random((b, cin, hw, hw), seed=cin + hw)
    wp = tconv.pack_weights(_random((cout, cin, 3, 3), seed=cout) * 0.05)
    _, splits, cps = tconv.conv_plan(cin, cout, hw, hw, b)
    got = _conv_emulated(x, wp, splits, cps)
    _, splits, cps = tconv.conv_plan(cin, cout, hw, hw)
    for i in range(b):
        assert torch.equal(got[i], _conv_emulated(x[i:i + 1], wp, splits,
                                                  cps)[0]), f"image {i}"
