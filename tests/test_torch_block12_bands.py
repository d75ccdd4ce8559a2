"""The band height of the block12 walk (`ops/block12_pallas.band_rows`): the
height it picks from the image shape, the walk and scratch that follow, the
wrappers' record of it, and the plain versions' outputs at every height
against those at 32 rows, the TPU kernel's height.

The plain versions walk the bands the kernels walk (the wrappers hand them
the same height), so a band's own rows must not depend on the halo around
them: each pixel's sums keep their order whatever the height. The Gram sums
add the bands' partial sums in band order, so they may round apart by a few
fp32 ulps of their largest value; every per-pixel output is held within
1e-6 of its largest magnitude in fp32 (on this CPU they agree bit for
bit)."""
import numpy as np
import pytest
import torch

from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import block12_pallas as tb


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("h,w,want", [
    (4096, 4096, 256),     # config6: 2^20 own pixels a band, one a group
    (320, 4096, 64),       # the card's batch checks: 320 = 5 · 64
    (96, 256, 32),         # 96 divides by 32 alone
    (2048, 8192, 128),     # 256 rows of 8192 pass GROUP_PIXELS
    (256, 16384, 64),      # 128 and 256 rows of 16384 pass it
    (384, 4096, 128),
    (64, 260, 64),
    (32, 65536, 32),       # over GROUP_PIXELS even at 32: the fallback
])
def test_band_rows_picks_the_tallest_band_that_fits(h, w, want):
    assert tb.band_rows(h, w) == want
    taller = [r for r in tb.BAND_ROWS if r > want]
    assert all(h % r or r * w > tb.GROUP_PIXELS for r in taller)


def test_every_route_shape_gets_a_height_that_divides_it():
    """Every (H, W) the block12 route takes (H % 32 == 0, W % 256 == 0, up
    to 8192 × 16384): a height of BAND_ROWS that divides H, whose bands
    hold at most GROUP_PIXELS own pixels, or 32."""
    for h in range(32, 8192 + 1, 32):
        for w in range(256, 16384 + 1, 256):
            rows = tb.band_rows(h, w)
            assert rows in tb.BAND_ROWS and h % rows == 0, (h, w)
            assert rows * w <= tb.GROUP_PIXELS or rows == 32, (h, w)


def test_4096_walks_as_many_groups_on_a_smaller_scratch():
    """At config6's 4096² (K = 4, bf16): bands of 256 rows, one a group, so
    a pass still walks 16 groups (the launches a step stay), each stage on
    1.0625 of the own rows (1.5 at 32) and every scratch smaller: 0.71 →
    0.51 GB forward, 0.53 → 0.38 deep, 1.07 → 0.76 shallow."""
    h = w = 4096
    rows = tb.band_rows(h, w)
    assert (rows, tb.group_bands(h, w)) == (256, 1)
    assert tb.group_bands(h, w, 32) == 8
    assert len(tb.unit_groups(1, h, w)) == len(tb.unit_groups(1, h, w,
                                                             tb=32)) == 16
    assert (rows + 2 * tb.HALO) / rows == 1.0625
    for which in range(3):
        new = tb.scratch_bytes(which, 4, h, w, 1, "bfloat16")
        old = tb.scratch_bytes(which, 4, h, w, 8, "bfloat16", tb=32)
        assert new < 0.75 * old
    assert tb.scratch_bytes(2, 4, h, w, 1, "bfloat16") < 0.76e9


def test_dz_rows_keep_the_own_rows_and_one_row_each_side():
    for rows in tb.BAND_ROWS:
        assert tb.dz_rows("shallow", rows) == (tb.HALO - 1,
                                               tb.HALO + rows + 1)
        lo, hi = tb.dz_rows("deep", rows)
        assert (lo, hi - lo) == (tb.HALO // 2 - 1, rows // 2 + 2)


@pytest.fixture(scope="module")
def operands():
    """An fp32 pair at 256 × 64, K = 2, its weights and cotangents."""
    r = np.random.default_rng(5)
    h, w, k = 256, 64, 2

    def t(*shape, uniform=None):
        a = r.uniform(*uniform, shape) if uniform else r.normal(size=shape)
        return torch.from_numpy(a.astype(np.float32))

    x = t(3, h, w, uniform=(-120, 130))
    m1 = t(k, h, w, uniform=(0, 1)) ** 2
    m2 = t(k, h // 2, w // 2, uniform=(0, 1)) ** 2
    s1 = tb.symmetrize(t(k, 64, 64), "float32")
    s2 = tb.symmetrize(t(k, 128, 128), "float32")
    dp2 = t(128, h // 4, w // 4)
    wts = tb.pack_weights(tvgg.init_params(0), "float32")
    return x, m1, m2, s1, s2, dp2, wts


def _outputs(operands, rows, pooling):
    """(g1, g2, p2, a11, a21, a22, dp1, dx) of the plain versions in bands
    of `rows` rows."""
    x, m1, m2, s1, s2, dp2, wts = operands
    fwd = tb.block12_fwd_plain(x, m1, m2, wts, pooling, "float32", tb=rows)
    dp1 = tb.block12_bwd_deep_plain(fwd[4], fwd[5], dp2, m2, s2, wts,
                                    pooling, "float32", tb=rows)
    dx = tb.block12_bwd_shallow_plain(fwd[3], dp1, m1, s1, wts, pooling,
                                      "float32", tb=rows)
    return fwd + (dp1, dx)


@pytest.mark.parametrize("pooling", ["max", "avg"])
@pytest.mark.parametrize("rows", [64, 128, 256])
def test_plain_outputs_do_not_depend_on_the_band_height(operands, rows,
                                                        pooling):
    """Every output of the forward and both backwards in bands of 64, 128
    and 256 rows (4, 2 and 1 bands of the 256-row image) against bands of
    32 (8), fp32: within 1e-6 of the largest magnitude."""
    got = _outputs(operands, rows, pooling)
    ref = _outputs(operands, 32, pooling)
    names = ("g1", "g2", "p2", "a11", "a21", "a22", "dp1", "dx")
    for name, g, r in zip(names, got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        err = float((g - r).abs().max() / r.abs().max())
        assert err <= 1e-6, f"{name} at {rows} rows: {err}"


def test_wrappers_record_the_walk():
    """Each entry point records its band height and the rows each stage
    walks over the own rows, on the CPU route too."""
    wts = tb.pack_weights(tvgg.init_params(0), "float32")
    kw = dict(compute_dtype="float32")
    for h, w, rows in ((96, 64, 32), (64, 256, 64), (128, 64, 128)):
        x = torch.zeros((3, h, w))
        m1, m2 = torch.zeros((1, h, w)), torch.zeros((1, h // 2, w // 2))
        tb.last_band_rows = tb.last_rows_walked = None
        _, _, p2, a11, a21, a22 = tb.block12_fwd_res(x, m1, m2, wts, **kw)
        assert (tb.last_band_rows, tb.last_rows_walked) == (
            rows, (rows + 16) / rows)
        s1 = torch.zeros((1, 64, 64))
        s2 = torch.zeros((1, 128, 128))
        for call in (lambda: tb.block12_bwd_deep(a21, a22, p2, m2, s2, wts,
                                                 **kw),
                     lambda: tb.block12_bwd_shallow(
                         a11, torch.zeros((64, h // 2, w // 2)), m1, s1,
                         wts, **kw)):
            tb.last_band_rows = tb.last_rows_walked = None
            call()
            assert (tb.last_band_rows, tb.last_rows_walked) == (
                rows, (rows + 16) / rows)
    assert tb.last_rows_walked == 1.125
