"""The strip walk of the `lap_matvec` CUDA kernel (csrc/lap_matvec.cu),
emulated in torch on the CPU, and its plan. The kernel runs only on the
card (chip_smoke.py holds it against the plain version there); this file
checks the order in which it sums and the edges of its strips.

The emulation does what a warp does: it owns LAP_COLS output columns (its
32 lanes hold columns x0 - 1 … x0 + 30) and `rows` output rows, walks down
them a row a step from x0's halo, forms each new row's horizontal sums of v
and I_m·v along the row as `_box3` does, (x[j] + x[j+1]) + x[j−1], with zeros
outside the image, carries the last three rows' sums and adds them in
`_box3`'s column order, (c[i−1] + c[i]) + c[i+1]; pass 1 runs one row above
the newest row, pass 2 one row above that, from the carried row sums of
α and β, whose neighbours come from the adjacent lanes.

- Against `laplacian.matvec` (the plain version): bit for bit, for H and W
  not multiples of the strip, an image of a single row, of a single column,
  narrower than a strip, and strips of 1, 2, 5 and 16 rows besides the
  plan's.
- Against dpst_tpu/ops/laplacian_pallas.py in interpret mode: relative error
  ≤ 1e-5 of max|y|, the tolerance of tests/test_torch_laplacian.py (the
  sides sum the box windows in different orders, and Λ ≈ 1e6 amplifies the
  roundoff of the cancelling terms t = q − μ·s).
- The plan: every row of every strip walked once; at 512², 1024² and 4096²
  one wave of resident blocks with two or more on nearly every SM, at the
  least cost of its model."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpst_tpu.ops import laplacian as jlap
from dpst_tpu.ops import laplacian_pallas as jlap_pallas
from dpst_tpu_torch.ops import laplacian as tlap
from dpst_tpu_torch.ops import laplacian_cuda as tlapc

EPS = 1e-5
REL = 1e-5
SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(h, w, seed):
    r = np.random.default_rng(seed)
    img = torch.from_numpy(r.uniform(0, 1, (h, w, 3)).astype(np.float32))
    packed = tlapc.pack_stats(tlap.precompute_stats(img, eps=EPS))
    v3 = torch.from_numpy(r.normal(size=(3, h, w)).astype(np.float32))
    return img, packed, v3


def _hsum(left, here, right):
    return (here + right) + left


def _vsum(above, here, below):
    return (above + here) + below


def _strip_walk(packed, v3, rows):
    """y (3, H, W) by the kernel's walk: every strip at once, lanes on the
    last axis, a Python step per row of each band of `rows` rows."""
    _, h, w = packed.shape
    strips = -(-w // tlapc.LAP_COLS)
    j = (torch.arange(strips)[:, None] * tlapc.LAP_COLS - 1
         + torch.arange(32)[None, :])                       # (S, 32)
    jin = (j >= 0) & (j < w)
    planes = torch.cat([v3, packed])  # v×3, img×3, μ×3, Λ×6, valid, n
    zero = torch.zeros(())

    def at(r, cols):
        """The 17 planes at row r and columns cols, zero outside."""
        ok = (cols >= 0) & (cols < w) & (0 <= r < h)
        return torch.where(ok, planes[:, min(max(r, 0), h - 1)]
                           [:, cols.clamp(0, w - 1)], zero)

    def rowsums1(r):
        """Row r's sums along the row: v per channel, then I_m·v."""
        lft, mid, rgt = at(r, j - 1), at(r, j), at(r, j + 1)
        hv = [_hsum(lft[ch], mid[ch], rgt[ch]) for ch in range(3)]
        hp = [_hsum(lft[3 + m] * lft[ch], mid[3 + m] * mid[ch],
                    rgt[3 + m] * rgt[ch])
              for ch in range(3) for m in range(3)]
        return torch.stack(hv + hp)                          # (12, S, 32)

    def lanes(x, d):
        """x of lane l − d (d = 1) or l + 1 (d = −1); the end lanes keep
        their own (they own no output)."""
        out = x.clone()
        if d == 1:
            out[..., 1:] = x[..., :-1]
        else:
            out[..., :-1] = x[..., 1:]
        return out

    sym = ((0, 1, 2), (1, 3, 4), (2, 4, 5))
    owner = (torch.arange(32) >= 1) & (torch.arange(32) <= tlapc.LAP_COLS)
    owner = owner[None, :] & (j < w)
    y = torch.full((3, h, w), float("nan"))
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        h1 = [rowsums1(r0 - 2), rowsums1(r0 - 1)]
        h2 = [torch.zeros(12, strips, 32), torch.zeros(12, strips, 32)]
        for big_r in range(r0 - 1, r1 + 1):
            hn = rowsums1(big_r + 1)
            ab = torch.zeros(12, strips, 32)
            if 0 <= big_r < h:
                box = _vsum(h1[0], h1[1], hn)
                st = at(big_r, j)
                mu, lam, valid = st[6:9], st[9:15], st[15]
                for ch in range(3):
                    s = box[ch]
                    t = [box[3 + 3 * ch + m] - mu[m] * s for m in range(3)]
                    b = [(lam[sym[m][0]] * t[0] + lam[sym[m][1]] * t[1])
                         + lam[sym[m][2]] * t[2] for m in range(3)]
                    mub = (mu[0] * b[0] + mu[1] * b[1]) + mu[2] * b[2]
                    ab[ch] = torch.where(jin, ((mub - s) / 9.0) * valid,
                                         zero)
                    for m in range(3):
                        ab[3 + 3 * ch + m] = torch.where(
                            jin, ((-b[m]) / 9.0) * valid, zero)
            hab = _hsum(lanes(ab, 1), ab, lanes(ab, -1))
            if r0 <= big_r - 1 < r1:
                box2 = _vsum(h2[0], h2[1], hab)
                own = at(big_r - 1, j)
                for ch in range(3):
                    ib = [own[3 + m] * box2[3 + 3 * ch + m] for m in range(3)]
                    out = ((own[16] * own[ch] + box2[ch])
                           + ((ib[0] + ib[1]) + ib[2]))
                    y[ch, big_r - 1, j[owner]] = out[owner]
            h1 = [h1[1], hn]
            h2 = [h2[1], hab]
    return y


@pytest.mark.parametrize("h,w", [(37, 53), (64, 61), (1, 40), (37, 1),
                                 (9, 17), (2, 95)],
                         ids=["37x53", "64x61", "one-row", "one-column",
                              "narrower-than-a-strip", "two-rows"])
def test_strip_walk_is_the_plain_matvec(h, w):
    """The walk under the plan's strip height and under strips of 1, 2, 5
    and 16 rows equals the plain version bit for bit (no NaN left: every
    pixel written once)."""
    _, packed, v3 = _operands(h, w, seed=h * 100 + w)
    ref = tlapc.lap_matvec_plain(packed, v3)
    for rows in sorted({tlapc.lap_plan(h, w), 1, 2, 5, 16}):
        got = _strip_walk(packed, v3, rows)
        assert not torch.isnan(got).any(), rows
        assert torch.equal(got, ref), rows


def test_strip_walk_matches_the_jax_pallas_kernel():
    img, packed, v3 = _operands(20, 37, seed=3)
    js = jlap.precompute_stats(jnp.asarray(img.numpy()), eps=EPS)
    ref = np.asarray(jlap_pallas.matvec_pallas(
        js, jnp.asarray(v3.permute(1, 2, 0).numpy())))
    got = _strip_walk(packed, v3, 7).permute(1, 2, 0).numpy()
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= REL * scale


@pytest.mark.parametrize("size", [512, 1024, 4096])
def test_plan_walks_every_row_once_and_fills_the_card(size):
    """At the main paths' sizes: one wave of resident blocks (four an SM),
    two or more on nearly every SM."""
    rows = tlapc.lap_plan(size, size)
    bands = [(r0, min(size, r0 + rows)) for r0 in range(0, size, rows)]
    assert bands[-1][1] == size and all(b > a for a, b in bands)
    bx = -(-(-(-size // tlapc.LAP_COLS)) // tlapc.LAP_WARPS)
    blocks = bx * len(bands)
    assert 0.95 * 2 * SMS <= blocks <= tlapc.LAP_SLOTS == 4 * SMS


def test_plan_takes_the_least_costly_height():
    """At 1024² the plan takes the least of the cost it models, blocks on
    the busiest SM × (rows + 4), among the heights that keep two blocks on
    nearly every SM."""
    h = w = 1024
    bx = -(-(-(-w // tlapc.LAP_COLS)) // tlapc.LAP_WARPS)
    cost = lambda r: -(-(bx * -(-h // r)) // SMS) * (r + 4)
    rows = tlapc.lap_plan(h, w)
    assert all(cost(rows) <= cost(r) for r in range(1, h + 1)
               if bx * -(-h // r) >= 0.95 * 2 * SMS)


@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (300, 200), (4096, 30),
                                 (30, 4096)])
def test_plan_rows_cover_any_image(h, w):
    rows = tlapc.lap_plan(h, w)
    assert 1 <= rows <= h
    assert -(-h // rows) * rows >= h > (-(-h // rows) - 1) * rows


@pytest.mark.parametrize("b", [2, 4, 8])
@pytest.mark.parametrize("size", [512, 1024])
def test_batched_plan_walks_every_row_and_fills_the_card(b, size):
    """B pairs (the grid's third index): every row of every pair's strips
    walked once, two or more blocks on nearly every SM in all, strips no
    shorter than one pair's (fewer halo rows), the least cost of the
    plan's model, and at the batch path's 512² one wave of resident
    blocks."""
    rows = tlapc.lap_plan(size, size, b)
    assert rows >= tlapc.lap_plan(size, size)
    bands = -(-size // rows)
    assert (bands - 1) * rows < size <= bands * rows
    bx = b * -(-(-(-size // tlapc.LAP_COLS)) // tlapc.LAP_WARPS)
    assert 0.95 * 2 * SMS <= bx * bands
    if size == 512:
        assert bx * bands <= tlapc.LAP_SLOTS
    cost = lambda r: -(-(bx * -(-size // r)) // SMS) * (r + 4)
    assert all(cost(rows) <= cost(r) for r in range(1, size + 1)
               if bx * -(-size // r) >= 0.95 * 2 * SMS)


def test_batched_strip_walk_reads_each_pairs_stats():
    """The walk of each pair at its offsets in a (B, 14, H, W) stack and
    in one stack shared with stride 0 equals the batched plain version bit
    for bit."""
    ops = [_operands(21, 40, seed=30 + i) for i in range(3)]
    packed = torch.stack([o[1] for o in ops])
    v3 = torch.stack([o[2] for o in ops])
    rows = tlapc.lap_plan(21, 40, 3)
    flat = packed.reshape(-1)
    for spair, stats in ((14 * 21 * 40, packed),
                         (0, packed[:1].expand(3, -1, -1, -1))):
        got = torch.stack([_strip_walk(
            flat[i * spair:i * spair + 14 * 21 * 40].reshape(14, 21, 40),
            v3[i], rows) for i in range(3)])
        assert torch.equal(got, tlapc.lap_matvec_plain(stats, v3))
