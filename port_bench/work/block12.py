"""Operations and bytes each block12 entry point must move and do at an
H × W image with K classes (a frozen copy of `chip_smoke.py`'s
`b12_work`): inputs read once, outputs written once; the convs at their
real channel counts over the image (no halo), the Grams and Gram
cotangents, no recompute beyond what the function is."""
from __future__ import annotations


def b12_work(h: int, w: int, k: int, isz: int) -> dict:
    p, p2 = h * w, h * w // 4
    conv = lambda cin, cout, n: 2.0 * 9 * cin * cout * n
    fwd_ops = (conv(3, 64, p) + conv(64, 64, p) + conv(64, 128, p2)
               + conv(128, 128, p2) + 2.0 * k * (64 * 64 * p
                                                 + 128 * 128 * p2))
    fwd_bytes = (3 * p * 4 + k * (p + p2) * 4 + k * (64 * 64 + 128 * 128) * 4
                 + 128 * p // 16 * isz)
    res_bytes = (64 * p + 2 * 128 * p2) * isz
    deep_ops = conv(128, 128, p2) + conv(64, 128, p2) + 2.0 * k * 128 * 128 * p2
    deep_bytes = ((2 * 128 * p2 + 128 * p // 16 + 64 * p2) * isz
                  + k * p2 * 4 + k * 128 * 128 * isz)
    shallow_ops = (2 * conv(64, 64, p) + conv(3, 64, p)
                   + 2.0 * k * 64 * 64 * p)
    shallow_bytes = ((64 * p + 64 * p2) * isz + k * p * 4 + 3 * p * 4
                     + k * 64 * 64 * isz)
    return {"block12_fwd": (fwd_bytes, fwd_ops),
            "block12_fwd_res": (fwd_bytes + res_bytes, fwd_ops),
            "block12_bwd_deep": (deep_bytes, deep_ops),
            "block12_bwd_shallow": (shallow_bytes, shallow_ops)}
