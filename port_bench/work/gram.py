"""Operations and bytes of the masked Gram kernels (`gram_fwd`,
`gram_relu_fwd`; `gram_bwd`, `gram_wbwd`, `gram_relu_bwd`) at a tap of C
channels and P pixels with K classes, counted as `chip_smoke.py` counts
them: the forward reads F and the K masks and writes K fp32 Grams; a
backward reads F, the masks and the K cotangents and writes dF; each does
2·K·C²·P operations. The fused bias+ReLU pair reads the raw conv output in
F's place, the same count."""
from __future__ import annotations


def gram_fwd_work(c: int, p: int, k: int, isz: int) -> tuple[float, float]:
    return (c * p + k * p) * isz + k * c * c * 4, 2.0 * k * c * c * p


def gram_bwd_work(c: int, p: int, k: int, isz: int) -> tuple[float, float]:
    return (2 * c * p + k * p + k * c * c) * isz, 2.0 * k * c * c * p
