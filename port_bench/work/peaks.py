"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates at the
700 W limit) and the roofline bound of a piece of work (a frozen copy of
`chip_smoke.py`'s `bound_ms`)."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM bandwidth and the operations over the peak rate of `dtype`."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])


def itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4
