"""How `correct` is decided: what the timed path produced in the window's
first request, up to its first stamp, against the plain reference run
afterwards to the same step on the same weights and pairs.

The reference is the module under `reference/` that the configuration
file names (`"reference"`; `objective`, the deep-photo objective under
Adam, where it names none). Its `reference_run(config, params, pairs,
steps, prec, rows, halo, device)` returns the history rows (B, steps, 5)
and the images (B, H, W, 3), both float64; it computes with TF32 off, at
the precision `prec`, and imports nothing of `dpst_tpu_torch`, `dpst_tpu`
or JAX (`reference/__init__.py` sets out the contract).

The request's history rows up to its first stamp are the loss terms at the
content image and at the images its first Adam steps made: they take in
the VGG taps, the masked Grams of every class, the content term and the
matting Laplacian. A row gap is one term's widest gap over the pairs and
the rows, as a share of that term's largest value in the pair's
reference rows:

    <term>_gap = max_pair max_row |program − reference| / max_row |reference|

The image at the first stamp holds every Adam update with its clip: its
change from the content image is compared pair by pair (a pair's image is
one leaf), by the gap of the norms and not the norm of the difference,
over the reference's norm of that pair or of the median pair, whichever
is larger:

    change_gap = max_pair |‖x − c‖ − ‖x_ref − c‖| / max(‖x_ref − c‖, median)

Each number has the limit that `checks/<cell>.json` gives it.
"""
from __future__ import annotations

import importlib
import math

import numpy as np

TERMS = {"total_gap": 0, "content_gap": 1, "style_gap": 2,
         "photoreal_gap": 3}
NUMBERS = (*TERMS, "change_gap")


def reference(config: dict, params: dict, pairs, steps: int, checks: dict,
              precision: str, device) -> tuple[np.ndarray, np.ndarray]:
    """(rows (B, steps, 5), images (B, H, W, 3)) of the configuration's
    reference at `precision` ("float32", or "fp8" for the control) on the
    pairs of a request, `steps` steps from each content image, walked in
    the blocks of rows that `checks` sets."""
    from port_bench.reference import precision as prec_mod
    prec = {"float32": prec_mod.PLAIN, "fp8": prec_mod.FP8}[precision]
    module = importlib.import_module(
        f"port_bench.reference.{config.get('reference', 'objective')}")
    return module.reference_run(config, params, pairs, steps, prec,
                                checks["block_rows"], checks["halo"], device)


def gaps(got, ref, contents: np.ndarray) -> dict:
    """{number: value} of `got` against `ref`, each (rows, images) as
    `reference` gives them, the images' change taken from `contents`
    (B, H, W, 3); every number is infinite where the program returned
    nothing, the wrong shapes, or a value that is not finite."""
    ref_rows, ref_images = ref
    if (got is None or got[0].shape != ref_rows.shape
            or got[1].shape != ref_images.shape
            or not all(np.isfinite(a).all() for a in got)):
        return {name: math.inf for name in NUMBERS}
    rows, images = got
    out = {}
    for name, j in TERMS.items():
        scale = np.maximum(np.abs(ref_rows[:, :, j]).max(axis=1), 1e-30)
        out[name] = float((np.abs(rows[:, :, j] - ref_rows[:, :, j])
                           .max(axis=1) / scale).max())
    b = len(contents)
    change = np.array([np.linalg.norm(images[i] - contents[i])
                       for i in range(b)])
    ref_change = np.array([np.linalg.norm(ref_images[i] - contents[i])
                           for i in range(b)])
    scale = np.maximum(np.maximum(ref_change, np.median(ref_change)), 1e-30)
    out["change_gap"] = float((np.abs(change - ref_change) / scale).max())
    return out


def compare(got, ref, contents: np.ndarray, checks: dict) -> dict:
    """{number: {"value", "limit"}} of the numbers that `checks` limits."""
    values = gaps(got, ref, contents)
    return {name: {"value": values[name], "limit": limit}
            for name, limit in checks["limits"].items()}


def correct(numbers: dict) -> bool:
    return all(math.isfinite(n["value"]) and n["value"] <= n["limit"]
               for n in numbers.values())


def report(numbers: dict) -> str:
    """The compared numbers beside their limits, one a line."""
    return "\n".join(f"check {name}: {n['value']!r} limit {n['limit']!r}"
                     for name, n in numbers.items())
