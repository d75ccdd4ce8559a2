"""The reference of a configuration whose masks the program makes itself
from the photos (`"reference": "automatic"`; `PRESETS["config3"]` as
published, `use_segmentation` on): PSPNet-50 segments each photo
(`pspnet.labels`, the resize protocol), the two label maps are merged
(`merge.merge`) and made one-hot over `max_classes`, and the deep-photo
objective runs Adam on those masks (`objective.reference_run`).

PSPNet's weights are drawn by `pspnet.weights` from the configuration's
seed (its "stylize" "seed"), which is what the benchmark's entry hands the
program; the VGG weights are the run's, as for every configuration.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.inputs import Pair
from port_bench.reference import merge, objective, pspnet


def _settings(config: dict) -> dict:
    s = config["stylize"]
    for key, want in (("use_segmentation", True), ("seg_protocol", "resize"),
                      ("seg_scales", [1.0]), ("similarity_metric", "grouped")):
        if s[key] != want:
            raise ValueError(f"the automatic reference runs {key}={want!r}, "
                             f"not {s[key]!r}")
    return s


def masks(config: dict, seg_params: dict, content: np.ndarray,
          style: np.ndarray, prec, device
          ) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """(content masks, style masks (K, H, W) float32, merged class ids) of
    one pair under `config`, PSPNet at the precision `prec`."""
    s = _settings(config)
    size = config["pspnet"]["eval_size"]
    seg = [pspnet.labels(seg_params, torch.from_numpy(
        np.asarray(img, np.float32)).to(device), prec, size).cpu().numpy()
        for img in (content, style)]
    lab_c, lab_s, ids = merge.merge(*seg, s["similarity_threshold"],
                                    s["max_classes"])
    k = s["max_classes"]
    return merge.one_hot(lab_c, ids, k), merge.one_hot(lab_s, ids, k), ids


def reference_run(config: dict, params: dict, pairs, steps: int, prec,
                  rows: int, halo: int, device
                  ) -> tuple[np.ndarray, np.ndarray]:
    """`reference/__init__.py`'s contract, on pairs whose masks are left to
    the program: the masks made here, then the objective's Adam run."""
    if any(p.content_masks is not None for p in pairs):
        raise ValueError("the automatic reference makes its own masks; the "
                         "traffic handed some over")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seg_params = pspnet.weights(config["stylize"]["seed"], device)
    masked = [Pair(p.content, p.style,
                   *masks(config, seg_params, p.content, p.style, prec,
                          device)[:2]) for p in pairs]
    del seg_params
    return objective.reference_run(config, params, masked, steps, prec, rows,
                                   halo, device)
