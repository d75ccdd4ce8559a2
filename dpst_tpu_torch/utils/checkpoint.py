"""Checkpoint and resume of the optimization loop.

The counterpart of `dpst_tpu/utils/checkpoint.py`, with `torch.save` in
place of orbax: at a step, CPU copies of the output image and of the whole
optimizer state (Adam's μ, ν and count; L-BFGS's memory ring, count,
params and updates, and its linesearch's stepsize, cached value and
gradient), one file a step, the newest `max_to_keep` kept. Restoring
every tensor of the state, the cached value and gradient among them, lets
a resumed run continue bit for bit where the saved one stopped.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _to_saved(tree):
    """Nested lists of CPU tensors and Python scalars (what `torch.load`
    with weights_only reads back)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (tuple, list)):
        return [_to_saved(x) for x in tree]
    if isinstance(tree, np.generic):
        return torch.from_numpy(np.asarray(tree))
    if isinstance(tree, (bool, int, float)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _from_saved(like, saved):
    """`saved` in the structure, types, dtypes and devices of `like`."""
    if isinstance(like, torch.Tensor):
        if tuple(saved.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint holds a {tuple(saved.shape)} "
                             f"tensor where {tuple(like.shape)} is expected")
        return saved.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (tuple, list)):
        if len(saved) != len(like):
            raise ValueError("checkpoint state does not match the "
                             "optimizer's")
        vals = [_from_saved(l, s) for l, s in zip(like, saved)]
        if hasattr(like, "_fields"):
            return type(like)(*vals)
        return type(like)(vals)
    if isinstance(like, np.generic):
        return type(like)(saved.numpy())
    return type(like)(saved)


class RunCheckpointer:
    """Save/restore (step, image, opt_state) under a directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self._dir))
                      if m)

    def save(self, step: int, image: torch.Tensor, opt_state) -> None:
        tree = {"image": image.detach().cpu(),
                "opt_state": _to_saved(opt_state)}
        tmp = self._path(step) + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self._path(step))
        for old in self._steps()[:-self._max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, image_like: torch.Tensor, opt_state_like
                ) -> tuple[int, torch.Tensor, object] | None:
        """The latest checkpoint as (step, image, opt_state), or None if
        there is none. `image_like` / `opt_state_like` (a fresh image and
        optimizer state) give the structure, dtypes and devices."""
        step = self.latest_step()
        if step is None:
            return None
        tree = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        image = _from_saved(image_like, tree["image"])
        return step, image, _from_saved(opt_state_like, tree["opt_state"])

    def close(self) -> None:
        """Nothing stays open between calls: each save is written and
        renamed into place before it returns."""
