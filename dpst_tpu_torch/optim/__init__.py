"""The port's own copy of what it takes from optax 0.2.6: L-BFGS with its
zoom linesearch (`optax.lbfgs()`), in PyTorch, over a tensor or the list
of an image's row shards, for one pair or a batch of pairs."""
from .base import (GradientTransformation, Vector, apply_updates,
                   first_device, first_vec, pair_vdot, tree_map, vdot)
from .lbfgs import lbfgs, scale_by_lbfgs, value_and_grad_from_state
from .linesearch import fetch, scale_by_zoom_linesearch

__all__ = ["GradientTransformation", "Vector", "apply_updates", "fetch",
           "first_device", "first_vec", "lbfgs", "pair_vdot",
           "scale_by_lbfgs", "scale_by_zoom_linesearch", "tree_map",
           "value_and_grad_from_state", "vdot"]
