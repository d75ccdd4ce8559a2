"""The port's own copy of what it takes from optax 0.2.6: L-BFGS with its
zoom linesearch (`optax.lbfgs()`), in PyTorch."""
from .base import GradientTransformation, apply_updates
from .lbfgs import lbfgs, scale_by_lbfgs, value_and_grad_from_state
from .linesearch import scale_by_zoom_linesearch

__all__ = ["GradientTransformation", "apply_updates", "lbfgs",
           "scale_by_lbfgs", "scale_by_zoom_linesearch",
           "value_and_grad_from_state"]
