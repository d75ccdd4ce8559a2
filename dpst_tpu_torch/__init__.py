"""dpst_tpu_torch: the PyTorch/CUDA port of dpst_tpu (deep photo style
transfer), with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

`stylize` runs masked stylization (the config3 objective: content, masked
Gram style and matting-Laplacian terms) with Adam or L-BFGS (optax's
algorithm with its zoom linesearch, `optim/`), single-scale or coarse to
fine over `scales` (config4), with the Gram, conv and blocks-1-2 routes
that `StylizeConfig` selects, the smooth-local-affine post-process
(`post_smooth`), per-stage checkpoint/resume, profiling and NaN checks.
Still missing: automatic segmentation and the multi-GPU Laplacian (both
raise NotImplementedError), and `autotune`, `stylize_batch` and the CLI.
"""
from .api import prepare_constants, stylize
from .config import PRESETS, StylizeConfig

__all__ = ["stylize", "prepare_constants", "StylizeConfig", "PRESETS"]
