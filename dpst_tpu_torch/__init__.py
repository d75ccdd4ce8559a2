"""dpst_tpu_torch: the PyTorch/CUDA port of dpst_tpu (deep photo style
transfer), with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

`stylize` runs masked stylization with Adam (the config3 objective:
content, masked Gram style and matting-Laplacian terms), single-scale or
coarse to fine over `scales` (config4), with the Gram, conv and
blocks-1-2 routes that `StylizeConfig` selects. The options that need
L-BFGS, post-smoothing, automatic segmentation, the multi-GPU Laplacian or
checkpointing raise NotImplementedError; `autotune`, `stylize_batch` and
the CLI are not ported yet.
"""
from .api import prepare_constants, stylize
from .config import PRESETS, StylizeConfig

__all__ = ["stylize", "prepare_constants", "StylizeConfig", "PRESETS"]
