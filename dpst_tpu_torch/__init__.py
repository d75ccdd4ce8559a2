"""dpst_tpu_torch: the PyTorch/CUDA port of dpst_tpu (deep photo style
transfer), with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

This slice runs single-scale masked stylization with Adam (the config3
objective: content, masked Gram style and matting-Laplacian terms).
"""
from .api import prepare_constants, stylize
from .config import PRESETS, StylizeConfig

__all__ = ["stylize", "prepare_constants", "StylizeConfig", "PRESETS"]
