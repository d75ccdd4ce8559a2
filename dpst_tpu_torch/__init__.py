"""dpst_tpu_torch: the PyTorch/CUDA port of dpst_tpu (automated deep photo
style transfer), with hand-written CUDA kernels for an NVIDIA H100
(sm_90a).

`stylize` runs masked stylization (the config3 objective: content, masked
Gram style and matting-Laplacian terms) with Adam or L-BFGS (optax's
algorithm with its zoom linesearch, `optim/`), single-scale or coarse to
fine over `scales` (config4), with the Gram, conv and blocks-1-2 routes
that `StylizeConfig` selects, the smooth-local-affine post-process
(`post_smooth`), per-stage checkpoint/resume, profiling and NaN checks.
Without masks it builds them automatically (PSPNet-50 segmentation on the
device, ADE20K class merging on the host; `segmentation.py`). `autotune`
sweeps the style weight Γ and keeps the stylization that NIMA scores
highest; its candidates run as one batch. `stylize_batch` runs B pairs
as one batched loop (`parallel/batch.py`), each kernel launch covering
all of them. A device mesh (`parallel/mesh.py`, one process holding a
tensor per device) splits the pairs of `stylize_batch` and the
candidates of `autotune`; `parallel/spatial.stylize_spatial` shards one
image's rows over it with explicit halo exchanges, and
`laplacian_impl="spmd"` splits the Laplacian's rows over the ambient mesh
(`ops/laplacian_spmd.py`). Still missing: the CLI.
"""
from .api import prepare_constants, stylize
# the submodule is imported here, before the name is bound to the function:
# a later `import dpst_tpu_torch.autotune` finds it in sys.modules and
# leaves `dpst_tpu_torch.autotune` the function
from .autotune import autotune
from .config import PRESETS, StylizeConfig
from .parallel.batch import stylize_batch

__all__ = ["stylize", "prepare_constants", "stylize_batch", "autotune",
           "StylizeConfig", "PRESETS"]
