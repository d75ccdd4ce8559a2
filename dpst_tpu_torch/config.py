"""Configuration of one stylization run (PyTorch/CUDA port).

The same frozen dataclass as the JAX package's `StylizeConfig`: the same
field names, defaults and validation, so a config written for one package
means the same run in the other.

`s2d_gram` and `block1_impl` select the route of the block-1 style taps
in the optimization loop, as they select the JAX package's TPU kernels
(`optimize.fused_block1_taps`): where the TPU would feed them to its
space-to-depth Gram kernel (`s2d_gram` "pallas", "pallas1" or "pallas2",
or "auto" from 2^19 pixels; `block1_impl` not "conv", and "auto" only
from 2^18 pixels), the port feeds the raw conv output and bias to its
fused bias+ReLU Gram kernels (`ops/gram_s2d.py`); otherwise ("nd",
"conv", a content tap at block 1, an odd size) the ReLU runs first and
the masked-Gram kernels take the tap. `gram_impl`, `s2b_strips` and
`strip_gram` take part in that decision as they do on the TPU. The
precompute always takes the unfused route.

`conv_impl="pallas"` runs every conv but conv1_1 (Cin ≥ 8) and its input
gradient on the port's 3×3 conv kernel (`conv3x3`, `ops/conv_cuda.py`)
in the loop and in the precompute; every other value runs cuDNN.
`gram_impl` resolves per layer as on the TPU (`ops/losses.gram_route`):
"pallas", "stream" and "hybrid", and "auto" past 2^29 elements of the
weighted block, take the Gram backward that weights by m² after the
product (`gram_wbwd`, `ops/gram_pallas.py`); the fused route keeps
`gram_bwd`. The style image's Grams stay on the fused route.

`stream12` and `stream12_impl` route blocks 1-2 as on the TPU
(`optimize.block12_route`). They stream where `stream12` resolves to
strips (-1: above 3072² pixels, h // 128 strips, or h // 64; N: N strips)
that `models/vgg.stream12_compatible` takes (strips of a height that is a
multiple of 4 and at least 32, w % 4 == 0, a tap past pool2) and every
block-1/2 tap is a style tap and no content tap. Then, with
`stream12_impl="pallas"`, block-1/2 taps exactly (conv1_1, conv2_1),
w % 256 == 0 and h % 32 == 0, blocks 1-2 run on the block12 kernels
(`ops/block12_pallas.py`): bands of up to 256 rows (`band_rows`, from the
image shape), the Gram sums of conv1_1 and conv2_1 and pool2, no block-1/2
activation at full resolution but three residuals; the tail (`vgg.extract_tail`) goes on from pool2. Otherwise
(`stream12_impl="scan"`, or a gate fails) the port keeps its standard path:
the TPU's strip scan is a memory lowering it does not carry. But the
block-1/2 style taps then take the fused Gram route (`gram_fwd`,
`gram_bwd`, m² applied before the product) whatever `gram_impl` says, as
the scan forms its per-strip Grams, and no block-1 tap takes the fused
bias+ReLU kernels. config6 of the JAX package's bench.py is PRESETS
["config3"] with `stream12_impl="pallas"` at 4096²: 32 strips, the kernels.

`laplacian_impl="spmd"` sends the photorealism term's matvec through
`ops/laplacian_spmd.matvec_spmd`: rows split over the ambient mesh
(`parallel.mesh.use_mesh`), a 2-row halo exchange and `lap_matvec` on
every shard; without an ambient mesh it raises ValueError, as the JAX
package does. `spmd_safe` resolves a config for the row-sharded and
multi-device entry points (`parallel/spatial.py`, `parallel/batch.py`)
as the JAX package's does.

The other fields that select a TPU lowering of the same math are
accepted and are no-ops here: `stream12_remat`, `stream12_conv2`,
`remat`, `pool_impl` and `laplacian_impl` other than "spmd". The port
always runs the masked-Gram kernels, the tie-splitting max-pool backward
kernel and the Laplacian matvec kernel on CUDA tensors, and their plain
PyTorch versions on CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class StylizeConfig:
    """All knobs for one stylization run.

    total loss = content_weight * L_content
               + style_weight   * L_style
               + regularization_weight * L_photoreal
               + tv_weight * L_tv
    """

    # --- loss weights -----------------------------------------------------
    content_weight: float = 1.0
    style_weight: float = 100.0
    regularization_weight: float = 1e4   # λ on the matting-Laplacian term
    tv_weight: float = 0.0

    # --- optimization -----------------------------------------------------
    iterations: int = 500
    optimizer: str = "adam"              # "adam" | "lbfgs"
    learning_rate: float = 2.0           # Adam on raw [0,255] pixels
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    init_mode: str = "content"           # "content" | "noise" | "style_mean"
    init_noise_scale: float = 50.0       # stddev when init_mode == "noise"
    clip_pixels: bool = True             # project to [0,255] every step
    seed: int = 0

    # --- multi-scale schedule ---------------------------------------------
    scales: Tuple[int, ...] = ()
    scale_iter_factor: float = 1.0
    scale_iters: Tuple[int, ...] = ()

    # --- VGG feature extraction ------------------------------------------
    style_layers: Tuple[str, ...] = (
        "conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
    content_layers: Tuple[str, ...] = ("conv4_2",)
    style_layer_weights: Tuple[float, ...] = (0.2, 0.2, 0.2, 0.2, 0.2)
    # "gatys": Σm²-normalized Grams, 1/(4C²), coverage-weighted classes;
    # "paper": Σm-normalized Grams, ½‖ΔG‖² per class, no coverage weights
    style_norm: str = "gatys"
    pooling: str = "max"                 # "max" | "avg"
    compute_dtype: str = "bfloat16"      # conv / Gram operand dtype
    # TPU lowering switches (see the module docstring for what each does
    # in the port)
    conv_impl: str = "auto"
    gram_impl: str = "auto"
    pool_impl: str = "auto"
    s2b_strips: int = -1
    block1_impl: str = "auto"
    strip_gram: str = "auto"
    s2d_gram: str = "auto"
    stream12: int = -1
    stream12_impl: str = "scan"
    stream12_remat: str = "auto"
    stream12_conv2: str = "auto"
    remat: str = "none"
    # per-step history detail; Adam always records all five terms
    history_terms: str = "auto"

    # --- segmentation / masks --------------------------------------------
    use_segmentation: bool = True
    max_classes: int = 8
    similarity_metric: str = "grouped"
    similarity_threshold: float = 0.25
    mask_downsample: str = "avg"         # "avg" | "nearest" per VGG layer
    seg_protocol: str = "resize"
    seg_scales: Tuple[float, ...] = (1.0,)

    # --- matting Laplacian (photorealism) ---------------------------------
    use_photorealism: bool = True
    matting_epsilon: float = 1e-5        # ε in Levin's closed-form matting
    laplacian_impl: str = "auto"         # "spmd": rows over the mesh

    # --- post-processing ---------------------------------------------------
    post_smooth: int = 0
    post_smooth_eps: float = 1e-4

    # --- checkpointing / observability ------------------------------------
    intermediate_interval: int = 100     # callback every k iters (0 = off)
    checkpoint_dir: str = ""
    profile_dir: str = ""
    debug_nans: bool = False

    def __post_init__(self):
        if len(self.style_layer_weights) != len(self.style_layers):
            raise ValueError(
                "style_layer_weights must match style_layers: "
                f"{len(self.style_layer_weights)} vs {len(self.style_layers)}")
        if self.optimizer not in ("adam", "lbfgs"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.scale_iters:
            if len(self.scale_iters) != len(self.scales):
                raise ValueError(
                    "scale_iters must match scales: "
                    f"{len(self.scale_iters)} vs {len(self.scales)}")
            if any(n < 1 for n in self.scale_iters):
                raise ValueError("scale_iters entries must be >= 1")
        if self.init_mode not in ("content", "noise", "style_mean"):
            raise ValueError(f"unknown init_mode {self.init_mode!r}")
        if self.pooling not in ("max", "avg"):
            raise ValueError(f"unknown pooling {self.pooling!r}")
        if self.laplacian_impl not in ("auto", "pallas", "xla", "spmd"):
            raise ValueError(f"unknown laplacian_impl {self.laplacian_impl!r}")
        if self.conv_impl not in ("auto", "pallas", "xla", "flipvjp",
                                  "padbwd", "dotbwd", "dot11"):
            raise ValueError(f"unknown conv_impl {self.conv_impl!r}")
        if self.style_norm not in ("gatys", "paper"):
            raise ValueError(f"unknown style_norm {self.style_norm!r}")
        if self.gram_impl not in ("auto", "pallas", "xla", "dotg",
                                  "stream", "hybrid"):
            raise ValueError(f"unknown gram_impl {self.gram_impl!r}")
        if self.pool_impl not in ("auto", "pallas", "xla", "noties",
                                  "postact"):
            raise ValueError(f"unknown pool_impl {self.pool_impl!r}")
        if self.remat not in ("none", "full", "block1", "block12"):
            raise ValueError(f"unknown remat {self.remat!r}")
        if self.s2b_strips < -1:
            raise ValueError(
                f"s2b_strips must be -1 (auto), 0 (off) or a strip "
                f"count, got {self.s2b_strips}")
        if self.stream12 < -1:
            raise ValueError(
                f"stream12 must be -1 (auto), 0 (off) or a strip count, "
                f"got {self.stream12}")
        if self.stream12 == 1:
            object.__setattr__(self, "stream12", 0)  # 1 strip = no-op
        if self.stream12_impl not in ("scan", "pallas"):
            raise ValueError(
                f"unknown stream12_impl {self.stream12_impl!r}")
        if self.stream12_remat not in ("auto", "full", "b2", "b12",
                                       "b12f"):
            raise ValueError(
                f"unknown stream12_remat {self.stream12_remat!r}")
        if self.stream12_conv2 not in ("auto", "conv", "dot"):
            raise ValueError(
                f"unknown stream12_conv2 {self.stream12_conv2!r}")
        if self.s2b_strips == 1:
            object.__setattr__(self, "s2b_strips", 0)  # 1 strip = no-op
        if self.strip_gram not in ("auto", "interior", "perm", "permh"):
            raise ValueError(f"unknown strip_gram {self.strip_gram!r}")
        if self.block1_impl not in ("auto", "s2d", "conv"):
            raise ValueError(f"unknown block1_impl {self.block1_impl!r}")
        if self.s2d_gram not in ("auto", "nd", "pallas", "pallas1",
                                 "pallas2"):
            raise ValueError(f"unknown s2d_gram {self.s2d_gram!r}")
        if self.history_terms not in ("auto", "full", "total"):
            raise ValueError(
                f"unknown history_terms {self.history_terms!r}")
        if self.seg_protocol not in ("resize", "sliding"):
            raise ValueError(
                f"unknown seg_protocol {self.seg_protocol!r}")

    def spmd_safe(self) -> "StylizeConfig":
        """The config of a row-sharded or multi-device run, as
        `dpst_tpu/config.py:spmd_safe` resolves it: laplacian "pallas" →
        "spmd" and "auto" → "xla"; conv "pallas" → "xla" (cuDNN); gram
        "stream", "pallas", "hybrid" and "auto" → "xla" (the fused route,
        `gram_fwd` and `gram_bwd`); pool "pallas" → "xla"; no s2b strips,
        no space-to-depth block 1 (so no fused bias+ReLU Gram), s2d_gram
        "nd", no stream12. The row-sharded loop (`parallel/spatial.py`)
        runs every conv on cuDNN and every Gram on the fused route; these
        fields say so."""
        return dataclasses.replace(
            self,
            laplacian_impl={"pallas": "spmd", "auto": "xla"}.get(
                self.laplacian_impl, self.laplacian_impl),
            conv_impl={"pallas": "xla"}.get(self.conv_impl, self.conv_impl),
            gram_impl={"stream": "xla", "pallas": "xla", "auto": "xla",
                       "hybrid": "xla"}.get(self.gram_impl, self.gram_impl),
            pool_impl={"pallas": "xla"}.get(self.pool_impl, self.pool_impl),
            s2b_strips=0, strip_gram="interior", block1_impl="conv",
            s2d_gram="nd", stream12=0, stream12_impl="scan",
            stream12_remat="auto", stream12_conv2="auto")


# Named presets (the same five as the JAX package).
PRESETS = {
    "config1": StylizeConfig(  # 256² content + Gram style only
        use_segmentation=False, use_photorealism=False,
        iterations=300, compute_dtype="float32"),
    "config2": StylizeConfig(  # 512² with automatic segmentation masks
        use_photorealism=False, iterations=500),
    "config3": StylizeConfig(  # 512² full deep-photo objective
        iterations=500),
    "config4": StylizeConfig(  # 1024² multi-scale coarse-to-fine
        iterations=300, scales=(256, 512, 1024), scale_iter_factor=1.0),
    "config5": StylizeConfig(  # batched 8-pair stylization
        iterations=500),
}
