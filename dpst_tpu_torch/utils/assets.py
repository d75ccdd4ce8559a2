"""Weight bundles: where the port looks for them, their environment
overrides, and a status report (`python -m dpst_tpu_torch.utils.assets`).

The counterpart of `dpst_tpu/utils/assets.py`, and the one place that
names a bundle's path: the loaders (`models.vgg.get_params`,
`models.pspnet.get_params`, `models.nima.get_params` and
`semantic_merge`'s similarity matrix) ask `bundle_path`. The bundles are
the JAX package's `.npz` files, made offline from public checkpoints by
the converters under `tools/`; nothing is downloaded. A missing bundle
means the seeded random init (the similarity matrix: the built-in
metrics). `DPST_WEIGHTS_DIR` moves the directory; each bundle's own
variable names its file. Both are read at each call.
"""
from __future__ import annotations

import os

DEFAULT_WEIGHTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "weights"))

# name: (environment override, file in the weights directory, converter)
BUNDLES = {
    "vgg19": ("DPST_VGG_WEIGHTS", "vgg19.npz",
              "tools/convert_vgg.py  (torchvision vgg19 .pth)"),
    "pspnet50_ade20k": ("DPST_PSPNET_WEIGHTS", "pspnet50_ade20k.npz",
                        "tools/convert_pspnet.py  (semseg pspnet50 .pth)"),
    "nima_mobilenet": ("DPST_NIMA_WEIGHTS", "nima_mobilenet.npz",
                       "tools/convert_nima.py  (idealo mobilenet_weights"
                       ".h5 or torch .pth)"),
    "similarity_matrix": ("DPST_SIMILARITY_MATRIX",
                          "similarity_matrix.npz",
                          "any 150x150 label-embedding similarity "
                          "(key 'similarity'; semantic_merge.py)"),
}


def weights_dir() -> str:
    """$DPST_WEIGHTS_DIR, else the repository's `weights/`."""
    return os.environ.get("DPST_WEIGHTS_DIR", DEFAULT_WEIGHTS_DIR)


def bundle_path(name: str) -> str:
    """The bundle's file: its own variable, else its name in
    `weights_dir()`."""
    env, fname, _ = BUNDLES[name]
    return os.environ.get(env, os.path.join(weights_dir(), fname))


def bundle_available(name: str) -> bool:
    return os.path.exists(bundle_path(name))


def status() -> dict[str, dict]:
    """{bundle: {path, available, env_override, converter}}."""
    out = {}
    for name, (env, _, converter) in BUNDLES.items():
        path = bundle_path(name)
        out[name] = {"path": path, "available": os.path.exists(path),
                     "env_override": env, "converter": converter}
    return out


if __name__ == "__main__":
    for name, info in status().items():
        mark = "✓" if info["available"] else "✗ (random init fallback)"
        print(f"{name:18s} {mark}  {info['path']}")
        if not info["available"]:
            print(f"{'':18s}    drop-in: {info['converter']}, "
                  f"or ${info['env_override']}")
