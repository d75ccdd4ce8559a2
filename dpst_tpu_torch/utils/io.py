"""Image I/O and host-side preprocessing.

Images enter the port as float32 [0,255] RGB arrays of shape (H, W, 3)
and go to the device once per run.
"""
from __future__ import annotations

import numpy as np
from PIL import Image


def load_image(path_or_array, size: int | tuple[int, int] | None = None,
               ) -> np.ndarray:
    """Load an image as float32 RGB in [0, 255], shape (H, W, 3).

    Accepts a filesystem path or an already-loaded array (HWC uint8/float;
    an array in [0, 1] is scaled by 255). `size` resizes: an int means
    "longest side == size, keep aspect, snap to multiples of 8"; a tuple
    is an exact (H, W).
    """
    if isinstance(path_or_array, np.ndarray):
        arr = path_or_array
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        if arr.shape[-1] == 4:
            arr = arr[..., :3]
        arr = arr.astype(np.float32)
        if arr.max() <= 1.0 + 1e-6 and arr.min() >= 0.0:
            arr = arr * 255.0
        if size is not None:
            arr = _resize_np(arr, _target_hw(arr.shape[:2], size))
        return np.ascontiguousarray(arr, dtype=np.float32)

    img = Image.open(path_or_array).convert("RGB")
    if size is not None:
        th, tw = _target_hw((img.height, img.width), size)
        img = img.resize((tw, th), Image.LANCZOS)
    return np.asarray(img, dtype=np.float32)


def save_image(array, path: str) -> None:
    """Save a float [0,255] HWC array as an image file."""
    Image.fromarray(to_uint8(array)).save(path)


def to_uint8(array) -> np.ndarray:
    # round, don't truncate: a bare uint8 cast would bias every saved
    # pixel by −0.5 on average
    return np.clip(np.rint(np.asarray(array)), 0.0, 255.0).astype(
        np.uint8)


def _target_hw(hw: tuple[int, int], size) -> tuple[int, int]:
    h, w = hw
    if isinstance(size, tuple):
        return int(size[0]), int(size[1])
    # longest side == size, snap both dims to multiples of 8
    scale = float(size) / float(max(h, w))
    th = max(8, int(round(h * scale / 8.0)) * 8)
    tw = max(8, int(round(w * scale / 8.0)) * 8)
    return th, tw


def _resize_np(arr: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Lanczos resize of a float array, channel by channel in PIL's float
    mode "F" (no uint8 round trip)."""
    if tuple(arr.shape[:2]) == tuple(hw):
        return arr.astype(np.float32)
    chans = [
        np.asarray(
            Image.fromarray(arr[..., c].astype(np.float32), mode="F")
            .resize((hw[1], hw[0]), Image.LANCZOS),
            dtype=np.float32)
        for c in range(arr.shape[-1])]
    return np.stack(chans, axis=-1)
