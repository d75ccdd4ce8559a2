"""Levin's matting Laplacian as a sparse matrix, in fp64 on the host: the
oracle that the matrix-free matvecs are held to (numpy and scipy; never
on a stylization path).

The port's copy of `dpst_tpu/ops/matting_oracle.py`: the N×N matrix
assembled window by window as the reference builds it on the CPU
(`build_laplacian_csr`, `matvec_oracle`), and the independent C++
implementation (`native/matting_oracle.cpp`, built into
`native/build/libmatting_oracle.so` by `tools/build_native.sh`, loaded
with ctypes: `native_available`, `matvec_native`), fast enough for sizes
where assembling the matrix in Python takes minutes. The port's plain
matvec (`ops/laplacian.py`) and its kernel (`ops/laplacian_cuda.py`)
compute the same L·v without forming L.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import scipy.sparse as sp

WIN_RAD = 1
WIN = (2 * WIN_RAD + 1) ** 2  # 9

_NATIVE_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                            "build", "libmatting_oracle.so")
_native_lib = None


def build_laplacian_csr(image01: np.ndarray, eps: float = 1e-5
                        ) -> sp.csr_matrix:
    """L as an (H·W)×(H·W) CSR matrix from an (H, W, 3) image in [0, 1].

    Interior 3×3 windows only; per window k:
      W_k[i,j] = δ_ij − (1/9)·(1 + (I_i−μ_k)ᵀ (Σ_k + ε/9·Id)⁻¹ (I_j−μ_k)).
    """
    img = np.asarray(image01, dtype=np.float64)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"takes an (H, W, 3) image, got {img.shape}")
    n = h * w
    idx = np.arange(n).reshape(h, w)

    rows, cols, vals = [], [], []
    eye = np.eye(3)
    for cy in range(WIN_RAD, h - WIN_RAD):
        for cx in range(WIN_RAD, w - WIN_RAD):
            win_idx = idx[cy - WIN_RAD:cy + WIN_RAD + 1,
                          cx - WIN_RAD:cx + WIN_RAD + 1].ravel()
            win_i = img[cy - WIN_RAD:cy + WIN_RAD + 1,
                        cx - WIN_RAD:cx + WIN_RAD + 1].reshape(WIN, 3)
            mu = win_i.mean(axis=0)
            cov = (win_i.T @ win_i) / WIN - np.outer(mu, mu)
            lam = np.linalg.inv(cov + (eps / WIN) * eye)
            d = win_i - mu  # (9, 3)
            wk = np.eye(WIN) - (1.0 / WIN) * (1.0 + d @ lam @ d.T)
            rows.append(np.repeat(win_idx, WIN))
            cols.append(np.tile(win_idx, WIN))
            vals.append(wk.ravel())

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


def matvec_oracle(image01: np.ndarray, v: np.ndarray,
                  eps: float = 1e-5) -> np.ndarray:
    """y = L·v via the CSR oracle. v: (H, W) or (H, W, C)."""
    h, w = image01.shape[:2]
    lap = build_laplacian_csr(image01, eps)
    if v.ndim == 2:
        return (lap @ v.reshape(-1)).reshape(h, w)
    return np.stack([(lap @ v[..., i].reshape(-1)).reshape(h, w)
                     for i in range(v.shape[-1])], axis=-1)


def native_available() -> bool:
    """Whether tools/build_native.sh has built the C++ oracle."""
    return os.path.exists(_NATIVE_PATH)


def _load_native():
    global _native_lib
    if _native_lib is None:
        lib = ctypes.CDLL(_NATIVE_PATH)
        lib.matting_matvec.restype = ctypes.c_int
        lib.matting_matvec.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double,
        ]
        _native_lib = lib
    return _native_lib


def matvec_native(image01: np.ndarray, v: np.ndarray,
                  eps: float = 1e-5) -> np.ndarray:
    """y = L·v via the C++ oracle (fp64, matrix-free). v: (H, W) or (H, W,
    C) with the image's (H, W). Build it once with tools/build_native.sh;
    `native_available()` says whether it is there."""
    lib = _load_native()
    squeeze = v.ndim == 2
    if squeeze:
        v = v[..., None]
    h, w, c = v.shape
    if image01.shape != (h, w, 3):
        raise ValueError(f"image {image01.shape} and v {v.shape} differ in "
                         f"(H, W), or the image is not (H, W, 3)")
    img = np.ascontiguousarray(image01, np.float64)
    vv = np.ascontiguousarray(v, np.float64)
    out = np.empty_like(vv)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    rc = lib.matting_matvec(ptr(img), ptr(vv), ptr(out), h, w, c,
                            float(eps))
    if rc != 0:
        raise RuntimeError(f"matting_matvec failed with code {rc}")
    return out[..., 0] if squeeze else out
