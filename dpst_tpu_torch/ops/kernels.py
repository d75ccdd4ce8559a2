"""Build, load and count the port's hand-written CUDA kernels.

The kernels are CUDA C++ for sm_90a under `dpst_tpu_torch/csrc/`. At first
use on a CUDA tensor, `library()` compiles every `.cu` file there with
`nvcc` (one process per source, all started together), links them into one
`libdpst_kernels-<hash>.so` under `dpst_tpu_torch/_build/` and loads it
with ctypes. The hash covers the sources and the flags, so a changed
source is rebuilt and an unchanged one is loaded as built. Nothing here
runs at import time, and nothing builds for CPU tensors: their wrappers
take the kernels' plain PyTorch versions.

Each kernel wrapper adds one to its entry in `LAUNCHES` where it launches
its kernel, and nowhere else; `reset_launches()` sets all of them to 0.
`lap_matvec`, `gram_fwd`, `gram_bwd`, `gram_relu_fwd`, `gram_relu_bwd`,
`gram_wbwd` and `conv3x3` take a leading batch axis of B pairs as an index
of the kernel's grid, and the block12 entry points walk the B pairs' bands
in one call: one launch, one count, whatever B is.
`block12_fwd` and `block12_fwd_res` are two counts over one entry point
(`dpst_block12_fwd` without and with its residuals); `block12_gram_dz`
counts calls of the backward entry points' Gram cotangent stage alone (its
kernel runs inside `block12_bwd_deep` and `block12_bwd_shallow`, which
count those launches).
The forms that take channels_last activations as they lie count under
names of their own (`NHWC_FORMS`: the twin's name with `_nhwc`, or `_pc`
for the Gram kernels' (P, C) operand), so that a run shows which layout
its path took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

KERNELS = ("lap_matvec", "gram_fwd", "gram_bwd", "gram_relu_fwd",
           "gram_relu_bwd", "gram_wbwd", "pool_bwd", "conv3x3",
           "block12_fwd", "block12_fwd_res", "block12_bwd_deep",
           "block12_bwd_shallow", "block12_gram_dz", "bias_relu_fwd",
           "bias_relu_bwd")
# {form on channels_last operands: its NCHW / (C, P) twin}
NHWC_FORMS = {"bias_relu_fwd_nhwc": "bias_relu_fwd",
              "bias_relu_bwd_nhwc": "bias_relu_bwd",
              "pool_bwd_nhwc": "pool_bwd", "gram_fwd_pc": "gram_fwd",
              "gram_relu_fwd_pc": "gram_relu_fwd", "gram_bwd_pc": "gram_bwd",
              "gram_relu_bwd_pc": "gram_relu_bwd",
              "gram_wbwd_pc": "gram_wbwd"}
KERNELS += tuple(NHWC_FORMS)
LAUNCHES = dict.fromkeys(KERNELS, 0)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_lib = None


def torch_dtype(name) -> torch.dtype:
    """A config's compute dtype ("float32", "bfloat16" or a torch dtype)."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            f"{CSRC} on a machine with the CUDA toolkit")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


# the compiler's output of each source of the last verbose build
BUILD_LOG: dict[str, str] = {}


def build(verbose: bool = False) -> Path:
    """Compile and link the kernels if the current sources are not built
    yet; return the library's path. `verbose` adds `-Xptxas -v` (registers,
    shared memory and spills per kernel) and prints the compiler's output."""
    lib_path = BUILD_DIR / f"libdpst_kernels-{_digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            text = out.decode(errors="replace")
            if verbose and text:
                print(f"[nvcc {src.name}]\n{text}", flush=True)
                BUILD_LOG[src.name] = text
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builds agree
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dpst_lap_matvec.argtypes = [p, p, p, i, i, i, i, ll, p]
        lib.dpst_lap_div9_mismatches.argtypes = [p, p]
        lib.dpst_gram_fwd.argtypes = [p] * 4 + [i] * 8 + [p]
        lib.dpst_gram_bwd.argtypes = [p] * 5 + [i] * 9 + [p]
        lib.dpst_gram_relu_fwd.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.dpst_gram_relu_bwd.argtypes = [p] * 6 + [i] * 9 + [p]
        lib.dpst_gram_wbwd.argtypes = [p] * 5 + [i] * 9 + [p]
        lib.dpst_gram_wgmma_attrs.argtypes = [i, p]
        lib.dpst_pool2_bwd.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.dpst_conv3x3.argtypes = [p, p, p, p] + [i] * 9 + [p]
        lib.dpst_conv3x3_attrs.argtypes = [i, i, p]
        lib.dpst_block12_conv_attrs.argtypes = [i, p]
        lib.dpst_block12_scratch_bytes.argtypes = [i] * 7
        lib.dpst_block12_scratch_bytes.restype = ctypes.c_size_t
        lib.dpst_block12_fwd.argtypes = [p] * 18 + [i] * 9 + [p]
        lib.dpst_block12_bwd_deep.argtypes = [p] * 9 + [i] * 8 + [p]
        lib.dpst_block12_bwd_shallow.argtypes = [p] * 10 + [i] * 8 + [p]
        lib.dpst_block12_gram_dz.argtypes = [p] * 5 + [i] * 8 + [p]
        lib.dpst_block12_df_plan.argtypes = [i] * 6 + [p]
        lib.dpst_block12_df_attrs.argtypes = [i, p]
        lib.dpst_bias_relu_fwd.argtypes = [p, p, p, ll, i, ll, i, p]
        lib.dpst_bias_relu_bwd.argtypes = [p, p, p, p, ll, i, ll, i, p]
        lib.dpst_bias_relu_fwd_nhwc.argtypes = [p, p, p, ll, i, i, p]
        lib.dpst_bias_relu_bwd_nhwc.argtypes = [p, p, p, p, ll, i, i, p]
        lib.dpst_pool2_bwd_nhwc.argtypes = [p] * 4 + [i] * 5 + [p]
        for fn in (lib.dpst_lap_matvec, lib.dpst_lap_div9_mismatches,
                   lib.dpst_gram_fwd,
                   lib.dpst_gram_bwd, lib.dpst_gram_relu_fwd,
                   lib.dpst_gram_relu_bwd, lib.dpst_gram_wbwd,
                   lib.dpst_pool2_bwd, lib.dpst_conv3x3,
                   lib.dpst_block12_fwd, lib.dpst_block12_bwd_deep,
                   lib.dpst_block12_bwd_shallow, lib.dpst_gram_wgmma_attrs,
                   lib.dpst_conv3x3_attrs, lib.dpst_block12_conv_attrs,
                   lib.dpst_block12_gram_dz, lib.dpst_block12_df_plan,
                   lib.dpst_block12_df_attrs, lib.dpst_bias_relu_fwd,
                   lib.dpst_bias_relu_bwd, lib.dpst_bias_relu_fwd_nhwc,
                   lib.dpst_bias_relu_bwd_nhwc, lib.dpst_pool2_bwd_nhwc):
            fn.restype = ctypes.c_int
        lib.dpst_error_string.argtypes = [i]
        lib.dpst_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device pointer; None gives a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = library().dpst_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {rc} ({msg})")


def require(t: torch.Tensor, name: str, shape: tuple | None = None,
            dtype: torch.dtype | None = None) -> None:
    """Validate a tensor handed to a kernel wrapper."""
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {t.dtype} is not supported "
                         "(float32 or bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def channels_last(t: torch.Tensor, channels: int = -3) -> bool:
    """True for a tensor whose `channels` axis lies fastest in memory, the
    rest in order, and that is not also contiguous: an (N, C, H, W) or (C,
    H, W) activation that lies channels_last (`channels` = -3, the NHWC
    forms' operand), or a flattened tap, (C, P) or (B, C, P), that lies
    (P, C) (`channels` = -2, the Gram kernels' (P, C) forms' operand)."""
    return (t.dim() >= -channels and not t.is_contiguous()
            and t.movedim(channels, -1).is_contiguous())


def require_aligned(t: torch.Tensor, name: str, nbytes: int = 16) -> None:
    """Raise unless t's data starts on an nbytes boundary (a kernel copies
    it in 16-byte pieces; a view into a tensor may start anywhere)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: data must start on a {nbytes}-byte "
                         "boundary")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on a CUDA device, False if every one is on
    the CPU; raises on a mix or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        devs = {t.device for t in tensors}
        if len(devs) != 1:
            raise ValueError(f"tensors on several CUDA devices: {devs}")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"unsupported device mix for a kernel: {kinds}")
