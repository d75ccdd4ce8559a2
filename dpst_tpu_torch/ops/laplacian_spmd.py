"""Row-sharded matting-Laplacian matvec: `lap_matvec` on every shard with
an explicit 2-row halo exchange.

The port's counterpart of `dpst_tpu/ops/laplacian_spmd.py`. The image's
rows are split over the devices of a mesh's row axis; each shard gets its
neighbours' two adjacent rows (`exchange_rows`: `.to(device)` where the
JAX package uses `lax.ppermute`) and runs the unmodified one-device
matvec (`ops/laplacian_cuda.lap_matvec`: the kernel on a CUDA shard, the
plain version on a CPU shard) on its halo-extended block, then crops the
halo rows away.

Why 2 rows: the Levin matvec is two chained 3×3 box passes; output row r
reads window centres r±1, which read input rows r±2. The halo rows only
feed rows that are cropped, and at the global image edges the missing
neighbours are zero rows, which reproduce the zero-padded "SAME" edges of
the one-device matvec (the stats' `valid` and `win_count` planes are the
whole image's). Every output value is computed from the same operands in
the same order as on one device: the result is bit-equal to the
unsharded matvec of the same route.
"""
from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import ROW_AXIS, Mesh, current_mesh
from ..utils import runtime
from .laplacian_cuda import lap_matvec

HALO = 2
# `runtime.span` of every halo exchange (and level gather), the
# torch.profiler range HALO_RANGE: its device time is the "halo copies"
# group of a profile
HALO_SPAN = "halo"
HALO_RANGE = runtime.PREFIX + HALO_SPAN


def exchange_rows(shards: list, halo: int = HALO) -> list:
    """Each shard (..., h, W) with its neighbours' adjacent `halo` rows
    appended above and below: (..., h + 2·halo, W), contiguous, on the
    shard's device. The first and last shards get zero rows at the global
    edges (ppermute's semantics for un-sourced destinations)."""
    def edge(x):
        return x.new_zeros((*x.shape[:-2], halo, x.shape[-1]))

    out = []
    with runtime.span(HALO_SPAN):
        for i, x in enumerate(shards):
            top = shards[i - 1][..., -halo:, :].to(x.device) if i else edge(x)
            bot = (shards[i + 1][..., :halo, :].to(x.device)
                   if i + 1 < len(shards) else edge(x))
            out.append(torch.cat([top, x, bot], dim=-2))
    return out


def local_matvec(ext_stats: list, v_shards: list) -> list:
    """y = L·v of every shard: v (..., 3, h, W) exchanged to h + 4 rows,
    `lap_matvec` on it with the shard's halo-extended stats (..., 14, h +
    4, W), the halo rows cropped. One launch a shard."""
    return [lap_matvec(s, v)[..., HALO:-HALO, :]
            for s, v in zip(ext_stats, exchange_rows(v_shards))]


def split_rows(t: torch.Tensor, devices) -> list:
    """t's rows (dim -2) in len(devices) equal parts, each on its device."""
    step = t.shape[-2] // len(devices)
    return [t[..., i * step:(i + 1) * step, :].to(d)
            for i, d in enumerate(devices)]


def gather_rows(shards: list, dev: torch.device, dim: int = -2
                ) -> torch.Tensor:
    """The shards' rows concatenated on `dev` (a result, or a level
    gather)."""
    with runtime.span(HALO_SPAN):
        return torch.cat([s.to(dev) for s in shards], dim=dim)


def matvec_rows(packed: torch.Tensor, v3: torch.Tensor, devices) -> torch.Tensor:
    """L·v of v3 (..., 3, H, W) planes with the (..., 14, H, W) packed stats
    of the whole image, rows split over `devices`: the result gathered on
    v3's device."""
    return gather_rows(local_matvec(exchange_rows(split_rows(packed, devices)),
                                    split_rows(v3, devices)), v3.device)


def row_devices(mesh: Mesh | None, axis_name: str, rows: int) -> list:
    """The devices along `axis_name` of `mesh` (the ambient mesh when
    None) that `rows` rows split over, at index 0 of its other axes.
    Raises ValueError with the JAX package's texts where there is no such
    mesh or a shard would have fewer than HALO rows."""
    if mesh is None:
        mesh = current_mesh()
    if mesh is None or axis_name not in mesh.axis_names:
        raise ValueError(
            f"matvec_spmd: no ambient mesh with axis {axis_name!r}; wrap "
            "the call in use_mesh(mesh) or pass mesh=")
    axis = mesh.axis_names.index(axis_name)
    devs = list(np.moveaxis(mesh.devices, axis, 0).reshape(
        mesh.devices.shape[axis], -1)[:, 0])
    n = len(devs)
    if rows // n < HALO:
        raise ValueError(
            f"matvec_spmd: {rows} rows over {n} shards gives {rows // n} "
            f"local rows < the {HALO}-row halo; use a smaller mesh (≤ "
            f"{rows // HALO} shards) or the one-device matvec "
            "(laplacian_impl='xla')")
    if rows % n:
        raise ValueError(f"matvec_spmd: {rows} rows not divisible by "
                         f"{n} shards")
    return devs


def matvec_spmd(packed: torch.Tensor, v: torch.Tensor,
                axis_name: str = ROW_AXIS, mesh: Mesh | None = None
                ) -> torch.Tensor:
    """y = L·v with the rows split over `axis_name` of `mesh` (the ambient
    mesh of `use_mesh` when None); `lap_matvec` on every shard. Global in,
    global out: packed (14, H, W) stats (`laplacian_cuda.pack_stats`), v
    (H, W) or (H, W, C); y like v, on v's device. The channels run in
    groups of three (the kernel's planes; the last group zero-padded),
    all groups of a shard in one launch. Requires H divisible by the
    shard count and at least HALO rows a shard."""
    devs = row_devices(mesh, axis_name, v.shape[0])
    planes = (v[..., None] if v.dim() == 2 else v).to(
        torch.float32).movedim(-1, 0)
    c = planes.shape[0]
    if c % 3:
        planes = torch.cat([planes, planes.new_zeros(
            (3 - c % 3, *planes.shape[1:]))])
    y = matvec_rows(packed, planes.reshape(-1, 3, *planes.shape[1:])
                    .contiguous(), devs)
    y = y.reshape(-1, *y.shape[-2:])[:c].movedim(0, -1)
    return y[..., 0] if v.dim() == 2 else y


class AmbientMatvec:
    """The photoreal term's matvec under `laplacian_impl="spmd"`: v3 (...,
    3, H, W) with its packed stats, rows over the ambient mesh's row axis,
    gathered on v3's device. The stats' shards and halos are made on the
    first call with a stats tensor and kept while the same one (same
    memory, unmodified) comes on the same devices, as `matvec_spmd` alone
    would remake them every call. One per loss function
    (`optimize.make_loss_fn`)."""

    def __init__(self):
        self._key, self._held, self._ext = None, None, None

    def __call__(self, packed: torch.Tensor, v3: torch.Tensor
                 ) -> torch.Tensor:
        devs = row_devices(None, ROW_AXIS, v3.shape[-2])
        key = (packed.data_ptr(), packed.shape, packed.stride(),
               packed.device, packed._version, tuple(devs))
        if key != self._key:
            # holding the tensor keeps its memory, so its address names it
            self._held = packed
            self._ext = exchange_rows(split_rows(packed, devs))
            self._key = key
        return gather_rows(local_matvec(self._ext, split_rows(v3, devs)),
                           v3.device)


class _PhotorealShards(torch.autograd.Function):
    """Σ v·(L·v) of each row shard, v = img/255; backward (2/255)·y·g of
    each shard from the forward's y (L is symmetric: the gradient of the
    whole vᵀLv is 2·L·v, whose rows are each shard's own y)."""

    @staticmethod
    def forward(ctx, ext_stats, *imgs):
        v = [(im.to(torch.float32) * (1.0 / 255.0)).movedim(-1, -3)
             .contiguous() for im in imgs]
        ys = local_matvec(ext_stats, v)
        ctx.save_for_backward(*ys)
        return tuple(torch.sum(vi * yi, dim=(-3, -2, -1))
                     for vi, yi in zip(v, ys))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(
            ((2.0 / 255.0) * y * g[..., None, None, None]).movedim(-3, -1)
            for y, g in zip(ctx.saved_tensors, gs))


def photoreal_shards(ext_stats: list, img_shards: list) -> list:
    """The photorealism term of each row shard of a [0, 255] image, or of
    a batch ((..., h, W, 3) shards): one value (or (B,)) a shard on its
    device; their sum is `laplacian.photoreal_loss` of the whole image.
    `ext_stats` are the shards' halo-extended packed stats (..., 14, h +
    4, W) (`parallel/spatial.shard_spatial`)."""
    return list(_PhotorealShards.apply(ext_stats, *img_shards))
