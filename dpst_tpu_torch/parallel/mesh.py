"""Device meshes for data-parallel and row-sharded stylization.

The port's counterpart of `dpst_tpu/parallel/mesh.py`. The JAX package is
single-controller: one process sees every device and places arrays with
`NamedSharding`. So is the port: a `Mesh` is a numpy object array of
`torch.device`s with its axis names, and placing a tensor on it gives
the per-device tensors, in the mesh's shape. Work on a shard runs on its
device (kernel launches are asynchronous, so devices overlap while the
host walks the shards); halo rows move between shards by `.to(device)`,
which autograd carries back.

A mesh may name one device more than once (`make_mesh(devices=["cpu"] *
4)`, or `["cuda:0"] * 4`): the counterpart of the JAX tests' virtual CPU
devices. It runs the same decomposition (halos, reductions, a launch per
shard) on one device.

`use_mesh(mesh)` sets the ambient mesh that `laplacian_impl="spmd"` reads
(`current_mesh()`), as `jax.set_mesh` does.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import numpy as np
import torch

from ..utils.runtime import canonical

BATCH_AXIS = "batch"
ROW_AXIS = "rows"


class Mesh:
    """An array of devices with one name per axis."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = canonical(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D devices, axis names "
                             f"{axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first(self) -> torch.device:
        """The first device: where gathered levels run and every shard's
        terms are reduced."""
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def _visible_devices() -> list:
    """Every CUDA device (`jax.devices()`'s counterpart); raises without
    one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a mesh defaults to the CUDA devices; pass "
            "devices=['cpu', ...] to run the plain PyTorch path on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _take(n: int, devices) -> list:
    devs = _visible_devices() if devices is None else list(devices)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return devs[:n]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D (batch) mesh over the first `n_devices` of `devices` (all of
    them by default). `devices` defaults to the visible CUDA devices; an
    explicit list may repeat a device."""
    devs = _visible_devices() if devices is None else list(devices)
    return Mesh(_take(len(devs) if n_devices is None else n_devices, devs),
                (BATCH_AXIS,))


def make_mesh_2d(n_batch: int, n_rows: int, devices=None) -> Mesh:
    """2-D (pairs × image rows) mesh: data parallelism over pairs and row
    sharding within each pair (`parallel/spatial.py`)."""
    devs = np.empty(n_batch * n_rows, dtype=object)
    devs[:] = _take(n_batch * n_rows, devices)
    return Mesh(devs.reshape(n_batch, n_rows), (BATCH_AXIS, ROW_AXIS))


def has_row_axis(mesh: Mesh) -> bool:
    return mesh.shape.get(ROW_AXIS, 1) > 1


class NamedSharding(NamedTuple):
    """How a tensor lies on a mesh: `spec[d]` names the mesh axis that
    splits the tensor's dim d (None: whole); dims past the spec are whole,
    and mesh axes the spec does not name hold copies."""
    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for per-pair data."""
    return NamedSharding(mesh, (BATCH_AXIS,))


def image_sharding(mesh: Mesh) -> NamedSharding:
    """(B, H, W, C) stacks: pair axis, and the row axis when the mesh has
    one."""
    if has_row_axis(mesh):
        return NamedSharding(mesh, (BATCH_AXIS, ROW_AXIS))
    return NamedSharding(mesh, (BATCH_AXIS,))


def mask_sharding(mesh: Mesh) -> NamedSharding:
    """(B, K, H, W) mask stacks: rows are axis 2."""
    if has_row_axis(mesh):
        return NamedSharding(mesh, (BATCH_AXIS, None, ROW_AXIS))
    return NamedSharding(mesh, (BATCH_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    """A whole copy on every device (VGG weights, loss weights)."""
    return NamedSharding(mesh, ())


def put(x, sharding: NamedSharding) -> np.ndarray:
    """The per-device pieces of x under `sharding`: an object array of the
    mesh's shape whose entry at a device's index is its piece, on it.
    Raises ValueError where a split dim does not divide its axis. A
    non-tensor (a Python float) is every device's piece as it is."""
    mesh = sharding.mesh
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(out.shape):
        piece = x
        if isinstance(x, torch.Tensor):
            for d, axis in enumerate(sharding.spec):
                if axis is None:
                    continue
                n = mesh.shape[axis]
                if x.shape[d] % n:
                    raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                     f"divide the mesh's {n}-way {axis!r} "
                                     "axis")
                step = x.shape[d] // n
                piece = piece.narrow(
                    d, idx[mesh.axis_names.index(axis)] * step, step)
            piece = piece.to(mesh.devices[idx]).contiguous()
        out[idx] = piece
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: Mesh):
    """`put` every leaf of a tree (dicts, lists, tuples, NamedTuples) with
    its leading axis split over the mesh's batch axis."""
    return _tree_map(lambda x: put(x, batch_sharding(mesh)), tree)


def replicate(tree, mesh: Mesh):
    """`put` every leaf of a tree whole on every device."""
    return _tree_map(lambda x: put(x, replicated(mesh)), tree)


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "dpst_ambient_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make `mesh` the ambient mesh inside the block (`jax.set_mesh`)."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh() -> Mesh | None:
    """The ambient mesh of `use_mesh`, or None."""
    return _AMBIENT.get()
