"""The port stands alone: it imports no JAX and names nothing of the JAX
package, and its entry points run on the GPU unless told otherwise."""
import ast
import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import dpst_tpu_torch
from dpst_tpu_torch.ops import gram_s2d, kernels

PKG = pathlib.Path(dpst_tpu_torch.__file__).parent


def test_runs_without_jax_in_a_subprocess():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import dpst_tpu_torch
        from dpst_tpu_torch.models import vgg
        img = np.random.default_rng(0).uniform(0, 255, (16, 16, 3))
        cfg = dpst_tpu_torch.StylizeConfig(use_segmentation=False,
                                           compute_dtype="float32",
                                           iterations=2)
        out, hist = dpst_tpu_torch.stylize(
            img.astype(np.float32), img.astype(np.float32), cfg,
            vgg_params=vgg.init_params(0), return_history=True,
            device="cpu")
        assert out.shape == (16, 16, 3) and hist.shape == (2, 5)
        assert np.isfinite(hist).all()
        assert "jax" not in sys.modules, "jax was imported"
        assert not [m for m in sys.modules
                    if m == "dpst_tpu" or m.startswith("dpst_tpu.")]
        print("ok")
    """)
    root = str(PKG.parent)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_automatic_stages_run_without_jax_in_a_subprocess():
    """PSPNet, NIMA, the class merge and autotune import, and a tiny
    stylize with automatic masks runs on the CPU, with no jax loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import dpst_tpu_torch
        import dpst_tpu_torch.autotune
        from dpst_tpu_torch import semantic_merge
        from dpst_tpu_torch.models import nima, pspnet, vgg
        pspnet.EVAL_SIZE = 48
        img = np.random.default_rng(0).uniform(0, 255, (16, 16, 3))
        cfg = dpst_tpu_torch.StylizeConfig(use_segmentation=True,
                                           compute_dtype="float32",
                                           iterations=2, max_classes=4)
        out, hist = dpst_tpu_torch.stylize(
            img.astype(np.float32), img[::-1].astype(np.float32), cfg,
            vgg_params=vgg.init_params(0),
            seg_params=pspnet.init_params(0), return_history=True,
            device="cpu")
        assert out.shape == (16, 16, 3) and hist.shape == (2, 5)
        assert np.isfinite(hist).all()
        assert callable(dpst_tpu_torch.autotune)
        assert semantic_merge.similarity_matrix().shape == (150, 150)
        assert len(nima.SPECS) == 28
        assert "jax" not in sys.modules, "jax was imported"
        assert not [m for m in sys.modules
                    if m == "dpst_tpu" or m.startswith("dpst_tpu.")]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(PKG.parent),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_stylize_batch_runs_without_jax_in_a_subprocess():
    """`stylize_batch` (parallel/batch.py) imports and runs a batch of two
    on the CPU with no jax loaded, and the parallel package names nothing
    of the JAX package."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import dpst_tpu_torch
        from dpst_tpu_torch.models import vgg
        r = np.random.default_rng(0)
        imgs = r.uniform(0, 255, (2, 16, 16, 3)).astype(np.float32)
        masks = np.ones((2, 1, 16, 16), np.float32)
        cfg = dpst_tpu_torch.StylizeConfig(compute_dtype="float32",
                                           iterations=2, max_classes=1)
        out, hist = dpst_tpu_torch.stylize_batch(
            imgs, imgs[:, ::-1].copy(), masks, masks, cfg,
            vgg_params=vgg.init_params(0), device="cpu")
        assert out.shape == (2, 16, 16, 3) and hist.shape == (2, 2, 5)
        assert np.isfinite(hist).all()
        assert "jax" not in sys.modules, "jax was imported"
        assert not [m for m in sys.modules
                    if m == "dpst_tpu" or m.startswith("dpst_tpu.")]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(PKG.parent),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_only_the_multi_gpu_laplacian_is_unported():
    """Nothing is left unported on the stylize path: every preset runs a
    step on the CPU (16², masks given), as do L-BFGS, the Laplacian
    options, post-smoothing and debug_nans; laplacian_impl="spmd" runs
    inside an ambient mesh and raises the JAX package's ValueError outside
    one."""
    from dpst_tpu_torch.models import vgg
    from dpst_tpu_torch.parallel import mesh as tmesh
    img = np.random.default_rng(0).uniform(0, 255, (16, 16, 3)).astype(
        np.float32)
    masks = np.ones((1, 16, 16), np.float32)
    params = vgg.init_params(0)
    run = lambda cfg: dpst_tpu_torch.stylize(
        img, img[::-1].copy(), dataclasses.replace(cfg, iterations=1),
        content_masks=masks, style_masks=masks, vgg_params=params,
        device="cpu")
    for cfg in dpst_tpu_torch.PRESETS.values():
        assert np.isfinite(run(cfg)).all()
    for kw in ({"optimizer": "lbfgs"}, {"laplacian_impl": "pallas"},
               {"laplacian_impl": "xla"},
               {"post_smooth": 2, "debug_nans": True}):
        assert np.isfinite(run(dpst_tpu_torch.StylizeConfig(**kw))).all()
    spmd = dpst_tpu_torch.StylizeConfig(laplacian_impl="spmd")
    with tmesh.use_mesh(tmesh.Mesh(["cpu"] * 2, (tmesh.ROW_AXIS,))):
        assert np.isfinite(run(spmd)).all()
    with pytest.raises(ValueError, match="ambient mesh"):
        run(spmd)


def test_mesh_runs_without_jax_in_a_subprocess():
    """`stylize_spatial`, `matvec_spmd` and `stylize_batch` over a mesh of
    repeated CPU devices import and run with no jax loaded, and the mesh
    modules are among those `test_source_names_no_jax_package` reads."""
    for name in ("parallel/mesh.py", "parallel/spatial.py",
                 "ops/laplacian_spmd.py"):
        assert (PKG / name).exists()
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import dpst_tpu_torch
        from dpst_tpu_torch.models import vgg
        from dpst_tpu_torch.ops import laplacian as lap
        from dpst_tpu_torch.ops import laplacian_cuda as lapc
        from dpst_tpu_torch.ops.laplacian_spmd import matvec_spmd
        from dpst_tpu_torch.parallel import mesh
        from dpst_tpu_torch.parallel.spatial import (make_spatial_mesh,
                                                     stylize_spatial)
        r = np.random.default_rng(0)
        img = r.uniform(0, 255, (16, 16, 3)).astype(np.float32)
        masks = np.ones((1, 16, 16), np.float32)
        cfg = dpst_tpu_torch.StylizeConfig(compute_dtype="float32",
                                           iterations=2, max_classes=1)
        out, hist = stylize_spatial(img, img[::-1].copy(), masks, masks,
                                    cfg, vgg.init_params(0),
                                    make_spatial_mesh(devices=["cpu"] * 4))
        assert out.shape == (16, 16, 3) and hist.shape == (2, 5)
        packed = lapc.pack_stats(lap.precompute_stats(
            torch.from_numpy(img / 255)))
        v = torch.from_numpy(img)
        y = matvec_spmd(packed, v, mesh=make_spatial_mesh(devices=["cpu"] * 2))
        assert torch.equal(y, lap.matvec(lapc.unpack_stats(packed), v))
        out, hist = dpst_tpu_torch.stylize_batch(
            np.stack([img] * 2), np.stack([img] * 2), masks[None].repeat(2, 0),
            masks[None].repeat(2, 0), cfg, vgg_params=vgg.init_params(0),
            mesh=mesh.make_mesh_2d(2, 2, devices=["cpu"] * 4))
        assert out.shape == (2, 16, 16, 3) and np.isfinite(hist).all()
        assert "jax" not in sys.modules, "jax was imported"
        assert not [m for m in sys.modules
                    if m == "dpst_tpu" or m.startswith("dpst_tpu.")]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(PKG.parent),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _imported_modules(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_names_no_jax_package(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "dpst_tpu", "optax", "flax"), (
            f"{path.name} imports {name}")


def test_every_module_of_the_jax_package_has_a_counterpart():
    """The port covers the JAX package file for file: each `*.py` of
    dpst_tpu/ has one of the same path in dpst_tpu_torch/, a Pallas file
    (`*_pallas.py`) one of its path or its `*_cuda.py`."""
    ref = PKG.parent / "dpst_tpu"
    missing = []
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref)
        names = [rel]
        if rel.stem.endswith("_pallas"):
            names.append(rel.with_name(rel.stem[:-len("_pallas")] + "_cuda.py"))
        if not any((PKG / n).exists() for n in names):
            missing.append(str(rel))
    assert missing == []


def test_stylize_without_cuda_and_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        dpst_tpu_torch.stylize(img, img)


def test_kernel_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    quietly computed on another device."""
    with pytest.raises(ValueError):
        kernels.on_cuda(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        kernels.on_cuda(torch.zeros(2), torch.zeros(2, device="meta"))
    assert kernels.on_cuda(torch.zeros(2)) is False
    # the fused bias+ReLU Gram wrappers refuse them too
    for dev_b in ("meta", "cpu"):
        z, m2 = torch.zeros(4, 8, device="meta"), torch.zeros(2, 8)
        b, s = torch.zeros(4, device=dev_b), torch.zeros(2, 4, 4)
        before = dict(kernels.LAUNCHES)
        with pytest.raises(ValueError):
            gram_s2d.gram_relu_fwd(z, b, m2)
        with pytest.raises(ValueError):
            gram_s2d.gram_relu_bwd(z, b, m2, s)
        assert kernels.LAUNCHES == before


def test_build_hash_covers_sources():
    srcs = {p.name for p in kernels._sources()}
    assert srcs == {"bias_relu.cu", "block12.cu", "conv3x3.cu",
                    "conv3x3_wide.cu", "conv3x3_pairs.cu",
                    "conv3x3_pairs_wide.cu", "gram.cu", "gram_pc.cu",
                    "gram_pc_wbwd.cu", "gram_relu_bwd.cu",
                    "gram_wbwd_pairs.cu", "lap_matvec.cu", "pool_bwd.cu",
                    "pool_bwd_nhwc.cu"}
    headers = {p.name for p in kernels.CSRC.glob("*.cuh")}
    assert headers == {"conv3x3_tile.cuh", "conv3x3_wgmma.cuh",
                       "dpst_common.cuh", "gram_tile.cuh", "gram_wgmma.cuh",
                       "hopper.cuh"}
    assert len(kernels._digest()) == 16
    assert set(kernels.LAUNCHES) == set(kernels.KERNELS)
