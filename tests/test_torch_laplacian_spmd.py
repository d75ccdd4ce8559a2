"""The port's row-sharded Laplacian (`dpst_tpu_torch/ops/laplacian_spmd.py`)
against its unsharded plain matvec and against the JAX package's
`matvec_spmd` on conftest's 8 virtual CPU devices; the port's meshes
repeat the "cpu" device (`make_mesh(devices=["cpu"] * n)`).

Tolerances: sharded ≡ unsharded in the port: bit for bit (every output
value has the same operands in the same order; the halo rows only feed
cropped rows). Against the JAX package's matvec: within 1e-5 of max|y|,
the bound `tests/test_torch_laplacian.py` holds the unsharded matvec to.
The photoreal term and its input gradient through the shards against
`laplacian.photoreal_loss` unsharded: 1e-6 relative (the shards' sums
are reduced in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import dpst_tpu_torch
from dpst_tpu.ops import laplacian as jlap
from dpst_tpu.ops.laplacian_spmd import matvec_spmd as jmatvec_spmd
from dpst_tpu_torch.models import vgg as tvgg
from dpst_tpu_torch.ops import kernels
from dpst_tpu_torch.ops import laplacian as tlap
from dpst_tpu_torch.ops import laplacian_cuda as tlapc
from dpst_tpu_torch.ops import laplacian_spmd as tspmd
from dpst_tpu_torch.parallel import mesh as tmesh
from dpst_tpu_torch.parallel.spatial import make_spatial_mesh

JAX_TOL = 1e-5      # of max|y|
LOSS_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stats_and_v(h, w, c=3, seed=0):
    r = np.random.default_rng(seed)
    img = r.uniform(0, 1, size=(h, w, 3)).astype(np.float32)
    v = r.normal(size=(h, w, c)).astype(np.float32)
    return img, v


def _cpu_mesh(n):
    return make_spatial_mesh(devices=["cpu"] * n)


def _packed(img):
    return tlapc.pack_stats(tlap.precompute_stats(torch.from_numpy(img)))


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's matvec_spmd (XLA stencil on every shard) of the 32 × 24 case
    on row meshes of 1, 2, 4 and 8 virtual devices, computed once."""
    img, v = _stats_and_v(32, 24)
    stats = jlap.precompute_stats(jnp.asarray(img))
    out = {}
    for n in (1, 2, 4, 8):
        mesh = JMesh(np.asarray(jax.devices()[:n]), ("rows",))
        row = lambda nd: NamedSharding(mesh, P(*(("rows",) + (None,) * (nd - 1))))
        stats_s = jlap.LaplacianStats(
            *(jax.device_put(f, row(f.ndim)) for f in stats))
        with jax.set_mesh(mesh):
            out[n] = np.asarray(jmatvec_spmd(
                stats_s, jax.device_put(jnp.asarray(v), row(3)), mesh=mesh,
                use_pallas=False))
    return out


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_matvec_spmd_bit_equal_and_matches_jax(n, jax_ref):
    img, v = _stats_and_v(32, 24)
    packed = _packed(img)
    ref = tlap.matvec(tlap.precompute_stats(torch.from_numpy(img)),
                      torch.from_numpy(v))
    before = dict(kernels.LAUNCHES)
    y = tspmd.matvec_spmd(packed, torch.from_numpy(v), mesh=_cpu_mesh(n))
    assert kernels.LAUNCHES == before        # CPU shards: the plain version
    assert torch.equal(y, ref)
    np.testing.assert_allclose(
        y.numpy(), jax_ref[n], rtol=0,
        atol=JAX_TOL * float(np.abs(jax_ref[n]).max()))


@pytest.mark.parametrize("shape", [(16, 16), (16, 16, 5), (20, 12, 3)])
def test_matvec_spmd_input_layouts(shape):
    """(H, W) and (H, W, C) v, C not a multiple of 3 (the last group of
    planes zero-padded), against the unsharded plain matvec bit for bit
    and JAX's matvec_xla within 1e-5 of max|y|."""
    h, w = shape[:2]
    img, v = _stats_and_v(h, w, shape[2] if len(shape) == 3 else 1, seed=1)
    v = v if len(shape) == 3 else v[..., 0]
    stats = tlap.precompute_stats(torch.from_numpy(img))
    y = tspmd.matvec_spmd(_packed(img), torch.from_numpy(v),
                          mesh=_cpu_mesh(4))
    assert y.shape == shape
    assert torch.equal(y, tlap.matvec(stats, torch.from_numpy(v)))
    ref = np.asarray(jlap.matvec_xla(jlap.precompute_stats(
        jnp.asarray(img)), jnp.asarray(v)))
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=JAX_TOL * float(np.abs(ref).max()))


def test_matvec_spmd_errors():
    img, v = _stats_and_v(8, 16)
    with pytest.raises(ValueError, match="local rows"):
        tspmd.matvec_spmd(_packed(img), torch.from_numpy(v),
                          mesh=_cpu_mesh(8))       # 1 local row < 2
    with pytest.raises(ValueError, match="ambient mesh"):
        tspmd.matvec_spmd(_packed(img), torch.from_numpy(v))
    with pytest.raises(ValueError, match="ambient mesh"):
        # an ambient mesh without a row axis
        with tmesh.use_mesh(tmesh.make_mesh(devices=["cpu"] * 2)):
            tspmd.matvec_spmd(_packed(img), torch.from_numpy(v))
    with tmesh.use_mesh(_cpu_mesh(2)):
        y = tspmd.matvec_spmd(_packed(img), torch.from_numpy(v))
    assert tmesh.current_mesh() is None
    assert torch.equal(y, tlap.matvec(
        tlap.precompute_stats(torch.from_numpy(img)), torch.from_numpy(v)))


def test_exchange_rows():
    """Each shard gains its neighbours' adjacent rows, zero rows at the
    global edges, and the gradient of a halo row reaches the shard it
    came from."""
    x = torch.arange(2 * 12 * 3, dtype=torch.float32).reshape(2, 12, 3)
    shards = [s.clone().requires_grad_(True) for s in x.split(4, dim=1)]
    ext = tspmd.exchange_rows(shards, 2)
    pad = torch.cat([torch.zeros(2, 2, 3), x, torch.zeros(2, 2, 3)], 1)
    for i, e in enumerate(ext):
        assert e.shape == (2, 8, 3) and e.is_contiguous()
        assert torch.equal(e.detach(), pad[:, 4 * i:4 * i + 8])
    g = torch.autograd.grad(ext[1][:, :2].sum(), shards[0])[0]
    assert torch.equal(g[:, 2:], torch.ones(2, 2, 3))
    assert torch.equal(g[:, :2], torch.zeros(2, 2, 3))


def test_ambient_matvec_keeps_stats_shards():
    """`AmbientMatvec` splits and exchanges the stats once for a stats
    tensor (a view of the same memory, as a one-pair loss passes it each
    step, counts as the same), remakes them when the stats change in place
    or the mesh does, and each result is bit-equal to `matvec_spmd`."""
    img, v = _stats_and_v(32, 24, seed=3)
    packed = _packed(img)
    v3 = torch.from_numpy(v).movedim(-1, 0).contiguous()
    real, calls = tspmd.exchange_rows, []

    def spy(shards, halo=tspmd.HALO):
        calls.append(shards[0].shape[-3])
        return real(shards, halo)

    amb = tspmd.AmbientMatvec()
    tspmd.exchange_rows = spy
    try:
        with tmesh.use_mesh(_cpu_mesh(4)):
            ys = [amb(packed, v3), amb(packed[None][0], v3)]
            packed.mul_(1.0)
            ys.append(amb(packed, v3))
        with tmesh.use_mesh(_cpu_mesh(2)):
            ys.append(amb(packed, v3))
    finally:
        tspmd.exchange_rows = real
    # 14 stats planes exchanged on the first call, after the in-place
    # change and on the new mesh; 3 v planes on every call
    assert calls == [14, 3, 3, 14, 3, 14, 3]
    for y, n in zip(ys, (4, 4, 4, 2)):
        ref = tspmd.matvec_spmd(packed, v3.movedim(0, -1),
                                mesh=_cpu_mesh(n)).movedim(-1, 0)
        assert torch.equal(y, ref)


@pytest.mark.parametrize("n", [2, 4])
def test_photoreal_shards_loss_and_grad(n):
    """Σ of the shards' photoreal terms and their input gradient against
    `photoreal_loss` of the whole image (and of a batch of two)."""
    r = np.random.default_rng(2)
    img01 = torch.from_numpy(r.uniform(0, 1, (2, 32, 16, 3)).astype(
        np.float32))
    packed = torch.stack([_packed(im.numpy()) for im in img01])
    img255 = torch.from_numpy(r.uniform(0, 255, (2, 32, 16, 3)).astype(
        np.float32))
    x = img255.clone().requires_grad_(True)
    ref = tlap.photoreal_loss(packed, x)
    (ref_g,) = torch.autograd.grad(ref.sum(), x)
    devs = ["cpu"] * n
    ext = tspmd.exchange_rows(tspmd.split_rows(packed, devs))
    shards = [s.detach().requires_grad_(True)
              for s in img255.split(32 // n, dim=-3)]
    vals = tspmd.photoreal_shards(ext, shards)
    loss = sum(vals)
    g = torch.cat(torch.autograd.grad(loss.sum(), shards), dim=-3)
    np.testing.assert_allclose(loss.detach().numpy(), ref.detach().numpy(),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(g.numpy(), ref_g.numpy(), rtol=0,
                               atol=LOSS_RTOL * float(ref_g.abs().max()))
    # laplacian_impl="spmd"'s matvec under the ambient mesh: the same loss
    with tmesh.use_mesh(_cpu_mesh(n)):
        amb = tlap.photoreal_loss(packed, img255, tspmd.AmbientMatvec())
    assert torch.equal(amb, ref.detach())


def test_photoreal_spmd_matches_jax():
    """`photoreal_loss` with the ambient-mesh matvec against the JAX
    package's photoreal_loss(impl="spmd") on an 8-device mesh: loss and
    gradient."""
    h, w = 32, 16
    r = np.random.default_rng(2)
    img01 = r.uniform(0, 1, size=(h, w, 3)).astype(np.float32)
    img255 = r.uniform(0, 255, size=(h, w, 3)).astype(np.float32)
    stats = jlap.precompute_stats(jnp.asarray(img01))
    mesh = JMesh(np.asarray(jax.devices()[:8]), ("rows",))
    with jax.set_mesh(mesh):
        ref_l, ref_g = jax.value_and_grad(
            lambda x: jlap.photoreal_loss(stats, x, impl="spmd"))(
            jnp.asarray(img255))
    x = torch.from_numpy(img255).requires_grad_(True)
    with tmesh.use_mesh(_cpu_mesh(8)):
        loss = tlap.photoreal_loss(_packed(img01), x, tspmd.AmbientMatvec())
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(float(loss.detach()), float(ref_l),
                               rtol=JAX_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=0,
                               atol=JAX_TOL * float(np.abs(ref_g).max()))


@pytest.fixture(scope="module")
def stylize_pair():
    r = np.random.default_rng(5)
    content = r.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    style = r.uniform(0, 255, (32, 32, 3)).astype(np.float32)
    masks = np.zeros((2, 32, 32), np.float32)
    masks[0, :16] = 1.0
    masks[1, 16:] = 1.0
    return content, style, masks


def test_stylize_spmd_in_use_mesh_equals_xla(stylize_pair):
    """`stylize` with laplacian_impl="spmd" inside `use_mesh` (a 4-row CPU
    mesh) against "xla": bit for bit (the sharded plain matvec is the
    unsharded one's bits); without an ambient mesh it raises the JAX
    package's ValueError."""
    content, style, masks = stylize_pair
    cfg = dpst_tpu_torch.StylizeConfig(compute_dtype="float32",
                                       iterations=3, max_classes=2,
                                       laplacian_impl="xla")
    params = tvgg.init_params(0)
    run = lambda c: dpst_tpu_torch.stylize(
        content, style, c, content_masks=masks, style_masks=masks,
        vgg_params=params, return_history=True, device="cpu")
    ref_img, ref_hist = run(cfg)
    spmd = dataclasses.replace(cfg, laplacian_impl="spmd")
    with tmesh.use_mesh(_cpu_mesh(4)):
        img, hist = run(spmd)
    np.testing.assert_array_equal(hist, ref_hist)
    np.testing.assert_array_equal(img, ref_img)
    with pytest.raises(ValueError, match="ambient mesh"):
        run(spmd)
