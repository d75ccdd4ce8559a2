"""The port's weight-bundle registry (`dpst_tpu_torch/utils/assets.py`)
against the JAX package's (`dpst_tpu/utils/assets.py`): the same bundles,
overrides and status under the same environment, and the one place the
port's loaders take their paths from."""
import importlib
import os
import runpy

import numpy as np
import pytest

from dpst_tpu.utils import assets as jassets
from dpst_tpu_torch import semantic_merge
from dpst_tpu_torch.models import nima, pspnet, vgg
from dpst_tpu_torch.utils import assets

ENVS = ["DPST_WEIGHTS_DIR"] + [env for env, _, _ in assets.BUNDLES.values()]


@pytest.fixture
def clean_env(monkeypatch):
    """No override set; the JAX module re-read (it reads its directory
    when imported) under each test's environment, then restored."""
    for env in ENVS:
        monkeypatch.delenv(env, raising=False)
    yield monkeypatch
    monkeypatch.undo()
    importlib.reload(jassets)


def _normalized(status: dict) -> dict:
    return {name: dict(info, path=os.path.normpath(info["path"]))
            for name, info in status.items()}


def test_bundles_are_the_jax_packages():
    assert assets.BUNDLES == jassets.BUNDLES


@pytest.mark.parametrize("case", ["defaults", "directory", "overrides"])
def test_status_equals_the_jax_packages(clean_env, tmp_path, case):
    if case != "defaults":
        clean_env.setenv("DPST_WEIGHTS_DIR", str(tmp_path))
        (tmp_path / "vgg19.npz").write_bytes(b"")
    if case == "overrides":
        nima_file = tmp_path / "elsewhere.npz"
        nima_file.write_bytes(b"")
        clean_env.setenv("DPST_NIMA_WEIGHTS", str(nima_file))
        clean_env.setenv("DPST_PSPNET_WEIGHTS", str(tmp_path / "missing"))
    importlib.reload(jassets)
    got, ref = _normalized(assets.status()), _normalized(jassets.status())
    assert got == ref
    if case == "defaults":
        assert got["vgg19"]["path"] == os.path.normpath(os.path.join(
            os.path.dirname(__file__), "..", "weights", "vgg19.npz"))
    else:
        assert got["vgg19"]["available"]
    if case == "overrides":
        assert got["nima_mobilenet"]["available"]
        assert not got["pspnet50_ade20k"]["available"]


def test_each_override_names_its_file(clean_env, tmp_path):
    for name, (env, _, _) in assets.BUNDLES.items():
        path = tmp_path / f"{name}.bin"
        assert not assets.bundle_available(name)
        clean_env.setenv(env, str(path))
        assert assets.bundle_path(name) == str(path)
        assert not assets.bundle_available(name)
        path.write_bytes(b"")
        assert assets.bundle_available(name)


def test_loaders_read_the_bundle_paths(clean_env, tmp_path):
    """The defaults are where the loaders look: with DPST_WEIGHTS_DIR set,
    each get_params loads the bundle of that name there, and the
    similarity matrix comes from it too."""
    clean_env.setenv("DPST_WEIGHTS_DIR", str(tmp_path))
    seen = []
    for module, name in ((vgg, "vgg19"), (pspnet, "pspnet50_ade20k"),
                         (nima, "nima_mobilenet")):
        (tmp_path / assets.BUNDLES[name][1]).write_bytes(b"")
        clean_env.setattr(module, "load_params",
                          lambda path, device=None: seen.append(path))
        module.get_params()
    assert seen == [str(tmp_path / f) for f in
                    ("vgg19.npz", "pspnet50_ade20k.npz",
                     "nima_mobilenet.npz")]
    sim = np.eye(150, dtype=np.float32)
    sim[3, 4] = sim[4, 3] = 0.5
    np.savez(tmp_path / "similarity_matrix.npz", similarity=sim)
    np.testing.assert_array_equal(semantic_merge._external_matrix(), sim)


@pytest.mark.filterwarnings("ignore:.*found in sys.modules")
def test_status_report_runs_as_a_module(clean_env, capsys):
    runpy.run_module("dpst_tpu_torch.utils.assets", run_name="__main__")
    lines = capsys.readouterr().out.splitlines()
    for name in assets.BUNDLES:
        line = [x for x in lines if x.startswith(name)][0]
        assert assets.bundle_path(name) in line
