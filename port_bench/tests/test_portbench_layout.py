"""What the harness finds by name, what it loads, and when it refuses:
a cell, a configuration, a traffic mix and a per-layer metric added as
files and entries alone, and so a configuration's own reference module
and a traffic that leaves the masks to the program; no module of JAX or
the JAX package after a run; references that import nothing of the
program; no result without a card or without the program."""
import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

from conftest import ROOT

BENCH = ROOT / "port_bench"


def copy_bench(tmp_path):
    """BENCHMARK.json and port_bench/ copied into tmp_path, without
    caches."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def run_python(code: str, cwd, extra_path=()) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(cwd), *map(str, extra_path)]))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_new_cell_config_traffic_and_metric_are_found(tmp_path):
    root = copy_bench(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "config3.json").read_text())
    config["name"] = "dummy"
    config["stylize"]["iterations"] = 4
    config["stylize"]["compute_dtype"] = "float32"
    (root / "port_bench/configs/dummy.json").write_text(json.dumps(config))
    traffic = json.loads((BENCH / "traffic/batch8_512.json").read_text())
    traffic.update(pairs_per_request=2, size=32, stamp_every=2,
                   trace_from=2, trace_steps=2)
    (root / "port_bench/traffic/tiny.json").write_text(json.dumps(traffic))
    (root / "port_bench/checks/dummy.tiny.json").write_text(json.dumps(
        {"block_rows": 32, "halo": 0,
         "limits": {"total_gap": 1e-3}}))
    (root / "port_bench/metrics/dummy_pairs.py").write_text(
        "def read(r):\n    return float(r.pairs)\n")
    spec["configs"].append({"name": "dummy", "source": "https://example.org",
                            "file": "port_bench/configs/dummy.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy.tiny", "config": "dummy",
                              "traffic": "tiny", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "gpu_s_per_image":
            m["workloads"].append("dummy.tiny")
    spec["per_layer"].append({"name": "dummy_pairs", "unit": "pairs",
                              "better": "higher", "source": "host_clock",
                              "layer": "request", "moves": "gpu_s_per_image",
                              "workloads": ["dummy.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    proc = run_python("""
        import json, time
        from pathlib import Path
        from port_bench import harness, trace
        spec = harness.load_spec(Path("."))
        cell = harness.load_cell(spec, "dummy.tiny")
        res = harness.run(cell, 5, 2.0, False, time.perf_counter(), "cpu",
                          spec)
        span = trace.Span(steps=1, start_us=0.0, end_us=1.0,
                          device=[("k", 0.0, 1.0)])
        layer = harness.layer_metrics(spec, cell, cell["config_file"],
                                      cell["traffic_file"],
                                      harness.resolve(cell)[1], span,
                                      {"precompute_s": 1.0,
                                       "step_s_untraced": 0.01})
        print(json.dumps({"result": res, "layer": layer}))
    """, root, [ROOT])
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["result"]["correct"] is True
    assert out["result"]["check"]["total_gap"]["limit"] == 1e-3
    assert out["layer"]["dummy_pairs"] == {"value": 2.0, "unit": "pairs"}
    assert set(out["result"]["metrics"]) == {"gpu_s_per_image",
                                             "peak_mem_gb", "setup_s"}
    # the other cells' metrics that list their workloads stay out
    assert "block12_roofline_pct" not in out["layer"]


# A reference module of a configuration of its own: the objective over one
# uniform class, which is what the program makes where it gets no masks
# and does not segment; it refuses pairs that carry masks.
UNIFORM_REFERENCE = """
import numpy as np

from port_bench.inputs import Pair
from port_bench.reference import objective


def reference_run(config, params, pairs, steps, prec, rows, halo, device):
    assert all(p.content_masks is None and p.style_masks is None
               for p in pairs), "the traffic handed over masks"
    one = [Pair(p.content, p.style,
                np.ones((1, *p.content.shape[:2]), np.float32),
                np.ones((1, *p.style.shape[:2]), np.float32))
           for p in pairs]
    return objective.reference_run(config, params, one, steps, prec, rows,
                                   halo, device)
"""


def test_new_reference_module_and_program_masks_are_found(tmp_path):
    """A configuration that names a reference module of its own and a
    traffic with `"masks": "program"`, added as files and entries alone:
    the program gets no masks, makes its own, and is held to that module,
    which is what the check and the readings reach."""
    root = copy_bench(tmp_path)
    existing = {p.relative_to(root): p.read_bytes()
                for p in (root / "port_bench").rglob("*") if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "config6.json").read_text())
    config.update(name="uniform", reference="uniform_ref")
    config["stylize"].update(iterations=4, compute_dtype="float32",
                             use_segmentation=False)
    (root / "port_bench/configs/uniform.json").write_text(json.dumps(config))
    (root / "port_bench/reference/uniform_ref.py").write_text(
        UNIFORM_REFERENCE)
    traffic = json.loads((BENCH / "traffic/single_4096.json").read_text())
    traffic.update(size=32, masks="program", stamp_every=2, trace_from=2,
                   trace_steps=2)
    (root / "port_bench/traffic/own_masks.json").write_text(
        json.dumps(traffic))
    (root / "port_bench/checks/uniform.own_masks.json").write_text(
        json.dumps({"block_rows": 32, "halo": 0,
                    "limits": {"total_gap": 1e-4, "style_gap": 1e-4,
                               "change_gap": 1e-2}}))
    spec["configs"].append({"name": "uniform", "source": "https://example.org",
                            "file": "port_bench/configs/uniform.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "uniform.own_masks",
                              "config": "uniform", "traffic": "own_masks",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "gpu_s_per_image":
            m["workloads"].append("uniform.own_masks")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    proc = run_python("""
        import json, time
        from pathlib import Path
        import torch
        from port_bench import check, harness, inputs
        spec = harness.load_spec(Path("."))
        cell = harness.load_cell(spec, "uniform.own_masks")
        res = harness.run(cell, 2 ** 31 + 5, 2.0, False, time.perf_counter(),
                          "cpu", spec)
        params, pool, _ = harness.draw(cell, 2 ** 31 + 5,
                                       torch.device("cpu"))
        pairs = inputs.request_pairs(pool, 1, 0)
        control = check.reference(cell["config_file"], params, pairs, 2,
                                  cell["check_file"], "fp8", "cpu")
        fp8 = harness.judge(cell, params, pool, control, "cpu")
        print(json.dumps({"result": res, "masks": [p.content_masks is None
                                                   for p in pool],
                          "control": check.correct(fp8)}))
    """, root, [ROOT])
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["masks"] == [True, True]
    assert out["result"]["correct"] is True, out["result"]["check"]
    assert out["result"]["check"]["total_gap"]["value"] < 1e-4
    assert out["control"] is False
    # nothing that was there before was touched
    for rel, data in existing.items():
        assert (root / rel).read_bytes() == data, rel


def test_no_jax_after_a_run():
    proc = run_python("""
        import sys, time
        from pathlib import Path
        sys.path.insert(0, str(Path.cwd() / "port_bench" / "tests"))
        from conftest import run_small, small_cell
        from port_bench import harness
        run_small(small_cell("config6.single_4096", steps=2))
        found = harness.forbidden_modules()
        print("FOUND", found, "PORT", "dpst_tpu_torch" in sys.modules)
    """, ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FOUND [] PORT True" in proc.stdout


def test_forbidden_names_compare_whole_top_level_names():
    from port_bench import harness
    sys.modules["dpst_tpu_torch_like"] = sys
    try:
        assert "dpst_tpu_torch_like" not in harness.forbidden_modules()
    finally:
        del sys.modules["dpst_tpu_torch_like"]


def test_reference_imports_nothing_of_the_program():
    """Every module under reference/, by its source and by what importing
    it loads."""
    modules = sorted((BENCH / "reference").glob("*.py"))
    assert {p.stem for p in modules} >= {"__init__", "objective"}
    for path in modules:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "dpst_tpu_torch", "dpst_tpu", "jax"), (path, name)
    proc = run_python("""
        import importlib, pkgutil, sys
        import port_bench.reference as ref
        for m in pkgutil.iter_modules(ref.__path__):
            importlib.import_module(f"port_bench.reference.{m.name}")
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("dpst_tpu_torch", "dpst_tpu",
                                            "jax")))
    """, ROOT)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]"


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """run.py on this CPU-only machine exits non-zero and prints nothing;
    so does it in a directory with only BENCHMARK.json and port_bench/."""
    args = [sys.executable, "port_bench/run.py", "--workload",
            "config3.batch8_512", "--seed", "1", "--seconds", "1",
            "--trace", "0"]
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                          env=env, timeout=300)
    if proc.returncode == 0:   # a machine with a card: nothing to show
        return
    assert proc.stdout == ""
    root = copy_bench(tmp_path)
    proc = subprocess.run(args, cwd=root, capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
