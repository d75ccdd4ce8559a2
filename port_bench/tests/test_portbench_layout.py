"""What the harness finds by name, what it loads, and when it refuses:
a cell, a configuration, a traffic mix and a per-layer metric added as
files and entries alone; no module of JAX or the JAX package after a run;
a reference that imports nothing of the program; no result without a card
or without the program."""
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
    for path in (BENCH / "reference").glob("*.py"):
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
        import sys
        import port_bench.reference.objective
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
