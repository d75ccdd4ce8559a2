"""BENCHMARK.json against the rules of its format (keys, names, units,
bounds, lengths), and the result line a run prints: its keys, its metrics
and the compared numbers last."""
import json
import re

import pytest

from conftest import ROOT, run_small, small_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["port_bench"]
    assert SPEC["command"][1].startswith("port_bench/")
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["why"]) and line(c["source"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("port_bench/configs/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"gpu_s_per_image", "gpu_s_per_image.batch",
                        "peak_mem_gb", "setup_s"}
    cells = {w["name"] for w in SPEC["workloads"]}
    for cell in cells:
        got = {m["name"].split(".")[0] for m in e2e.values()
               if cell in m.get("workloads", [cell])}
        assert got == {"gpu_s_per_image", "peak_mem_gb", "setup_s"}, cell
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["name"]: m for m in SPEC["per_layer"]}
    for m in layers.values():
        assert m["moves"] in e2e and line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        reader = m["name"].split(".")[0]
        assert (ROOT / "port_bench" / "metrics" / f"{reader}.py").is_file()
        if reader.endswith("_roofline_pct"):
            assert m["unit"] == "%"
    assert layers["block12_roofline_pct"]["workloads"] == [
        "config6.single_4096"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files(cell):
    from port_bench import harness
    c = harness.load_cell(SPEC, cell)
    assert c["config_file"]["reduced"] == []
    assert c["traffic_file"]["trace_from"] % c["traffic_file"][
        "stamp_every"] == 0
    assert c["traffic_file"]["trace_steps"] % c["traffic_file"][
        "stamp_every"] == 0
    assert set(c["check_file"]["limits"]) <= {
        "total_gap", "content_gap", "style_gap", "photoreal_gap",
        "change_gap"}


@pytest.mark.parametrize("cell", ["config3.batch8_512",
                                  "config6.single_4096"])
def test_result_line(cell):
    result = run_small(small_cell(cell))
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "check"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {
        m["name"] for m in SPEC["end_to_end"]
        if cell in m.get("workloads", [cell])}
    assert len(result["metrics"]) == 3
    units = {m["name"]: m["unit"] for m in SPEC["end_to_end"]}
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0 or \
            name == "peak_mem_gb"
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    for n in result["check"].values():
        assert set(n) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("cell", ["config3.batch8_512",
                                  "config6.single_4096"])
def test_traced_result_line_on_the_card(card, cell):
    """A traced run of each cell at 128² in bf16 on the card: the per-layer
    metrics the cell reports, the device's busy and window seconds, the
    breakdown, and `correct`."""
    c = small_cell(cell, size=128, steps=6, dtype="bfloat16")
    result = run_small(c, seconds=1.0, device="cuda", trace=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "check"]
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    reported = {e["name"] for e in SPEC["end_to_end"]
                if cell in e.get("workloads", [cell])}
    want = {m["name"] for m in SPEC["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in reported}
    assert want
    # at 128² no block12 kernel runs: its reader finds nothing
    assert set(result["metrics"]) == want - {"block12_roofline_pct"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in result["metrics"]:
        if m.split(".")[0].endswith("_roofline_pct"):
            assert 0 < result["metrics"][m]["value"] <= 100
