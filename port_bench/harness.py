"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one cell is found by name from
`BENCHMARK.json`: the configuration (`configs/<config>.json`), the traffic
mix (`traffic/<traffic>.json`, which names its entry in `entries/`), the
check's settings and limits (`checks/<cell>.json`) and each per-layer
metric's reader (`metrics/<metric>.py`).

Set-up (`setup_s`): from the process's start, less the seconds spent
drawing the requests' inputs, to the window's start. It imports the
program and loads its kernels (building them on a checkout's first run),
draws the weights on the device, and warms the cell's shapes with one
short request of `stamp_every` steps through the same entry.

The window: requests back to back from one caller, each the preset's
steps on the next pairs of the pool, stamped by a sync every `stamp_every`
steps; at the first stamp past `--seconds` the request is cut and the
window closes. The first request, which the check compares at its first
stamp (`check.py`), is not cut before it. With `--trace 1` torch.profiler
covers steps `trace_from` to `trace_from + trace_steps` of the first
request.

`gpu_s_per_image` = (P̄ + N·T̄) / B: P̄ the mean precompute seconds of the
requests begun, T̄ all the loop's seconds over all its steps, N the
preset's steps a request, B the pairs a request takes.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from port_bench import check as check_mod
from port_bench import inputs
from port_bench.entries import Request

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dpst_tpu")


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(spec: dict, name: str, bench_dir: Path = HERE) -> dict:
    """The cell `name` with its configuration, traffic and check files."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = dict(cells[name])
    cell["config_file"] = json.loads(
        (bench_dir / "configs" / f"{cell['config']}.json").read_text())
    cell["traffic_file"] = json.loads(
        (bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    cell["check_file"] = json.loads(
        (bench_dir / "checks" / f"{name}.json").read_text())
    return cell


def stylize_config(config: dict):
    """The program's `StylizeConfig` of a configuration file."""
    from dpst_tpu_torch import StylizeConfig
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in config["stylize"].items()}
    return StylizeConfig(**fields)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    cfg: object
    params: dict
    device: torch.device
    traffic: str          # the traffic mix's name, for the entries' errors


def _sync(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def window_metrics(requests: list, pairs: int, steps: int) -> dict:
    """P̄, T̄, gpu_s_per_image and the step time of the undisturbed
    intervals, from the requests' stamps."""
    loop = [iv for r in requests for iv in r.intervals()]
    n = sum(s for s, _, _ in loop)
    t_step = sum(t for _, t, _ in loop) / n if n else math.nan
    clean = [(s, t) for s, t, d in loop if not d]
    n_clean = sum(s for s, _ in clean)
    t_clean = sum(t for _, t in clean) / n_clean if n_clean else math.nan
    # a precompute inside the call is the time to the first stamp less
    # that stamp's steps at the undisturbed step time
    t_pre = t_clean if n_clean else t_step
    pre = []
    for r in requests:
        if not r.stamps:
            continue
        s1, t1 = r.stamps[0]
        pre.append(t1 - r.t0 - s1 * t_pre if r.precompute_inside
                   else t1 - r.t0)
    p_mean = float(np.mean(pre)) if pre else math.nan
    return {"precompute_s": p_mean, "step_s": t_step,
            "step_s_untraced": t_clean, "steps": n,
            "gpu_s_per_image": (p_mean + steps * t_step) / pairs}


def resolve(cell: dict):
    """(the cell's entry module, the config it runs under)."""
    entry = importlib.import_module(
        f"port_bench.entries.{cell['traffic_file']['entry']}")
    return entry, entry.resolve(stylize_config(cell["config_file"]))


def draw(cell: dict, seed: int, dev: torch.device):
    """(weights, the pool of pairs, seconds spent drawing the pool) of a
    run with `seed`: one generator on the device, weights first."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = inputs.vgg_weights(cell["config_file"]["vgg19_blocks"], gen,
                                dev)
    t_in = time.perf_counter()
    pool = inputs.make_pairs(cell["traffic_file"], gen, dev)
    return params, pool, time.perf_counter() - t_in


def request(cell: dict, ctx: Context, entry, pool: list, index: int,
            deadline: float, tracer=None) -> Request:
    """The window's request `index` on its pairs of the pool, cut at the
    first stamp past `deadline`; request 0 is the compared one, and the
    traced one where a `tracer` is given."""
    traffic = cell["traffic_file"]
    b = traffic["pairs_per_request"]
    r = Request(ctx.cfg.iterations, traffic["stamp_every"], _sync(ctx.device),
                deadline, compared=index == 0, tracer=tracer,
                trace_from=traffic["trace_from"],
                trace_steps=traffic["trace_steps"])
    entry.run_request(ctx, inputs.request_pairs(pool, b, index), r)
    return r


def outcome(r: Request, pairs: int):
    """(rows (B, steps, 5), images (B, H, W, 3)) in float64 that a
    compared request kept at its first stamp, or None."""
    if r.image is None:
        return None
    return (r.rows.double().numpy().reshape(pairs, -1, 5),
            r.image.double().numpy().reshape(pairs, *r.image.shape[-3:]))


def judge(cell: dict, params: dict, pool: list, got, device) -> dict:
    """The check's numbers beside their limits: `got` (`outcome`'s) of
    request 0 against the plain reference on its pairs."""
    b = cell["traffic_file"]["pairs_per_request"]
    pairs = inputs.request_pairs(pool, b, 0)
    ref = check_mod.reference(cell["config_file"], params, pairs,
                              cell["traffic_file"]["stamp_every"],
                              cell["check_file"], "float32", device)
    contents = np.stack([np.asarray(p[0], np.float64) for p in pairs])
    return check_mod.compare(got, ref, contents, cell["check_file"])


def run(cell: dict, seed: int, seconds: float, trace: bool,
        t_process: float, device: str | torch.device, spec: dict) -> dict:
    """One run of `cell` (`load_cell`'s) of `spec`; returns the result
    line's object. `t_process` is the process's start on
    `time.perf_counter`."""
    dev = torch.device(device)
    sync = _sync(dev)
    config, traffic = cell["config_file"], cell["traffic_file"]
    entry, cfg = resolve(cell)
    steps = cfg.iterations
    b = traffic["pairs_per_request"]
    every = traffic["stamp_every"]
    params, pool, input_s = draw(cell, seed, dev)
    ctx = Context(cfg, params, dev, cell["traffic"])

    slices = len(pool) // b
    warm = Request(every, every, sync)
    entry.run_request(ctx, inputs.request_pairs(pool, b, slices - 1), warm)
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_process - input_s

    tracer = None
    if trace:
        from port_bench.trace import Tracer
        tracer = Tracer()
    deadline = t_w0 + seconds
    requests = []
    while True:
        r = request(cell, ctx, entry, pool, len(requests), deadline,
                    tracer if not requests else None)
        requests.append(r)
        if r.cut or time.perf_counter() >= deadline:
            break
    sync()
    window_s = time.perf_counter() - t_w0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    wm = window_metrics(requests, b, steps)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    breakdown = None
    if trace:
        if requests[0].traced is None:
            raise RuntimeError(
                f"the first request did not reach step "
                f"{traffic['trace_from'] + traffic['trace_steps']} to "
                "close the traced span")
        span = tracer.span()
        metrics = layer_metrics(spec, cell, config, traffic, cfg, span, wm)
        device_extra = {"busy_s": span.busy_s(), "window_s": span.window_s}
        breakdown = {"device_ops": span.top_device_ops(),
                     "idle_gaps": span.top_idle_gaps()}
        print("port_bench: device ms a step by group "
              + json.dumps(span.groups_ms()), file=sys.stderr, flush=True)
    else:
        values = {"gpu_s_per_image": wm["gpu_s_per_image"],
                  "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[base(m["name"])],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"] if reports(m, cell)}
        device_extra = {}
    print(f"port_bench: {cell['name']} seed {seed}: {len(requests)} "
          f"requests, {wm['steps']} steps in {window_s:.3f} s, "
          f"precompute {wm['precompute_s']:.4f} s, step "
          f"{wm['step_s'] * 1e3:.3f} ms, set-up {setup_s:.3f} s "
          f"(inputs {input_s:.3f} s)", file=sys.stderr, flush=True)
    print("port_bench: ms a step between stamps "
          + " ".join(f"{t / n * 1e3:.3f}" for r in requests
                     for n, t, _ in r.intervals()), file=sys.stderr,
          flush=True)

    numbers = judge(cell, params, pool, outcome(requests[0], b), dev)
    correct = check_mod.correct(numbers)
    result = {
        "correct": correct,
        "attempted": len(requests),
        "failed": 0 if correct else 1,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak),
                   **device_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = numbers
    return result


def base(name: str) -> str:
    """What a metric's name measures: the part before its first dot. A
    quantity split by the end-to-end metric it moves (`mfu_pct.batch`)
    keeps one reader, `metrics/mfu_pct.py`."""
    return name.split(".")[0]


def reports(metric: dict, cell: dict) -> bool:
    return cell["name"] in metric.get("workloads", [cell["name"]])


def layer_metrics(spec: dict, cell: dict, config: dict,
                  traffic: dict, cfg, span, wm: dict) -> dict:
    """Each per-layer metric of `spec` that this cell reports, from its
    reader `metrics/<base name>.py`; a reader that finds nothing is left
    out."""
    from port_bench.metrics import Reading
    reading = Reading(cell=cell, config=config, traffic=traffic, cfg=cfg,
                      span=span, window=wm)
    reported = {m["name"] for m in spec["end_to_end"] if reports(m, cell)}
    out = {}
    for m in spec["per_layer"]:
        if m["moves"] not in reported or not reports(m, cell):
            continue
        reader = importlib.import_module(
            f"port_bench.metrics.{base(m['name'])}")
        value = reader.read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
