"""The readings that a cell's limits are set from, on the cell's own
sizes: for each seed, the program's request 0 through the window's own
path (`harness.request`), cut at its first stamp, and its gaps against the
plain reference's; with `--control` the control's gaps (the reference in
fp8 in the program's place); with `--fault` the gaps of the program under
each planted fault (`faults.py`). One process for all seeds, so that
set-up is paid once. Prints one JSON line a seed and reading.

    python3 port_bench/readings.py --workload <cell> --seeds 1 2 3 \
        [--control] [--fault unchanged half_batch altered]
"""
import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", nargs="*", default=[])
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from port_bench import check, faults, harness, inputs

    spec = harness.load_spec(ROOT)
    cell = harness.load_cell(spec, args.workload)
    dev = torch.device("cuda")
    entry, cfg = harness.resolve(cell)
    b = cell["traffic_file"]["pairs_per_request"]
    steps = cell["traffic_file"]["stamp_every"]
    for seed in args.seeds:
        params, pool, _ = harness.draw(cell, seed, dev)
        ctx = harness.Context(cfg, params, dev)
        got = {}
        for name in ["program", *args.fault]:
            with (faults.FAULTS[name]() if name != "program"
                  else contextlib.nullcontext()):
                r = harness.request(cell, ctx, entry, pool, 0, -math.inf)
            got[name] = harness.outcome(r, b)
        torch.cuda.empty_cache()
        pairs = inputs.request_pairs(pool, b, 0)
        contents = np.stack([np.asarray(p[0], np.float64) for p in pairs])
        t0 = time.perf_counter()
        ref = check.reference(cell["config_file"], params, pairs, steps,
                              cell["check_file"], "float32", dev)
        ref_s = time.perf_counter() - t0
        if args.control:
            got["control"] = check.reference(cell["config_file"], params,
                                             pairs, steps,
                                             cell["check_file"], "fp8", dev)
        for what, out in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": what,
                              "gaps": check.gaps(out, ref, contents),
                              "reference_s": ref_s}), flush=True)
        del params, pool, ctx, got, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
