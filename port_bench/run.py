"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for. Prints the run's result as one JSON object on the last line of
standard output, and the compared numbers beside their limits as the last
lines of standard error. Exits with another code than 0, and prints no
result, where there is no CUDA card (or fewer than the cell asks for),
where the program is missing, or where JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench import check, harness

    spec = harness.load_spec(ROOT)
    cell = harness.load_cell(spec, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         T_PROCESS, "cuda", spec)
    found = harness.forbidden_modules()
    if found:
        print("port_bench: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print(check.report(result["check"]), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
