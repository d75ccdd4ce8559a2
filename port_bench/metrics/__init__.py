"""Per-layer metrics: one reader a metric, `metrics/<name>.py`, whose
`read(reading)` returns the metric's value from the traced span and the
window's stamps, or None where it finds nothing to read (the harness then
leaves the metric out)."""
from __future__ import annotations

from dataclasses import dataclass

from port_bench.trace import Span


@dataclass
class Reading:
    cell: dict        # the BENCHMARK.json entry, with its files
    config: dict      # configs/<config>.json
    traffic: dict     # traffic/<traffic>.json
    cfg: object       # the program's resolved StylizeConfig
    span: Span        # the traced steps
    window: dict      # harness.window_metrics of the run

    @property
    def pairs(self) -> int:
        return self.traffic["pairs_per_request"]

    @property
    def hw(self) -> tuple[int, int]:
        return self.traffic["size"], self.traffic["size"]

    @property
    def dtype(self) -> str:
        return self.cfg.compute_dtype

    def group_ms(self, prefix: str) -> float:
        """Device ms a step of the kernel groups whose names start with
        `prefix`."""
        return sum(v for k, v in self.span.groups_ms().items()
                   if k.startswith(prefix))

    @property
    def block12_ran(self) -> bool:
        """Did blocks 1-2 run on the block12 kernels in the traced steps?"""
        return self.group_ms("block12_") > 0
