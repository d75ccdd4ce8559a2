"""The glue layer: device ms a step of ATen's elementwise ops, reductions
and copies (`trace.kernel_group`'s "other")."""
from port_bench.trace import OTHER


def read(r):
    ms = r.span.groups_ms().get(OTHER)
    return ms if ms else None
