"""The host's issue of a step: ms a traced step of the program's
`dpst::step` ranges on the profiler's clock, the Python and launches of the
loss, the gradient and the update. The profiler's own cost is in it."""
from port_bench.spans import host_ms_per_step


def read(r):
    return host_ms_per_step(r, "step")
