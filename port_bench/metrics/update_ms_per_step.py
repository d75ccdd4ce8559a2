"""The Adam update (`dpst::update`: the moments, the bias-corrected step,
the clip, the history row): device ms a traced step of the program's
span, from its CUDA events."""
from port_bench.spans import device_ms_per_step


def read(r):
    return device_ms_per_step(r, "update")
