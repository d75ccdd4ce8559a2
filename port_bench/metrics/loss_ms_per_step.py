"""The loss terms (`dpst::loss`: content, masked-Gram style, the matting
Laplacian, tv and the total): device ms a traced step of the program's
span, from its CUDA events."""
from port_bench.spans import device_ms_per_step


def read(r):
    return device_ms_per_step(r, "loss")
