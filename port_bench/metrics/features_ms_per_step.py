"""The VGG forward to the deepest tap (`dpst::features`: blocks 1-2 on
the block12 kernels where they stream, cuDNN's convs, the fused Gram taps):
device ms a traced step of the program's span, from its CUDA events. The
four stage spans tile a step on the device timeline, each with the idle
time inside it."""
from port_bench.spans import device_ms_per_step


def read(r):
    return device_ms_per_step(r, "features")
