"""Autograd's backward (`dpst::backward`: the gradient of the total with
respect to the image, block12's backward, cuDNN's input gradients, the
Gram cotangents): device ms a traced step of the program's span, from its
CUDA events."""
from port_bench.spans import device_ms_per_step


def read(r):
    return device_ms_per_step(r, "backward")
