"""The loop layer: device kernels (copies left out) a traced step."""


def read(r):
    return r.span.kernels() / r.span.steps
