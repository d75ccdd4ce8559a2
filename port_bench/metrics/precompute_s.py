"""The request layer: the mean synchronized precompute seconds of the
requests begun in the traced run's window (host clock)."""


def read(r):
    return r.window["precompute_s"]
