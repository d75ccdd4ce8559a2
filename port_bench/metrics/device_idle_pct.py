"""The device: the share of a step in which no kernel or copy runs on the
card, as the traced steps' device-busy seconds a step against the step
time of the window's untraced intervals. The traced span's own idle share
(`busy_s` against `window_s` in the result line) also holds the
profiler's cost on the host, which slows a host-paced step."""


def read(r):
    t = r.window["step_s_untraced"]
    if not t == t:   # NaN: no undisturbed interval
        return None
    return 100.0 * (1.0 - r.span.busy_s() / r.span.steps / t)
