"""100 - the device's busy share of the traced sub-window (the union of
its kernels, copies and fills; the slowest rank's where there are
several). The profiler stretches the window, so this reads higher than
the untraced frame is."""


def read(out, cell):
    t = out.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
