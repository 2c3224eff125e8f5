"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on the card (the profiler's CUDA activity)."""


def read(name, window):
    t = window.trace
    if not t or t.get("window_s", 0) <= 0 or t.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
