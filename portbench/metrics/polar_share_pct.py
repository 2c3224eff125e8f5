"""polar_share_pct: the share of the projected top-k SVD's time outside its
core's sweep loop (the two polar factors, the core product, V and its
polish), 100 (1 - sweeps / all), from the stage times
(``ops.jacobi_svd.CORE_STAGES``, CUDA events) whose change over each job
the driver records as ``topk_<stage>_s``; the window's jobs summed.  None
when the program records no stage times."""

STAGES = ("polar_w", "polar_z", "core", "sweeps", "v_polish")


def read(name, window):
    total = sum(window.total(f"topk_{s}_s") for s in STAGES)
    if total <= 0:
        return None
    return 100.0 * (1.0 - window.total("topk_sweeps_s") / total)
