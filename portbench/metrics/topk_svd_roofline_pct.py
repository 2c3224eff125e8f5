"""topk_svd_roofline_pct: the least time of the window's SVDs on the card
(``portbench/work.py`` from the jobs' max_chi: each the larger of its
nominal operations over the float32 peak and its bytes over the memory
rate) over the time of the projected top-k SVD's stages, all five
(``ops.jacobi_svd.CORE_STAGES``, CUDA events; the driver records their
change over each job as ``topk_<stage>_s``).  None without the card's
peaks or the stage times."""

STAGES = ("polar_w", "polar_z", "core", "sweeps", "v_polish")


def read(name, window):
    if window.peak is None:
        return None
    spent = sum(window.total(f"topk_{s}_s") for s in STAGES)
    nominal = window.total("nominal_svd_s")
    if spent <= 0 or nominal <= 0:
        return None
    return 100.0 * nominal / spent
