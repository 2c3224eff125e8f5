"""k1_roofline_pct: the least time of the window's SVDs on the card (each
the larger of its nominal operations over the float32 peak and its bytes
over the memory rate, ``portbench/work.py``) over the device time of
kernel 1, the kernels named ``jacobi_sv_*``."""

KERNEL = "jacobi_sv_"


def read(name, window):
    if window.peak is None or not window.trace:
        return None
    busy = sum(s for k, s in window.trace["kernel_s"].items() if KERNEL in k)
    nominal = window.total("nominal_svd_s")
    if busy <= 0 or nominal <= 0:
        return None
    return 100.0 * nominal / busy
