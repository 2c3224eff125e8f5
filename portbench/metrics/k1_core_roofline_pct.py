"""k1_core_roofline_pct: the least time of kernel 1's sweeps on the
projected top-k SVD's cores in the window (``portbench/core_work.py``:
the larger of their operations over the float32 peak and their bytes over
the memory rate; the driver records each job's ``k1_core_ops`` and
``k1_core_bytes`` from the change of the program's ``sweep_counter``) over
the device time of kernel 1, the kernels named ``jacobi_sv_*``.  None
without the card's peaks, the device trace or the sweep count."""

KERNEL = "jacobi_sv_"


def read(name, window):
    if window.peak is None or not window.trace:
        return None
    busy = sum(s for k, s in window.trace["kernel_s"].items() if KERNEL in k)
    ops, nbytes = window.total("k1_core_ops"), window.total("k1_core_bytes")
    if busy <= 0 or ops <= 0:
        return None
    least = max(ops / window.peak["float32_flops"],
                nbytes / window.peak["memory_bytes_per_s"])
    return 100.0 * least / busy
