"""sweeps_per_call: kernel 1's sweeps over its calls in the window, from
the program's counters (``ops.jacobi_svd.sweep_counter``, the device
count of sweeps, and ``CUDA_SV_CALLS``)."""


def read(name, window):
    calls = window.counters.get("sv_calls", 0)
    if calls <= 0 or "sweeps" not in window.counters:
        return None
    return window.counters["sweeps"] / calls
