"""core_sweeps_per_call: the sweeps kernel 1 ran on the projected top-k
SVD's k x k cores over that SVD's calls, in the window's jobs (the change
over each job of the program's ``ops.jacobi_svd.sweep_counter``, which the
driver records on a card as ``topk_core_sweeps``, and of
``CORE_SVD_CALLS``, recorded as ``topk_calls``).  None when the program
counts neither, or without a card (the CPU's twin counts no sweeps)."""


def read(name, window):
    calls = window.total("topk_calls")
    sweeps = window.total("topk_core_sweeps")
    if calls <= 0 or sweeps <= 0:
        return None
    return sweeps / calls
