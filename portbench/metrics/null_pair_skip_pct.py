"""null_pair_skip_pct: the share of kernel 1's scheduled pair-steps that its
shared-memory variant skipped because a row of the pair was an exact zero
(the padded MPS's discarded bond), 100 (1 - live / scheduled), from the
program's device counter ``ops.jacobi_svd.pair_step_counter``: [live,
scheduled] pair-steps.  The counter sums the whole run, its warm-up with
the window; there are no kernel-1 calls in the check.  None when the
program has no such counter, or has run no sweep on the card."""


def read(name, window):
    import torch
    from timecrystal_tpu_torch.ops import jacobi_svd

    counter = getattr(jacobi_svd, "pair_step_counter", None)
    if counter is None or not torch.cuda.is_available():
        return None
    live, scheduled = counter(torch.device("cuda", torch.cuda.current_device())).tolist()
    if scheduled <= 0:
        return None
    return 100.0 * (1.0 - live / scheduled)
