"""step_mfu_pct: the nominal operations of the TEBD periods the traced
window completed (``portbench/work.py``: SVDs, contractions and gates)
over the window's length times the card's float32 peak."""


def read(name, window):
    if window.peak is None or not window.trace:
        return None
    ops = window.total("nominal_ops")
    if ops <= 0:
        return None
    return 100.0 * ops / (window.seconds * window.peak["float32_flops"])
