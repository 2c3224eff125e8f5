"""host_syncs_per_period: the host syncs that torch's sync debug mode
reports in the window, per period the window completed (a chain-period of
an ensemble, a period of a whole grid)."""


def read(name, window):
    periods = window.total("periods")
    if "syncs" not in window.counters or periods <= 0:
        return None
    return window.counters["syncs"] / periods
