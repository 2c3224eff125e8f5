"""ladder_rerun_share: the periods the chi ladder ran again at a larger chi
over all the periods it ran (kept and again), in the window's jobs: the
ladder's wasted work."""


def read(name, window):
    done, again = window.total("ladder_periods"), window.total("ladder_reruns")
    if done <= 0:
        return None
    return 100.0 * again / (done + again)
