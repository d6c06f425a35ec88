"""Share of the window in which no kernel, copy or memset runs on the card
(the window less the union of the profiler's device intervals)."""


def read(trace, counts):
    if trace.window_s <= 0 or len(trace.dev_start) == 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
