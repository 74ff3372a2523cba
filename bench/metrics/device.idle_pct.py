"""device.idle_pct: the share of the profiled passes' wall in which nothing
ran on the card, 100 x (1 - union of device-activity intervals / wall)."""


def read(w):
    if w.trace is None or not w.trace.busy_ns:
        return None
    return 100.0 * (1.0 - w.trace.busy_ns / w.trace.window_ns)
