"""engine.call_us: the host-clock wall of the pass run just before the
profiled ones, without the profiler (it ends in its last count's read), over
that pass's level-kernel dispatches, in microseconds: the engine's cost a
level call as the untraced window sees it."""


def read(w):
    n = w.plain_counters.get("level_kernel_dispatches")
    if not n:
        return None
    return 1e6 * w.plain_wall_s / n
