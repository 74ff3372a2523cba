"""session.pass_s: the host-clock wall of the pass run just before the
profiled ones, without the profiler (every call ending in its count's read),
in seconds: a pass as its user waits for it, kept per layer where the host's
speed moves it too far for an end-to-end bound."""


def read(w):
    if not w.plain_counters:
        return None
    return w.plain_wall_s
