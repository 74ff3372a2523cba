"""kernels.device_ms: the summed device time of every kernel the profiled
passes ran, whatever its name (copies and sets are not kernels), per pass."""


def read(w):
    if w.trace is None or not w.trace.kernel_total_ns:
        return None
    return w.trace.kernel_total_ns / 1e6 / w.passes
