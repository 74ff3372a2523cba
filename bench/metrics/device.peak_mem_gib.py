"""device.peak_mem_gib: torch.cuda.max_memory_allocated() over the profiled
passes (reset at their start), in GiB."""


def read(w):
    if not w.peak_mem_bytes:
        return None
    return w.peak_mem_bytes / 2**30
