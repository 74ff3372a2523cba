"""engine.level_calls: the engine's level-kernel dispatches a pass
(``Miner.stats["runner"]["level_kernel_dispatches"]``)."""


def read(w):
    n = w.counters.get("level_kernel_dispatches")
    if not n:
        return None
    return n / w.passes
