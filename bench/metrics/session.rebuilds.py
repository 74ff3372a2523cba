"""session.rebuilds: executables the session built during the profiled
passes (``Miner.stats["rebuilds"]``, the executable cache's misses); 0 once
the warm pass has built every shape of the mix."""


def read(w):
    return w.counters.get("rebuilds")
