"""compaction.items: items the compactions carried into deeper levels a pass
(``Miner.stats["runner"]["items"]``)."""


def read(w):
    n = w.counters.get("items")
    if n is None:
        return None
    return n / w.passes
