"""feed.chunks: level-1 feed chunks a pass (the session registry's
``feed_chunks`` counter)."""


def read(w):
    n = w.counters.get("feed_chunks")
    if not n:
        return None
    return n / w.passes
