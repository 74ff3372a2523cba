"""The port's emit levels (``Miner.embeddings``, emit plans in forests)
against the JAX package's.

On the same graphs every embedding matrix must equal the JAX engine's row
for row, in both compaction modes, with ``fused_level`` True and False and
at chunk 16 and the default chunk, and so must the engine counters and
``level_execs``.
"""
import numpy as np
import pytest

from repro.graph import build_csr as jbuild_csr
from repro.graph import get_dataset as jget_dataset
from repro.mining.session import Miner as JMiner
from repro_torch import Miner
from repro_torch.graph import build_csr, get_dataset
from repro_torch.graph.generators import powerlaw_cluster
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

QUERIES = ("triangle", "4-clique", "diamond", "4-cycle")
GRAPHS = [("citeseer", 1.0), ("email-eu-core", 0.25)]
# a small graph on which all four queries have embeddings (209, 17, 553
# and 1156): at chunk 16 its waves split into many chunks with padded tails
PLC_EDGES = powerlaw_cluster(80, 4, seed=5)


def _state(m) -> tuple:
    return dict(m.runner.stats), dict(m.runner.level_execs)


def _hold(m, jm, queries=QUERIES) -> None:
    """Each query's embeddings, counters and level_execs equal the JAX
    engine's (diamond's emit level is a SUB level, 4-cycle's a general one,
    the others INTER)."""
    for q in queries:
        got, want = m.embeddings(q), np.asarray(jm.embeddings(q))
        assert got.dtype == np.int32 and got.shape == want.shape, q
        np.testing.assert_array_equal(got, want, err_msg=q)
        assert _state(m) == _state(jm), q


@pytest.mark.parametrize("name,scale", GRAPHS)
def test_embeddings_equal_jax_miner(name, scale):
    m = Miner(get_dataset(name, scale), device="cpu")
    jm = JMiner(jget_dataset(name, scale), backend="xla")
    _hold(m, jm)
    assert m.stats["runner"]["items"] > 0


@pytest.mark.parametrize("device_compact", [True, False])
@pytest.mark.parametrize("fused_level", [True, False])
def test_embeddings_in_every_mode_equal_jax_miner(device_compact, fused_level):
    """A small power-law graph at chunk 16 (every query, many chunks with
    padded tails) and email-eu-core 0.25 at its own chunk (diamond's SUB
    and 4-cycle's general emit level over large waves)."""
    cfg = dict(device_compact=device_compact, fused_level=fused_level)
    _hold(Miner(build_csr(PLC_EDGES, 80), device="cpu", chunk=16, **cfg),
          JMiner(jbuild_csr(PLC_EDGES, 80), backend="xla", chunk=16, **cfg))
    _hold(Miner(get_dataset("email-eu-core", 0.25), device="cpu", **cfg),
          JMiner(jget_dataset("email-eu-core", 0.25), backend="xla", **cfg), QUERIES[2:])


def test_emit_counters_and_repeat():
    """An emit call counts one device compaction, its rows as items and
    one host sync per emitted block; a repeated query rebuilds nothing and
    an emit plan is cached apart from its count twin."""
    m = Miner(get_dataset("email-eu-core", 0.25), device="cpu")
    rows = m.embeddings("triangle")
    st = m.stats["runner"]
    assert len(rows) == m.count("triangle") == 11502
    assert st["items"] == 11502 and st["device_compactions"] == 1 == st["host_syncs"]
    assert m.metrics.histogram("wave_items").snapshot()["sum"] == 11502
    rebuilds = m.stats["rebuilds"]
    np.testing.assert_array_equal(m.embeddings("triangle"), rows)
    assert m.stats["rebuilds"] == rebuilds
    assert m.compile("triangle", emit=True) is not m.compile("triangle")
    assert m.stats["plan_hits"] == 3 and m.stats["plan_misses"] == 2


def test_schedule_with_emit_equals_jax():
    """schedule(emit=True): a batch of emit plans through one forest."""
    m = Miner(get_dataset("email-eu-core", 0.25), device="cpu")
    jm = JMiner(jget_dataset("email-eu-core", 0.25), backend="xla")
    queries = ["4-clique", "diamond"]
    got = m.runner.run_set(m.schedule(queries, emit=True))
    want = jm.runner.run_set(jm.schedule(queries, emit=True))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert _state(m) == _state(jm)
    assert [len(x) for x in got] == [10622, 151646]
