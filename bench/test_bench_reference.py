"""The plain reference against the port's CPU session, every query of both
traffic mixes, on email-eu-core@0.25 (the port's twin) and the fitted mico
at small scale."""
import json
from pathlib import Path

import numpy as np
import pytest

from bench import graphs, reference
from repro_torch.graph import datasets
from repro_torch.graph.csr import build_csr
from repro_torch.mining.session import Miner

BENCH = Path(__file__).resolve().parent
MICO = json.loads((BENCH / "configs" / "mico.json").read_text())
GRAPHS = {"email-eu-core@0.25": lambda: datasets._edges_for("email-eu-core", 0.25, 0),
          "mico@0.005": lambda: graphs.edges_of(MICO, 0.005)}


def _mix_calls():
    out = []
    for f in sorted((BENCH / "traffic").glob("*.json")):
        for call in json.loads(f.read_text())["calls"]:
            qs = call["queries"] if call["op"] == "count_many" else [call["query"]]
            out.append((call["op"], tuple(qs)))
    return sorted(set(out))


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request):
    edges, v = GRAPHS[request.param]()
    edges = np.random.default_rng(77).permutation(v)[edges]      # another numbering
    miner = Miner(build_csr(edges, num_vertices=v, undirected=True), device="cpu")
    return reference.counts(edges, v), miner


@pytest.mark.parametrize("op,queries", _mix_calls())
def test_reference_equals_the_cpu_session(pair, op, queries):
    want, miner = pair
    got = miner.count(queries[0]) if op == "count" else miner.count_many(list(queries))
    assert (got if op == "count_many" else [got]) == [want[q] for q in queries]


def test_grow_blocks_give_the_same_cliques(monkeypatch):
    edges, v = graphs.edges_of(MICO, 0.003)
    want = reference.counts(edges, v)
    monkeypatch.setattr(reference, "BLOCK", 1000)
    assert reference.counts(edges, v) == want
