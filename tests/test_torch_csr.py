"""The port's graph substrate (repro_torch.graph) against the JAX package's.

Both packages build the same synthetic datasets from the same seeds; every
array must be equal, as must the row gathers the engine runs on.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import csr as jcsr
from repro.graph import datasets as jdatasets
from repro_torch.core.stream import LANE, SENTINEL, round_capacity
from repro_torch.graph import csr as tcsr
from repro_torch.graph import datasets as tdatasets

FIELDS = ("indptr", "indices", "offsets", "degrees")
GRAPHS = [("citeseer", 1.0), ("email-eu-core", 0.25)]


def reference_arrays(g) -> dict:
    return {f: np.asarray(getattr(g, f)) for f in FIELDS}


@pytest.mark.parametrize("name,scale", GRAPHS)
def test_get_dataset_equals_reference(name, scale):
    jg = jdatasets.get_dataset(name, scale)
    tg = tdatasets.get_dataset(name, scale)
    assert tg.device.type == "cpu"
    for f in FIELDS:
        got = getattr(tg, f)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jg, f)))
    assert (tg.num_vertices, tg.num_edges, tg.max_degree, tg.padded_max_degree) == \
        (jg.num_vertices, jg.num_edges, jg.max_degree, jg.padded_max_degree)
    assert tdatasets.dataset_stats(tg) == jdatasets.dataset_stats(jg)


@pytest.mark.parametrize("name", sorted(jdatasets.DATASETS))
def test_every_dataset_equals_reference_at_small_scale(name):
    jg = jdatasets.get_dataset(name, 0.02)
    tg = tdatasets.get_dataset(name, 0.02)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)))
    assert (tg.num_vertices, tg.num_edges, tg.max_degree) == \
        (jg.num_vertices, jg.num_edges, jg.max_degree)


@pytest.mark.parametrize("name,scale", GRAPHS)
def test_buckets_and_edge_list_equal_reference(name, scale):
    jg = jdatasets.get_dataset(name, scale)
    tg = tdatasets.get_dataset(name, scale)
    jb, tb = jcsr.degree_buckets(jg), tcsr.degree_buckets(tg)
    assert [c for c, _ in jb] == [c for c, _ in tb]
    for (_, jv), (_, tv) in zip(jb, tb):
        np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(jcsr.edge_list(jg), tcsr.edge_list(tg))


@pytest.mark.parametrize("name,scale", GRAPHS)
@pytest.mark.parametrize("cap", [128, 256, 384])
def test_padded_rows_equal_reference(name, scale, cap):
    jg = jdatasets.get_dataset(name, scale)
    tg = tdatasets.get_dataset(name, scale)
    rng = np.random.default_rng(cap)
    vs = rng.integers(0, jg.num_vertices, size=64).astype(np.int32)
    vs[:3] = [0, jg.num_vertices - 1, int(np.argmax(np.asarray(jg.degrees)))]
    jrows, jlens = jcsr.padded_rows(jg, jnp.asarray(vs), cap)
    trows, tlens = tcsr.padded_rows(tg, torch.from_numpy(vs), cap)
    assert trows.dtype == torch.int32 and tuple(trows.shape) == (64, cap)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))


def test_padded_rows_last_vertex_reads_sentinel_padding():
    """The window past the last vertex's row is clamped into ``indices`` and
    reads SENTINEL padding, never another row."""
    g = tcsr.build_csr(np.array([[0, 1], [1, 2], [2, 3]]), num_vertices=4)
    rows, lens = tcsr.padded_rows(g, torch.tensor([3, 3], dtype=torch.int32), 256)
    assert lens.tolist() == [1, 1]
    assert rows[0, 0].item() == 2 and bool((rows[:, 1:] == SENTINEL).all())


def test_from_reference_arrays_round_trips():
    jg = jdatasets.get_dataset("email-eu-core", 0.25)
    arrays = reference_arrays(jg)
    tg = tcsr.from_reference_arrays(arrays, jg.num_vertices, jg.num_edges,
                                    jg.max_degree, device="cpu")
    back = tcsr.to_numpy(tg)
    assert sorted(back) == sorted(FIELDS)
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], arrays[f])
        assert back[f].dtype == np.int32
    same = tdatasets.get_dataset("email-eu-core", 0.25)
    for f in FIELDS:
        assert torch.equal(getattr(tg, f), getattr(same, f))
    with pytest.raises(KeyError, match="offsets"):
        tcsr.from_reference_arrays({f: arrays[f] for f in FIELDS if f != "offsets"},
                                   1, 1, 1, device="cpu")


def test_build_csr_equals_reference_on_messy_edges():
    """Self loops, duplicates and both directions collapse identically."""
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 40, size=(300, 2))
    edges[:5] = [[1, 1], [2, 3], [3, 2], [2, 3], [7, 7]]
    jg = jcsr.build_csr(edges, num_vertices=41)
    tg = tcsr.build_csr(edges, num_vertices=41)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)))
    assert (tg.num_edges, tg.max_degree) == (jg.num_edges, jg.max_degree)


def test_stream_constants_equal_reference():
    from repro.core import stream as jstream
    assert SENTINEL == int(jstream.SENTINEL) and LANE == jstream.LANE
    for n in (0, 1, 127, 128, 129, 640, 1000):
        assert round_capacity(n) == jstream.round_capacity(n)
