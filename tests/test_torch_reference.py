"""The port's brute-force oracles (``repro_torch.mining.reference``), the
launcher's F4M census, the profiler hook and the train step's
``compress_pods``, against the JAX package on the CPU.

  * **the oracles**: each held to the JAX package's (networkx is installed
    here, not on the card's machine): triangle, k-clique (k = 3, 4, 5),
    three-chain (induced and not), tailed-triangle and 3-motif counts on
    email-eu-core@0.25 and the tiny graphs of tests/test_values.py and
    tests/test_plan.py; the 4-motif census on the CPU on generated graphs of
    at most 40 vertices; ``pattern_count_oracle`` on the named patterns and
    test_plan.py's seeded random patterns; ``weighted_pattern_oracle`` bit
    for bit on dyadic weights; ``fsm_oracle`` dicts equal, MNI and count.
    Integers exactly. The module imports neither networkx, jax, ``repro``
    nor a module of the engine;
  * **the launcher**: ``launch.mine --app F4M --check`` on email-eu-core@0.1
    prints the census line;
  * **the profiler hook**: ``Telemetry.torch_profile`` writes one Chrome
    trace, and nothing when its logdir is None;
  * **compress_pods**: on one gloo rank (a subprocess over a FileStore) on a
    ('pod', 'data', 'model') = (1, 1, 1) mesh, each compressed gradient leaf
    of qwen3-0.6b's smoke config bit for bit equal to the JAX
    ``tree_compressed_mean`` of the same gradient, and three float32 steps'
    loss and gnorm within rtol 1e-5 of the JAX ``make_train_step(...,
    compress_pods=True)``; on four ranks on (2, 1, 2), ``ShardedTrainStep``
    (each leaf's scale the max over its 'model' blocks) against the one-rank
    step within rtol 1e-5."""
import ast
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.graph import build_csr as jbuild_csr
from repro.graph import get_dataset as jget_dataset
from repro.graph import with_edge_values as jwith_edge_values
from repro.graph.generators import clique_planted, edge_weights, erdos_renyi, powerlaw_cluster
from repro.mining import plan as JP
from repro.mining import reference as J
from repro.mining.fsm import random_labels
from repro_torch.graph import build_csr, get_dataset, with_edge_values
from repro_torch.graph.csr import edge_list
from repro_torch.mining import plan as P
from repro_torch.mining import reference as R
from repro_torch.obs import Telemetry
from _torch_rows import one_torch_thread  # noqa: F401  (autouse: one torch thread)

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
REFERENCE_PY = os.path.join(SRC, "repro_torch", "mining", "reference.py")


def _pair(edges, n):
    """The same edge list as a JAX and a port CSR graph."""
    return jbuild_csr(edges, n), build_csr(edges, n)


# the tiny graphs of tests/test_values.py (TINY_EDGES, SMALL) and
# tests/test_plan.py (GRAPHS, TINY), and the CPU tests' email-eu-core@0.25
GRAPHS = {
    "values-tiny": (erdos_renyi(20, 70, seed=7), 20),
    "values-small": (erdos_renyi(60, 240, seed=3), 60),
    "plan-er": (erdos_renyi(60, 240, seed=3), 60),
    "plan-plc": (powerlaw_cluster(50, 4, seed=5), 50),
    "plan-cliq": (clique_planted(45, 120, (6, 5), seed=1), 45),
    "plan-tiny": (erdos_renyi(18, 48, seed=7), 18),
}
_PAIRS: dict = {}


def pair(name):
    if name not in _PAIRS:
        _PAIRS[name] = ((jget_dataset("email-eu-core", 0.25), get_dataset("email-eu-core", 0.25))
                        if name == "email-eu-core@0.25" else _pair(*GRAPHS[name]))
    return _PAIRS[name]


COUNT_ORACLES = {
    "triangle": lambda m, g: m.triangle_count(g),
    "3-clique": lambda m, g: m.clique_count(g, 3),
    "4-clique": lambda m, g: m.clique_count(g, 4),
    "5-clique": lambda m, g: m.clique_count(g, 5),
    "three-chain": lambda m, g: m.three_chain_count(g),
    "three-chain-induced": lambda m, g: m.three_chain_count(g, induced=True),
    "tailed-triangle": lambda m, g: m.tailed_triangle_count(g),
    "motif3": lambda m, g: m.motif3(g),
}


@pytest.mark.parametrize("oracle", list(COUNT_ORACLES))
@pytest.mark.parametrize("graph", ["email-eu-core@0.25", *GRAPHS])
def test_count_oracles_equal_jax(graph, oracle):
    jg, tg = pair(graph)
    f = COUNT_ORACLES[oracle]
    got, want = f(R, tg), f(J, jg)
    assert got == want and type(got) is type(want)


def test_email_eu_core_counts_are_the_known_ones():
    g = pair("email-eu-core@0.25")[1]
    assert (R.triangle_count(g), R.clique_count(g, 4), R.clique_count(g, 5)) == (11502, 10622, 5051)
    assert R.motif3(g) == {"triangle": 11502, "chain": 138732}
    assert R.tailed_triangle_count(g) == 1769583


CENSUS_GRAPHS = {
    "er-30": (erdos_renyi(30, 120, seed=3), 30),
    "plc-40": (powerlaw_cluster(40, 4, seed=5), 40),
    "cliq-36": (clique_planted(36, 100, (6, 5), seed=1), 36),
    "values-tiny": GRAPHS["values-tiny"],
    "plan-tiny": GRAPHS["plan-tiny"],
    "k4-plus-path": (np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3], [3, 4], [4, 5]]),
                     6),
    "three-vertices": (np.array([[0, 1], [1, 2]]), 3),
}


@pytest.mark.parametrize("graph", list(CENSUS_GRAPHS))
def test_four_motif_census_equals_jax(graph):
    jg, tg = _pair(*CENSUS_GRAPHS[graph])
    got = R.four_motif_counts(tg, device="cpu")
    want = J.four_motif_counts(jg)
    assert got == want
    assert all(type(v) is int for v in got.values())


def test_four_motif_census_wants_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        R.four_motif_counts(_pair(*CENSUS_GRAPHS["er-30"])[1])


def _port_pattern(pat):
    """A JAX ``Pattern`` rebuilt with the port's ``pattern`` builder."""
    edges = [(i, j) for i in range(pat.k) for j in range(i + 1, pat.k) if pat.adj[i][j]]
    return P.pattern(pat.name, pat.k, edges, restrictions=list(pat.restrictions),
                     induced=pat.induced)


def _seeded(seed):
    from test_plan import _seeded_pattern
    return _seeded_pattern(seed)


NAMED = {"triangle": lambda M: M.TRIANGLE, "4-clique": lambda M: M.clique_pattern(4),
         "tailed-triangle": lambda M: M.TAILED_TRIANGLE,
         "diamond": lambda M: M.FOUR_MOTIFS["diamond"],
         "paw": lambda M: M.FOUR_MOTIFS["paw"],
         "4-cycle": lambda M: M.FOUR_MOTIFS["4-cycle"]}


@pytest.mark.parametrize("name", list(NAMED) + [f"seeded-{s}" for s in range(10)])
def test_pattern_count_oracle_equals_jax(name):
    jg, tg = pair("plan-tiny")
    if name.startswith("seeded-"):
        jpat = _seeded(int(name.split("-")[1]))
        tpat = _port_pattern(jpat)
    else:
        jpat, tpat = NAMED[name](JP), NAMED[name](P)
    assert (tpat.k, tpat.adj, tpat.induced, tpat.restrictions, tpat.div) == \
        (jpat.k, jpat.adj, jpat.induced, jpat.restrictions, jpat.div)
    assert R.pattern_count_oracle(tg, tpat) == J.pattern_count_oracle(jg, jpat)


def _weighted_pair(edges, n, seed):
    jg, tg = _pair(edges, n)
    w = edge_weights(edge_list(tg), seed=seed)
    return jwith_edge_values(jg, w), with_edge_values(tg, w)


AGG = {"triangle": lambda M: M.TRIANGLE, "three-chain-induced": lambda M: M.THREE_CHAIN_INDUCED,
       "4-clique": lambda M: M.clique_pattern(4)}


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("name", list(AGG))
def test_weighted_oracle_bit_equal_to_jax(name, op):
    jg, tg = _weighted_pair(*GRAPHS["values-tiny"], seed=11)     # test_values.py's TINY
    got = R.weighted_pattern_oracle(tg, AGG[name](P), op)
    want = J.weighted_pattern_oracle(jg, AGG[name](JP), op)
    assert type(got) is float and np.float64(got).tobytes() == np.float64(want).tobytes()
    assert got > 0


def test_weighted_oracle_guards():
    tg = _pair(*GRAPHS["values-tiny"])[1]
    with pytest.raises(ValueError):
        R.weighted_pattern_oracle(tg, P.TRIANGLE)              # no edge values
    wg = _weighted_pair(*GRAPHS["values-tiny"], seed=11)[1]
    with pytest.raises(ValueError):
        R.weighted_pattern_oracle(wg, P.TRIANGLE, "mean")


@pytest.mark.parametrize("metric,support", [("mni", 2), ("count", 3), ("count", 0)])
@pytest.mark.parametrize("seed,nlab", [(1, 2), (2, 3)])
def test_fsm_oracle_equals_jax(seed, nlab, metric, support):
    jg, tg = _pair(erdos_renyi(22, 55, seed=seed), 22)
    labels = random_labels(22, nlab, seed=seed)
    got = R.fsm_oracle(tg, labels, support, metric=metric)
    assert got == J.fsm_oracle(jg, labels, support, metric=metric)
    assert got


def test_reference_imports_no_engine():
    """networkx, jax, the JAX package and the engine stay out of the oracles:
    every import of the module, at its top and inside its functions."""
    tree = ast.parse(open(REFERENCE_PY).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert names, "no import found"
    banned = ("networkx", "jax", "repro", "repro_torch.mining.engine", "repro_torch.core",
              "repro_torch.kernels", "repro_torch.mining.session", ".engine", ".session",
              ".shard", ".apps")
    for name in names:
        assert not any(name == b or name.startswith(b + ".") for b in banned), name
    assert set(names) <= {"__future__", "itertools", "numpy", "torch", "repro_torch.graph.csr",
                          ".fsm"}


def test_surface_names_equal_jax_less_to_networkx():
    public = {n for n in dir(J) if not n.startswith("_") and callable(getattr(J, n))
              and getattr(getattr(J, n), "__module__", "") == J.__name__}
    port = {n for n in dir(R) if not n.startswith("_") and callable(getattr(R, n))
            and getattr(getattr(R, n), "__module__", "") == R.__name__}
    assert public - port == {"to_networkx"}
    assert R._MOTIF4_SIG == J._MOTIF4_SIG


# ---------------------------------------------------------------------------
# the launcher's census, the profiler hook
# ---------------------------------------------------------------------------

def test_launcher_f4m_check_prints_the_census(capsys):
    from repro_torch.launch import mine
    res = mine.main(["--app", "F4M", "--dataset", "email-eu-core", "--scale", "0.1",
                     "--device", "cpu", "--check"])
    out = capsys.readouterr().out
    assert "[mine] fused == independent per-plan counts OK" in out
    assert "[mine] fused == brute-force census OK" in out
    # the JAX package's census of email-eu-core@0.1 (reference.four_motif_counts)
    assert res == {"4-path": 302320, "4-star": 159967, "4-cycle": 31083, "paw": 185866,
                   "diamond": 50605, "4-clique": 5842}


def test_torch_profile_writes_one_chrome_trace(tmp_path):
    from repro_torch.mining import Miner
    g = get_dataset("email-eu-core", 0.1)
    m = Miner(g, device="cpu")
    tel = Telemetry()
    with tel.torch_profile(str(tmp_path / "prof"), "cpu") as d:
        n = m.count("triangle")
    assert d == str(tmp_path / "prof") and n == J.triangle_count(jget_dataset("email-eu-core", 0.1))
    files = os.listdir(d)
    assert files == ["trace.json"]
    trace = json.load(open(os.path.join(d, files[0])))
    assert trace["traceEvents"]
    with tel.torch_profile(None) as none:
        m.count("triangle")
    assert none is None
    with tel.torch_profile("") as empty:
        pass
    assert empty is None and os.listdir(tmp_path) == ["prof"]


def test_torch_profile_on_a_card_wants_one():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        with Telemetry().torch_profile("unused", "cuda"):
            pass


def test_launcher_torch_profile_flag(tmp_path, capsys):
    from repro_torch.launch import mine
    d = tmp_path / "lp"
    mine.main(["--app", "T", "--dataset", "citeseer", "--device", "cpu",
               "--torch-profile", str(d)])
    assert "[mine] T = " in capsys.readouterr().out
    assert json.load(open(d / "trace.json"))["traceEvents"]


# ---------------------------------------------------------------------------
# compress_pods against the JAX step
# ---------------------------------------------------------------------------

ARCH, STEPS, BATCH, SEQ, LR = "qwen3-0.6b", 3, 4, 16, 3e-3

RANK = r"""
import dataclasses, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import device_mesh
from repro_torch.models.convert import jax_layout, load_jax_params
from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import OptConfig, adamw_init, tree_map
from repro_torch.train.train_step import ShardedTrainStep, TrainStep, jit_train_step

rank, world = int(sys.argv[1]), int(sys.argv[2])
store, inp, out = sys.argv[3:6]
shape = tuple(int(x) for x in sys.argv[6].split(","))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
mesh = device_mesh(shape, ("pod", "data", "model"), "cpu")
d = pickle.load(open(inp, "rb"))
cfg = dataclasses.replace(get_arch(d["arch"]).smoke_config, dtype=torch.float32)
res = {}
if world == 1:
    # the JAX step's gradient as parameters, each its own grad, then compressed
    gm = load_jax_params(Model(cfg, device="cpu"), d["grads"])
    for p in gm.parameters():
        p.grad = p.detach().clone()
    cs = TrainStep(gm, mesh=mesh, compress_pods=True)
    cs._compress_pods_()
    res["compressed"] = jax_layout(tree_map(lambda p: p.grad, gm.tree()))
model = load_jax_params(Model(cfg, device="cpu"), d["params"])
oc = OptConfig(lr=d["lr"])
step, _ = jit_train_step(model, mesh, opt_cfg=oc, total_steps=d["steps"], compress_pods=True)
assert isinstance(step, ShardedTrainStep) == (world > 1) and step.pod_group is not None
opt = step.init_state() if world > 1 else adamw_init(model.tree(), oc)
res["metrics"] = []
for i, b in enumerate(d["batches"]):
    m = step(opt, {k: torch.from_numpy(v) for k, v in b.items()}, i)
    res["metrics"].append({k: float(v.full_tensor() if hasattr(v, "full_tensor") else v)
                           for k, v in m.items()})
    step.apply(opt, m)
if rank == 0:
    pickle.dump(res, open(out, "wb"))
dist.destroy_process_group()
"""


def _ranks(tmp_path, tag: str, shape: tuple, inp: str) -> dict:
    world = int(np.prod(shape))
    out = str(tmp_path / f"{tag}.out.pkl")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(world),
                               str(tmp_path / f"{tag}.store"), inp, out,
                               ",".join(map(str, shape))], env=env,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    return pickle.load(open(out, "rb"))


@pytest.fixture(scope="module")
def compress_runs(tmp_path_factory):
    """The JAX step with compress_pods on a (1, 1, 1) mesh and the port's on
    one and on four gloo ranks, from the same parameters and batches."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as jget_arch
    from repro.distributed.compression import tree_compressed_mean
    from repro.distributed.sharding import make_mesh_compat
    from repro.models.transformer import Model as JModel
    from repro.train import optimizer as JO
    from repro.train.train_step import make_train_step
    from repro_torch.models.convert import flatten_jax
    from repro_torch.train.data import SyntheticLMData

    tmp = tmp_path_factory.mktemp("compress")
    cfg = dataclasses.replace(jget_arch(ARCH).smoke_config, dtype=jnp.float32)
    model = JModel(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    mesh = make_mesh_compat((1, 1, 1), ("pod", "data", "model"))
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=0)
    batches = [data.batch_at(i) for i in range(STEPS)]
    grads = jax.jit(jax.grad(model.loss))(params, {k: jnp.asarray(v)
                                                   for k, v in batches[0].items()})
    compressed = jax.jit(lambda g: tree_compressed_mean(g, mesh, "pod"))(grads)
    opt_cfg = JO.OptConfig(lr=LR)
    opt = JO.adamw_init(params, opt_cfg)
    step_fn = jax.jit(make_train_step(model, mesh, opt_cfg=opt_cfg, total_steps=STEPS,
                                      compress_pods=True))
    numpy = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    inp = str(tmp / "in.pkl")
    pickle.dump({"arch": ARCH, "params": numpy(params), "grads": numpy(grads), "lr": LR,
                 "steps": STEPS, "batches": batches}, open(inp, "wb"))
    p = params
    jmetrics = []
    for i, b in enumerate(batches):
        p, opt, m = step_fn(p, opt, {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(i))
        jmetrics.append({k: float(v) for k, v in m.items()})
    one = _ranks(tmp, "one", (1, 1, 1), inp)
    four = _ranks(tmp, "four", (2, 1, 2), inp)
    return {"jax_compressed": flatten_jax(numpy(compressed)),
            "jax_grads": flatten_jax(numpy(grads)), "jax": jmetrics, "one": one, "four": four}


def test_compressed_leaves_bit_equal_to_jax(compress_runs):
    want, got = compress_runs["jax_compressed"], compress_runs["one"]["compressed"]
    assert list(got) == list(want)
    moved = 0
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
        moved += not np.array_equal(w, compress_runs["jax_grads"][k])
    assert moved > len(want) // 2           # the round trip changes the leaves


@pytest.mark.parametrize("run", ["one", "four"])
def test_compress_pods_steps_equal_jax(compress_runs, run):
    got = compress_runs[run]["metrics"]
    want = compress_runs["jax"] if run == "one" else compress_runs["one"]["metrics"]
    assert len(got) == len(want) == STEPS
    for a, b in zip(got, want):
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)


def test_compress_pods_needs_a_pod_axis():
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Model
    from repro_torch.train.train_step import jit_train_step
    model = Model(get_arch(ARCH).smoke_config, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    step, _ = jit_train_step(model, None, compress_pods=True)
    assert step.pod_group is None          # no mesh, no 'pod': the flag does nothing
