#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases card,build,parity,csr     # kernels only
    python3 chip_smoke.py --phases card,build,emit           # the emit path only
    python3 chip_smoke.py --phases card,build,shard          # the sharded path only
    python3 chip_smoke.py --phases card,build,serve,isa      # the service and the ISA
    python3 chip_smoke.py --phases card,lm,examples          # the LM and the examples
    python3 chip_smoke.py --phases card,train                # LM training
    python3 chip_smoke.py --phases card,dist                 # sharding, dry run, roofline
    python3 chip_smoke.py --phases card,build,reference      # the brute-force oracles
    python3 chip_smoke.py --src OTHER/src --phases card,build,parity,profile

Phases, each printing its own lines and its seconds; any mismatch or
exception exits non-zero:

  1. card     nvidia-smi name and power limit, torch and CUDA versions
  2. build    nvcc builds every CUDA source of the port from the checkout,
              one process per source, all started together (build
              seconds, -Xptxas -v registers/shared memory)
  3. parity   each kernel against its plain torch version on the card, on
              seeded random rows at the main path's shapes (the k-reference
              kernels over INTER/SUB polarities, excludes and bound-0 rows;
              the value-lane and S_VINTER kernels over every op, S_VINTER in
              its paired and its grid form, timed at ttv's fibre block and
              email-core's spmm block; compact-rows over keep
              densities, cut rows, dead rows, SENTINEL slots and views at a
              storage offset, and both its teams swept over caps; the
              bitmap count over random words), bit for bit on dyadic
              values and within rtol 1e-6 on others; each kernel timed three
              ways (kernel_times: device ms, call ms, host us per call) and
              its plain version by CUDA events; ops.xinter against the CPU's
              batch_inter
  4. csr      the CSR-operand forms (the count and aggregate leaves; the SUB
              count leaf, the SUB and per-reference marks, the general count
              leaf and general expand marks; the INTER expand level's packed
              rows and its items pass) on a synthetic CSR of the same rows,
              against their plain versions: warp-a-row and block-a-row caps,
              rows past shared memory, rows cut at their cap, empty rows, the
              last vertex, unaligned row starts, bound-0 rows, every
              polarity, E = 2 excludes, a fresh and a carried base; timed as
              in parity
  5. main     repro_torch.Miner counts triangles, cliques, three-chains and
              the 4-motifs on mico, youtube, wiki-vote and email-eu-core at
              the sizes below, and 4-cycle once more with fused_level=False;
              each count must equal the JAX package's (mico's three-chains
              also the closed form); each query's padded-row gathers are
              printed: none for a triangle, the cliques, three-chain-induced,
              diamond and paw, and the level-2 expand's fresh base alone for
              4-cycle, 4-path and 4-star
  6. weighted Miner.aggregate (sum, max, min) on the same graphs with
              dyadic edge weights: each value must equal the JAX package's
              (bit for bit where f32 holds every partial sum, else within
              rtol 1e-6), with the feed chunks and level dispatches of its
              unweighted twin and one value-lane launch per leaf call; a
              weighted triangle's leaf gathers no padded rows
  7. sparse   repro_torch.sparse.spmsp_matmul and ttv at the paper's Table
              VI sizes, against float64 numpy products; each product's wall
              and S_VINTER launches (one a block, as in the JAX package)
  8. forest   Miner.count_many (the plan forest): TM on mico, 4M on
              wiki-vote, each equal to the JAX package's counts and to
              per-query counts in the same session; the forest's static
              and dynamic sharing on email-eu-core 1.0 (feed passes, level-2
              executions, fused against independent walls); the session mix
              of benchmarks/bench_mining.py twice on email-eu-core 0.25 (the
              baseline.json counts, nothing rebuilt on the second pass);
              aggregate_many against per-query aggregates
 8b. reference the brute-force oracles (mining/reference.py) on the card:
              four_motif_counts of email-eu-core 0.25 (C(250, 4) quadruples
              in chunks on the card; cold and warm wall, peak memory) equal to
              a card Miner's count_many of the six 4-motifs; on two tiny
              generated graphs the triangle, 4- and 5-clique, tailed-triangle
              and induced three-chain oracles and pattern_count_oracle of
              diamond, paw and 4-cycle equal to the card session's counts,
              weighted_pattern_oracle equal to Miner.aggregate bit for bit
              (dyadic weights), fsm_oracle equal to fsm; launch.mine --app F4M
              --check --torch-profile in a subprocess: both OK lines, and its
              Chrome trace holds the device events of every hand kernel that
              count_many launched
  9. host     the host-compaction path (device_compact=False): the JAX
              package's counters on email-eu-core 0.25 4M, wiki-vote 4C and
              4M equal to the device path's counts, mico 4C in both modes
              timed; one compact-rows launch per host compaction
 10. emit     Miner.embeddings: mico's triangles and 4-cliques (INTER emit
              levels) and email-eu-core 0.25's diamonds (SUB) and 4-cycles
              (general), each matrix equal to the JAX package's row for row
              (sha256), each expand or emit level call one launch of its
              shape's kernels, no padded-row gather on mico; youtube's
              10152197 triangles checked on the card (order, edges, no row
              twice), its wall and device busy share; mico's triangles on
              the host path equal to the device path's, one compact-rows
              launch per host compaction
 11. fsm      the FSM feed through a forest of [triangle count, triangle
              emit] on mico; fsm and sfsm on email-eu-core 1.0 equal to the
              JAX package's result dicts, each wall and its triangle feed's
              share
 12. telemetry benchmarks/ci_gate.py:measure_telemetry's session mix on a
              traced and an untraced Miner: baseline.json's span counts,
              runner stats, session counters, registry == legacy, traced ==
              untraced (counts, stats, kernel launches); mico 4-clique
              traced and untraced, the traced run's top self-times
 13. shard    Miner(mesh=8) with eight shards on the first card
              (mining.shard): ci_gate.py's sharded and mesh-8 telemetry mixes
              on email-eu-core 0.25 against baseline.json (dispatches per
              pass {1: 43, 8: 16}, 12 cross-shard reductions, the per-shard
              feed items, host syncs 19, span counts, nothing rebuilt on the
              second pass); mico's six MAIN_PATH counts at mesh 1 and 8 with
              their walls, mico 4-clique's device busy share at both, the
              weighted triangle sum, the triangle embeddings (sorted rows
              equal to the unsharded session's), wiki-vote's 4-motifs through
              count_many; with two or more cards, mico T and 4C over a mesh
              of distinct cards
 14. serve    repro_torch.serving.MiningService over one card session on
              mico (weighted): three rounds of triangle, three-chain-induced,
              4-clique, 5-clique and (diamond, paw) requests with a weighted
              triangle sum on the values class, submitted together and
              served by one tick each: MAIN_PATH's counts, the sum 17518.3125
              bit for bit, fused < independent feed passes every tick, nothing
              built after the first round, every request done; a warmed
              session's count_many of the union against the tick's wall; a
              burst of 15 count requests from 4 client threads (LoadGenerator)
              against the sequential warmed session (qps, p50, p99); then
              benchmarks/bench_serving.py's batching, cache, mixed-pool (a
              mesh-8 bulk worker on one card) and load facts on email-eu-core
              0.25 against baseline.json's exact serving keys
 15. isa      the stream ISA (core/isa.py) on CUDA streams against the same
              ops on CPU copies: s_inter, s_sub (keys and lengths bit for
              bit), s_inter_c, s_sub_c, s_union_count, s_vinter (mac, max,
              min: dyadic values bit for bit, others within rtol 1e-6) and
              s_fetch past the end, at caps 128-4096 with bounds None, random,
              0 and SENTINEL; s_nestinter over mico's highest-degree vertex
              (degree 2012, cap 2048), bound_by_key both ways, against the CPU
              path and the set-semantics sum
 16. bitmap   keys_to_bitmap + xbitmap_count on 2048 of mico's half-edges,
              equal to the sorted-row count of the same rows; the
              merge-against-bitmap crossover sweep of
              benchmarks/bench_kernels.py, timed on the card
 17. lm       the LM decode path (models/, configs/, no kernel of the port:
              plain torch): each of the ten architectures' smoke config, weights
              from the port's init with a CPU generator of seed 0, 8 greedy
              decode steps at batch 2 on the card against the same model on the
              CPU, with TF32 off: float32 logits within rtol 1e-4 and atol
              1e-4·max|logit| and equal tokens, then bfloat16 (teacher-forced by
              the float32 tokens) within 2e-2·max|logit| where every MoE route
              is the CPU's (a token routed elsewhere must be a near tie of the
              router, and its row is masked from that step on); qwen3-0.6b at
              full width (28 layers, d 1024, vocab 151936) in float32 against
              the CPU, teacher-forced, then in bfloat16 through greedy_decode at
              batch 4, 32 tokens, max_len 128, timed (init, ms a step, tok/s,
              peak memory); python -m repro_torch.launch.serve --arch
              qwen3-0.6b and --arch rwkv6-3b as subprocesses, each exiting 0
              with its tok/s line
 18. examples examples/quickstart_torch.py and mine_patterns_torch.py on the
              card as subprocesses: each exits 0 and prints the JAX examples'
              lines (EXAMPLE_LINES, timings blanked)
 19. train    LM training (Model.loss, train/, launch/train.py; no kernel of
              the port: plain torch and autograd): each smoke config, two
              steps on one batch on the card against the CPU in float32 (TF32
              off; loss within rtol 1e-4, gnorm within 1e-3, the second loss
              at most the first + 0.1), then in bfloat16 for the record;
              qwen3-0.6b at full width in float32, two steps at 2 x 32, card
              against CPU (loss within rtol 1e-5, gnorm within 1e-4); crash
              and restart of launch.train in subprocesses (exit 17, "restored
              step", the uninterrupted run's losses); examples/train_100m_torch.py
              (final loss below ln V - 1); qwen3-0.6b as published through
              launch.train --full at 8 x 512 for 20 steps (the loss falling, ms
              a step, tok/s, peak memory), one step's aten ops and device
              busy share, 5 steps with 8-bit state, and one step at 4 x 2048
              whose peak memory less params, grads and state stays below one
              whole float32 logits tensor
 20. dist     the LM partition rules, the sharded train step, the dry run and
              the roofline (no kernel of the port), each in a subprocess:
              launch.dryrun's qwen3-0.6b train_4k cell on the single-pod mesh
              (256 fake ranks, fake cuda tensors, the step data parallel over
              'data' and tensor parallel over 'model': status ok, an all-reduce,
              argument bytes of the JAX layout equal to the port's per-unit
              shard bytes, HW.hbm_bytes within the card's memory); the
              sharded step on a one-card NCCL (1, 1) mesh against TrainStep
              (qwen3-0.6b and deepseek-v2-lite-16b smoke, float32, TF32 off,
              3 steps, loss and gnorm within rtol 1e-5); compressed_mean on
              that world bit for bit equal to the same call over a CPU gloo
              group; the roofline of one qwen3-0.6b bfloat16 8 x 512 step on
              the card beside the train phase's ms a step and the MFU (printed,
              not gated); compress_pods=True on a one-card NCCL ('pod', 'data',
              'model') = (1, 1, 1) mesh, 3 qwen3-0.6b smoke steps in float32
              within rtol 1e-5 of the same steps on the CPU over gloo
 21. profile  mico's queries once more under torch.profiler, then mico's
              4-clique on the host path and email-core's spmm: device busy
              time against the untraced wall time, and the top device kernels
 22. lines    the kernels JSON line, then the final {"ok": true, ...} line

Every kernel's launch counter is zeroed just before the path that runs it
(5, 6, 7, 9, 10, 15 or 16) and must be > 0 just after it; in 13 and 14 the
counts are zeroed just before each mesh-8 call (each service call) and read
just after it, summed over those calls alone, so the mesh-1 runs (the
sequential sessions) beside them never count. The kernels line reports
those counts (``emit_launches``: the emit path's, ``shard_launches`` the
sharded path's, ``serve_launches`` the service's, ``isa_launches`` the stream
ISA's). --phases runs a
subset (the result lines are printed only when every phase ran); --src
measures another checkout's repro_torch, such as a parent commit unpacked
with git archive, with this script.

Imports nothing of JAX or of the JAX package. Needs one card; exits non-zero,
printing no result, when torch sees no CUDA device or when the repository's
``src/repro_torch`` is not beside this file.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.utils._python_dispatch

ROOT = Path(__file__).resolve().parent

# The JAX package's counts on the same graphs, from
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "from repro.graph import \
#     get_dataset; from repro.mining.session import Miner; \
#     print(Miner(get_dataset(NAME, SCALE), backend='xla').count(QUERY))"
# (mico's and wiki-vote's 4-star, 4-cycle and 4-path build wedge-sized
# worklists, about 1.1e8 items on mico, too many for the JAX package on a CPU;
# they run on wiki-vote, the other Table IV graph the paper mines.)
MAIN_PATH = (
    ("mico", 1.0, (("triangle", 71459), ("4-clique", 4682), ("5-clique", 674),
                   ("three-chain-induced", 108741980), ("diamond", 505337),
                   ("paw", 96666391))),
    ("youtube", 1.0, (("triangle", 10152197),)),
    ("wiki-vote", 1.0, (("three-chain-induced", 9905212), ("diamond", 749669),
                        ("4-star", 626676141), ("4-cycle", 2759009),
                        ("paw", 33374526), ("4-path", 654442501))),
    ("email-eu-core", 0.25, (("triangle", 11502), ("4-clique", 10622),
                             ("three-chain", 138732), ("tailed-triangle", 1769583),
                             ("diamond", 151646), ("4-star", 1652486),
                             ("4-cycle", 161630), ("paw", 1035535),
                             ("4-path", 3252244), ("5-clique", 5051))),
)
# (email-eu-core's 5-clique is the twin of a weighted query below)
# run again with fused_level=False: one mark launch per reference; 4-cycle's
# count level has k = 2 references (one INTER, one SUB)
UNFUSED = ("email-eu-core", 0.25, "4-cycle", 161630, 2)
PROFILED = ("triangle", "4-clique", "5-clique", "three-chain-induced", "diamond", "paw")

# The JAX package's weighted aggregates on the same graphs, weights
# edge_weights(edge_list(g), seed=0), from
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "from repro.graph import \
#     get_dataset, with_edge_values, edge_weights; from repro.graph.csr import \
#     edge_list; from repro.mining.session import Miner; g = get_dataset(NAME, \
#     SCALE); g = with_edge_values(g, edge_weights(edge_list(g), seed=0)); \
#     print(repr(Miner(g, backend='xla').aggregate(QUERY, OP)))"
# (mico's 4-cycle and 4-path are too large for the JAX package on a CPU;
# wiki-vote's stand in, as for the counts.) email-eu-core's T and 4C sums
# are benchmarks/baseline.json's values.email-eu-core@0.25.{T,4C}.aggregate.
WEIGHTED = (
    ("mico", 1.0, (("triangle", "sum", 17518.3125), ("triangle", "max", 1.0),
                   ("triangle", "min", 0.015625), ("4-clique", "sum", 310.16845703125),
                   ("5-clique", "sum", 7.125557899475098),
                   ("three-chain-induced", "sum", 42446932.6875),
                   ("paw", "sum", 14872879.95703125))),
    ("wiki-vote", 1.0, (("4-cycle", "sum", 413501.5546875),
                        ("4-path", "sum", 158319244.59375))),
    ("email-eu-core", 0.25, tuple(
        (q, op, v) for q, vals in (
            ("triangle", (2835.9375, 1.0)), ("4-clique", (630.774658203125, 1.0)),
            ("5-clique", (41.270057678222656, 1.0)),
            ("three-chain-induced", (54665.3125, 1.0)),
            ("diamond", (14606.169921875, 1.0)), ("paw", (159296.94921875, 1.0)),
            ("4-cycle", (24847.1953125, 1.0)),
            ("tailed-triangle", (270491.85546875, 1.0)),
            ("4-path", (804741.140625, 1.0)))
        for op, v in zip(("sum", "max"), vals))),
)
# pattern edges per weighted query: a value is a product of that many
# weights in {1/4, 1/2, 3/4, 1}, a multiple of 4^-edges
PATTERN_EDGES = {"triangle": 3, "4-clique": 6, "5-clique": 10, "three-chain-induced": 2,
                 "diamond": 5, "paw": 4, "4-cycle": 4, "tailed-triangle": 4, "4-path": 3}
# the count phase's name for a weighted query's unweighted twin, where it differs
TWIN = {("email-eu-core", "three-chain-induced"): "three-chain"}
AGG_OPS = ("sum", "max", "min")
PROFILED_WEIGHTED = (("triangle", "sum"),)

# the paper's Table VI twins (benchmarks/bench_sparse.py): (name, n, density)
# square matrices, A from seed 1 and B from seed 2; (name, shape, nnz) CSF
# tensors from seed 3 against a dense vector from seed 4
SPARSE_MATRICES = (("circuit204", 1020, 0.0057), ("email-core", 1005, 0.025),
                   ("fpga", 1220, 0.0040), ("laser", 1500, 0.00055),
                   ("grid2", 1600, 0.00059))
SPARSE_TENSORS = (("chicago-s", (600, 24, 240), 50_000),
                  ("uber-s", (430, 110, 170), 33_000))
# (B, cap_a, cap_b) of the S_VINTER kernel: spmm's block of 64 x 64 row
# pairs, a ttv fibre block against the 240-key vector, and long rows
VINTER_SHAPES = ((4096, 128, 128), (512, 128, 256), (2048, 2048, 2048))
VINTER_OPS = ("mac", "max", "min")
VINTER_LONG = (2048, 2048, 2048)
# (nr, nc, cap_a, cap_b) of the grid form: spmm's 64 x 64 block, stacks not
# a multiple of the block's tile, and 2048 pairs of long rows (timed beside
# VINTER_LONG)
GRID_SHAPES = ((64, 64, 128, 128), (45, 37, 256, 256), (32, 64, 2048, 2048))
GRID_LONG = (32, 64, 2048, 2048)

# (B, cap_a, cap_b): mico's level-1 chunk at the smallest and the largest
# degree bucket, and youtube's 128-row chunk at its 32768-key bucket
PARITY_SHAPES = ((2048, 128, 128), (2048, 2048, 2048), (128, 128, 32768))
TIMED_SHAPE = (2048, 2048, 2048)
# (B, cap_a, k, cap_b) of the k-reference kernel; the last stack (3 x 32768
# keys) is past shared memory and takes the global-memory search. Each shape
# runs every polarity of MULTI_POLS (k = len(pol)) bit for bit, and is timed
# with k - 1 INTER references then one SUB (4-cycle's count level: k = 2).
MULTI_SHAPES = ((2048, 128, 2, 128), (2048, 2048, 2, 2048), (128, 128, 3, 32768))
MULTI_POLS = ((1,), (0,), (1, 0), (0, 0), (1, 1, 0))
MULTI_TIMED = (2048, 2048, 2, 2048)
# the leaves' CSR-operand forms on a synthetic CSR of sorted_rows' live keys
# (rows start on any 4-byte boundary, some are empty, the last vertex is
# read): (B, cap_a, cap_b, cut) of the count form, each row read at
# cap // cut, so cut 2 cuts every row past its first cap // 2 keys; caps up
# to 1024 run a warp a row, 2048 a block a row, 32768 past shared memory
CSR_SHAPES = ((2048, 128, 128, 1), (2048, 1024, 1024, 1), (2048, 2048, 2048, 1),
              (2048, 2048, 2048, 2), (128, 128, 32768, 1))
# (B, cap_a, k, cap_b, cut) of the aggregate form; odd references read at
# half the cap
CSR_AGG_SHAPES = ((2048, 128, 2, 128, 1), (2048, 1024, 1, 1024, 1), (2048, 1024, 2, 1024, 1),
                  (2048, 2048, 2, 2048, 1), (2048, 2048, 2, 2048, 2), (128, 128, 3, 32768, 1))
# the weighted triangle leaf's shape: one INTER reference, a warp a row
CSR_AGG_TRIANGLE = (2048, 1024, 1, 1024)
# the SUB and general levels' CSR forms run on CSR_AGG_SHAPES too, timed at
# MULTI_TIMED (a block a row) and at this warp-a-row shape, the path's usual
# bucket
CSR_LEVEL_WARP = (2048, 1024, 2, 1024)
# the INTER expand level's CSR form and items pass: CSR_SHAPES, and A's
# window past shared memory; timed at TIMED_SHAPE and this warp-a-row shape
EXPAND_SHAPES = CSR_SHAPES + ((128, 32768, 2048, 1),)
EXPAND_WARP = (2048, 1024, 1024)
# compact-rows: (B, cap, out_cap) x keep densities; (4096, 256, 64) cuts
# rows; (2048, 1023, 1023) takes the scalar loads (each shape also runs on
# views at a storage offset); COMPACT_WARP is the warp-a-row team's timed
# shape; the team sweep times both teams at these caps
COMPACT_SHAPES = (((2048, 2048, 2048), (0.05, 0.3, 1.0)), ((2048, 128, 128), (0.3,)),
                  ((2048, 256, 256), (0.3,)), ((4096, 256, 64), (0.3, 1.0)),
                  ((2048, 1023, 1023), (0.3,)))
COMPACT_TIMED = (2048, 2048, 2048, 0.3)
COMPACT_WARP = (2048, 256, 256, 0.3)
COMPACT_SWEEP = (128, 256, 512, 1024, 2048)
# bitmap words a row: mico's 96600 vertices (3019 words, padded to 3072),
# one tile, and youtube's 1048576 vertices
BITMAP_SHAPES = ((2048, 3072), (128, 256), (64, 32768))
BITMAP_TIMED = (2048, 3072)
# the JAX package's counts for the forest and host phases (as MAIN_PATH's):
# wiki-vote's 4-clique, and benchmarks/baseline.json's session mix on
# email-eu-core 0.25 (session.counts, exec_cache_entries) and forest report
# on email-eu-core 1.0 (forest.feed_passes, level2_execs, level2_ops_static)
WIKI_4CLIQUE = 14458
SESSION_COUNTS = {"T": 11502, "TC": 138732, "TT": 1769583, "4C": 10622,
                  "4M": {"4-clique": 10622, "diamond": 151646, "4-cycle": 161630,
                         "paw": 1035535, "4-path": 3252244, "4-star": 1652486}}
SESSION_EXEC_ENTRIES = 20
FOREST_REPORT = {"feed_passes": (6, 2), "level2_execs": (19, 10),
                 "level2_ops_static": (6, 3)}
# the JAX engine's counters for 4M through count_many on email-eu-core 0.25
HOST_4M = {"device_compactions": 0, "host_compactions": 3, "items": 358319,
           "level_kernel_dispatches": 45, "host_syncs": 45}
HOST_4M_EXECS = {("expand", 2): 3, ("count", 3): 42}
# The JAX package's embeddings (Miner.embeddings, an (N, k) int32 matrix) as
# (rows, sha256 of the matrix's C-order int32 bytes), from
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "import hashlib, numpy as np; \
#     from repro.graph import get_dataset; from repro.mining.session import Miner; \
#     e = np.ascontiguousarray(Miner(get_dataset(NAME, SCALE), backend='xla') \
#     .embeddings(QUERY), dtype=np.int32); \
#     print(len(e), hashlib.sha256(e.tobytes()).hexdigest())"
# mico's emit levels are INTER levels (the expand kernel's CSR form and the
# items pass); diamond's is a SUB level (the mark kernel), 4-cycle's a
# general one (the k-reference kernel)
EMIT = (
    ("mico", 1.0, (
        ("triangle", 71459, "93418e41328ed60901478b211226556a2e353bd6185389d5793ee4b4d715abe9"),
        ("4-clique", 4682, "3dbbfea408140387d81b30f8a6121a170aaf0261feb01f429c008558f792ac97"))),
    ("email-eu-core", 0.25, (
        ("diamond", 151646, "3c60aa9ab19cf1cca8ce98eabd3b8b47fd6afcacf4fe255276a9bc2f5bd8c9db"),
        ("4-cycle", 161630, "2f165d8e154ae8670d3717a2a5519a4d61f4e0df8daaef1ff7347d70caf0c031"))),
)
# youtube's 10152197 triangles (122 MB of rows) are checked on the card:
# v0 > v1 > v2, every pair an edge, no row twice
EMIT_CHECKED = ("youtube", 1.0, "triangle")
# FSM and sFSM (mining.fsm) on email-eu-core 1.0, labels random_labels(V, 4,
# seed=1), support 100, max_edges 3: the JAX package's (patterns, sha256 of
# repr(sorted(result.items()))), from
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "import hashlib; from \
#     repro.graph import get_dataset; from repro.mining.fsm import FN, \
#     random_labels; g = get_dataset('email-eu-core', 1.0); r = FN(g, \
#     random_labels(g.num_vertices, 4, seed=1), 100, max_edges=3); \
#     print(len(r), hashlib.sha256(repr(sorted(r.items())).encode()).hexdigest())"
FSM_CELL = ("email-eu-core", 1.0, 4, 100, 3)
FSM_WANT = {"fsm": (286, "2ea986624461b94a7b962794c185bd30f6d2f581c893aea3afb81976b720fe0e"),
            "sfsm": (286, "72845a3e76312afa4a106fbcb543a184b67198fb619b146c9b045b293a058d9a")}
# benchmarks/baseline.json's exact.telemetry.email-eu-core@0.25.* (the JAX
# package's traced session mix: T, TC, TT, 4C, then the 4-motifs through
# count_many)
TELEMETRY = {
    "span_counts": {"dispatch": 43, "level": 49, "span": 20},
    "runner_stats": {"count_rides": 0, "device_compactions": 4, "exec_hits": 32,
                     "exec_misses": 20, "host_compactions": 0, "host_syncs": 46,
                     "items": 369821, "level_kernel_dispatches": 43},
    "session_counters": {"plan_hits": 0, "plan_misses": 4, "queries": 5,
                         "schedule_hits": 0, "schedule_misses": 1},
    "registry_equals_legacy": True, "enabled_disabled_parity": True,
}
# the shard phase's mesh, eight shards on the first card, and benchmarks/
# baseline.json's exact.sharded.email-eu-core@0.25.* and
# exact.telemetry.email-eu-core@0.25.mesh8.* (the JAX package's counters on
# an 8-device mesh: ci_gate.py's measure_sharded and measure_telemetry mixes)
SHARDS = 8
SHARD_DEVICES = ("cuda:0",) * SHARDS
SHARD_FEED = [4743, 4743, 4743, 4743, 4743, 4743, 4740, 4737]
SHARDED = {"dispatches_per_pass": {1: 43, 8: 16}, "psum_reductions_per_pass": 12,
           "shard_feed_items": SHARD_FEED, "rebuilds_second_pass": 0}
TELEMETRY_MESH8 = {
    "span_counts": {"dispatch": 16, "level": 22, "span": 20},
    "runner_stats": {"count_rides": 0, "device_compactions": 4, "exec_hits": 5,
                     "exec_misses": 20, "host_compactions": 0, "host_syncs": 19,
                     "items": 369821, "level_kernel_dispatches": 16,
                     "psum_reductions": 12, "shard_feed_items": SHARD_FEED},
    "session_counters": TELEMETRY["session_counters"],
    "registry_equals_legacy": True, "enabled_disabled_parity": True,
}
# mico's queries at mesh 8 against MAIN_PATH's counts; the kernels the shard
# phase must launch (rows 1-5 of PERF.md's table, the expand's items pass too)
SHARD_MICO = ("triangle", "4-clique", "5-clique", "three-chain-induced", "diamond", "paw")
SHARD_KERNELS = ("intersect_count", "intersect_expand", "expand_items", "intersect_mark",
                 "intersect_multi", "intersect_multi_agg")
# the serve phase: a MiningService over one card session on mico (the
# weighted graph, so one pool serves counts and the values class), three
# rounds of these requests submitted together and one tick, each answered
# by MAIN_PATH's counts, beside a weighted triangle sum (WEIGHTED's); then a
# burst of SERVE_LOAD[0] count requests from SERVE_LOAD[1] client threads
SERVE_REQUESTS = (("triangle",), ("three-chain-induced",), ("4-clique",), ("5-clique",),
                  ("diamond", "paw"))
SERVE_ROUNDS = 3
SERVE_LOAD = (15, 4)
# benchmarks/bench_serving.py's request mix and benchmarks/baseline.json's
# exact.serving.email-eu-core@0.25.* (the JAX package's ci_gate.py
# measure_serving with --sharded); the ratio keys are wall ratios, printed
SERVING_MIX = (("triangle",), ("three-chain",), ("tailed-triangle",), ("4-clique",),
               ("4-clique", "diamond", "4-cycle", "paw", "4-path", "4-star"))
SERVING_LABELS = ("T", "TC", "TT", "4C") + SERVING_MIX[-1]
SERVING = {
    "counts": {"T": 11502, "TC": 138732, "TT": 1769583, "4C": 10622, "4-clique": 10622,
               "diamond": 151646, "4-cycle": 161630, "paw": 1035535, "4-path": 3252244,
               "4-star": 1652486},
    "batch_requests": 5, "feed_passes": [6, 2], "sharing_ok": True, "steady_retraces": 0,
    "cache": {"cached_tick_executed": 0, "entries": 9, "entries_after_bump": 0,
              "first_pass_misses": 10, "invalidations": 9, "second_pass_hits": 10},
    "load_sharing_ok": True, "load_retraces": 0,
    "mesh8.counts_parity": True, "mesh8.workers": ["bulk", "default"],
    "mesh8.sharing_ok": True, "mesh8.steady_retraces": 0,
}
SERVING_LOAD = (24, 4)
# the isa phase: seeded random sorted streams, (cap_a, cap_b, fill), keys over
# [0, 4 * max cap); values dyadic on even cases, in [0.5, 2) on odd ones; the
# ops the ISA routes through kernels, and S_NESTINTER over mico's hub
ISA_CASES = ((128, 128, 0.9), (256, 1024, 0.5), (1024, 256, 0.7), (2048, 2048, 0.6),
             (4096, 4096, 0.8), (4096, 128, 0.3), (512, 4096, 1.0))
ISA_KERNELS = ("intersect_count", "intersect_mark", "compact_rows", "vinter")
# the bitmap crossover sweep (benchmarks/bench_kernels.py): 128 rows of up
# to 1024 keys over a key space of 8192, at these fractions of it
CROSSOVER = (128, 1024, 8192, (0.01, 0.05, 0.1, 0.2, 0.4))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
INT_OPS_PER_S = 67e12          # H100 SXM non-tensor fp32 rate, as the int rate
SENTINEL = 2**31 - 1
DEVICE = "cuda"

KERNELS = {
    "intersect_count": dict(route="cuda",
                            source="src/repro_torch/kernels/csrc/intersect.cu",
                            replaces="src/repro/kernels/intersect.py:187"),
    "intersect_expand": dict(route="cuda",
                             source="src/repro_torch/kernels/csrc/intersect.cu",
                             replaces="src/repro/kernels/intersect.py:214"),
    # the INTER expand level's worklist: what the JAX package leaves to XLA's
    # scatter in batch_compact_scan (no Pallas kernel)
    "expand_items": dict(route="cuda", source="src/repro_torch/kernels/csrc/intersect.cu",
                         replaces="src/repro/core/batch.py:104"),
    "intersect_mark": dict(route="cuda",
                           source="src/repro_torch/kernels/csrc/intersect.cu",
                           replaces="src/repro/kernels/intersect.py:250"),
    "intersect_multi": dict(route="cuda",
                            source="src/repro_torch/kernels/csrc/intersect.cu",
                            replaces="src/repro/kernels/intersect.py:326"),
    "intersect_multi_agg": dict(route="cuda",
                                source="src/repro_torch/kernels/csrc/intersect.cu",
                                replaces="src/repro/kernels/intersect.py:482"),
    "vinter": dict(route="cuda", source="src/repro_torch/kernels/csrc/svinter.cu",
                   replaces="src/repro/kernels/svinter.py:59"),
    "compact_rows": dict(route="cuda", source="src/repro_torch/kernels/csrc/compact.cu",
                         replaces="src/repro/kernels/compact.py:47"),
    "bitmap_and_count": dict(route="cuda", source="src/repro_torch/kernels/csrc/bitmap.cu",
                             replaces="src/repro/kernels/bitmap.py:55"),
}
# the count path's kernels (phase 4); the weighted path (5) drives
# intersect_multi_agg, the sparse path (6) vinter, the host path (8)
# compact_rows and the bitmap path (9) bitmap_and_count
COUNT_KERNELS = ("intersect_count", "intersect_expand", "expand_items", "intersect_mark",
                 "intersect_multi")


def wrappers() -> dict:
    """Kernel name -> its wrapper, whose ``launches`` counts kernel launches;
    also ``vinter_grid``, the S_VINTER kernel's grid form, where the tree
    has it (a parent measured with --src may not)."""
    from repro_torch.kernels import bitmap, compact, intersect, svinter
    module = {"vinter": svinter, "compact_rows": compact, "bitmap_and_count": bitmap}
    out = {name: getattr(module.get(name, intersect), name) for name in KERNELS}
    if hasattr(svinter, "vinter_grid"):
        out["vinter_grid"] = svinter.vinter_grid
    return out


def zero_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def exact_sum(value: float, edges: int) -> bool:
    """Whether every summation order gives ``value`` exactly: positive
    multiples of 4^-edges, each partial at most the total, below 2^24 units."""
    return abs(value) < 2.0 ** (24 - 2 * edges)


def sorted_rows(gen, rows: int, cap: int, span: int, empty_frac: float = 0.05):
    """(rows, cap) int32 sorted sets over [0, ~span), random lengths, some
    empty, SENTINEL-padded, made on the card from ``gen``."""
    dev = gen.device
    step = max(2, (2 * span) // cap)
    gaps = torch.randint(1, step, (rows, cap), generator=gen, device=dev)
    keys = torch.cumsum(gaps, dim=1) - 1
    lens = torch.randint(0, cap + 1, (rows,), generator=gen, device=dev)
    lens[torch.rand(rows, generator=gen, device=dev) < empty_frac] = 0
    col = torch.arange(cap, device=dev)
    return torch.where(col[None] < lens[:, None], keys, SENTINEL).to(torch.int32)


def bound_vectors(gen, rows: int, span: int):
    """bounds from {SENTINEL, random, 0}; lbounds -1 or random below."""
    dev = gen.device
    pick = torch.randint(0, 3, (rows,), generator=gen, device=dev)
    rnd = torch.randint(0, span, (rows,), generator=gen, device=dev)
    bounds = torch.where(pick == 0, SENTINEL, torch.where(pick == 1, rnd, 0))
    low = torch.randint(0, 2, (rows,), generator=gen, device=dev) == 1
    lbounds = torch.where(low, rnd // 3, -1)
    return bounds.to(torch.int32), lbounds.to(torch.int32)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, warmed up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(fn, reps: int = 20, host_calls: int = 1000) -> dict:
    """Three times of one wrapper call ``fn()``, which launches one kernel:

      ms         call ms: CUDA events around ``reps`` back-to-back calls
                 (``cuda_ms``); the host's cost of a call when the card
                 finishes first
      device_ms  the kernel's own device time per launch, from
                 torch.profiler's CUDA activity over ``reps`` calls (the
                 mean over the launches the trace holds)
      host_us    host microseconds per call: ``host_calls`` calls timed by
                 the host clock with no synchronize between them
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ms = cuda_ms(fn, reps)
    # the wrapper launches its kernel and nothing else on the card; a trace
    # may miss launches at its edges, or all of them now and then: the mean
    # is over the launches held by the first of three traces that holds any
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and not e.key.startswith(("Memcpy", "Memset"))]
        if dev:
            break
    launched = sum(e.count for e in dev)
    if not 0 < launched <= reps or len(dev) != 1:
        raise SystemExit(f"[times] the profiler saw {launched} launches of {len(dev)} "
                         f"kernels for {reps} calls: {[e.key[:60] for e in dev]}")
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3 / launched
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(host_calls):
        fn()
    host_us = (time.perf_counter() - t0) / host_calls * 1e6
    torch.cuda.synchronize()
    return {"ms": ms, "device_ms": device_ms, "host_us": host_us}


def _times_text(t: dict) -> str:
    return (f"{t['device_ms']:.4f} ms device, {t['ms']:.4f} ms a call, "
            f"{t['host_us']:.1f} us host")


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def phase_card() -> str:
    out = card_name()
    print(out, flush=True)
    print(f"[card] torch {torch.__version__} CUDA {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}",
          flush=True)
    return out


def phase_build():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build.load, names)))
    print(f"[build] {', '.join(n + '.cu' for n in names)} in parallel: "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for name, lib in libs.items():
        print(f"[build] {name}.cu: nvcc {lib.build_seconds:.2f}s -> {lib.path.name}",
              flush=True)
        for ln in lib.ptxas_report.splitlines():
            print(f"[build]   {ln.strip()}", flush=True)


def _window_keys(x, bounds, lbounds) -> int:
    """Keys of the rows ``x`` (B, cap) or stack (k, B, cap) inside each
    row's (lbound, bound) window: what any implementation must read."""
    return int(((x > lbounds[:, None]) & (x < bounds[:, None])).sum())


def _bound(B: int, cap_b: int, live: int, a_live: int, k: int, out_bytes: int,
           extra_in: int = 0) -> tuple[float, str]:
    """(bound ms, what bounds it): the window keys and the per-row operands
    read once, the outputs written once, at 3.35 TB/s; or k binary searches
    of log2(cap_b) integer compares per A window key at the int rate."""
    bytes_ms = ((live + 2 * B + extra_in) * 4 + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = a_live * k * max(1, (cap_b - 1).bit_length()) / INT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _record(report: dict, name: str, err: int) -> None:
    report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)


def _parity_pair(K, report, gen, B, cap_a, cap_b):
    """count, expand and mark at one shape: bit for bit, then timed."""
    span = 2 * cap_b
    a = sorted_rows(gen, B, cap_a, span)
    b = sorted_rows(gen, B, cap_b, span)
    bounds, lbounds = bound_vectors(gen, B, span)
    for bd, lbd in ((bounds, lbounds), (None, None)):
        got_c = K.intersect_count(a, b, bd, lbd)
        want_c = K.intersect_count_ref(a, b, bd, lbd)
        got_m, got_mc = K.intersect_expand(a, b, bd, lbd)
        want_m, want_mc = K.intersect_expand_ref(a, b, bd, lbd)
        got_k = K.intersect_mark(a, b, bd, lbd)
        want_k = K.intersect_mark_ref(a, b, bd, lbd)
        torch.cuda.synchronize()
        errs = {"intersect_count": (got_c - want_c).abs().max().item(),
                "intersect_expand": max((got_m - want_m).abs().max().item(),
                                        (got_mc - want_mc).abs().max().item()),
                "intersect_mark": (got_k - want_k).abs().max().item()}
        for name, err in errs.items():
            _record(report, name, err)
        if not (torch.equal(got_c, want_c) and torch.equal(got_m, want_m)
                and torch.equal(got_mc, want_mc) and torch.equal(got_k, want_k)):
            raise SystemExit(f"[parity] MISMATCH at B={B} caps=({cap_a},{cap_b}) "
                             f"bounds={'set' if bd is not None else 'None'}: {errs}")
    hits = int(K.intersect_count_ref(a, b, bounds, lbounds).sum())
    args = (a, b, bounds, lbounds)
    t = {name: (kernel_times(lambda f=getattr(K, name): f(*args)),
                cuda_ms(lambda f=getattr(K, name + "_ref"): f(*args)))
         for name in ("intersect_count", "intersect_expand", "intersect_mark")}
    a_live = _window_keys(a, bounds, lbounds)
    live = a_live + _window_keys(b, bounds, lbounds)
    for name, (times, plain_ms) in t.items():
        out_bytes = (B * 4 if name != "intersect_mark" else 0) \
            + (B * cap_a * 4 if name != "intersect_count" else 0)
        bound_ms, by = _bound(B, cap_b, live, a_live, 1, out_bytes)
        print(f"[parity] {name} B={B} caps=({cap_a},{cap_b}) equal bit for bit; "
              f"{_times_text(times)}, {plain_ms:.4f} ms plain, bound "
              f"{bound_ms:.4f} ms ({live} window keys); hits {hits}", flush=True)
        if (B, cap_a, cap_b) == TIMED_SHAPE:
            report[name].update(**times, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=by, library_ms=None)


def _excludes(gen, a, E: int = 2):
    """(B, E) injectivity keys: keys of A at random slots (-1, the no-op,
    where a slot is padding)."""
    B, cap_a = a.shape
    col = torch.randint(0, cap_a, (B, E), generator=gen, device=a.device)
    ex = a.gather(1, col)
    return torch.where(ex == SENTINEL, -1, ex).contiguous()


def _parity_multi(K, report, gen, B, cap_a, k, cap_b):
    """The k-reference kernel at one shape, over every polarity, with and
    without bounds and excludes: bit for bit; timed at MULTI_TIMED."""
    span = 2 * cap_b
    a = sorted_rows(gen, B, cap_a, span)
    bs_all = torch.stack([sorted_rows(gen, B, cap_b, span) for _ in range(3)])
    bounds, lbounds = bound_vectors(gen, B, span)
    excl = _excludes(gen, a)
    kept = {}
    for pol in MULTI_POLS:
        bs = bs_all[: len(pol)].contiguous()
        for bd, lbd, ex in ((bounds, lbounds, excl), (None, None, excl),
                            (bounds, lbounds, None), (None, None, None)):
            got_m, got_c = K.intersect_multi(a, bs, pol, bd, lbd, ex)
            want_m, want_c = K.intersect_multi_ref(a, bs, pol, bd, lbd, ex)
            torch.cuda.synchronize()
            err = max((got_m - want_m).abs().max().item(),
                      (got_c - want_c).abs().max().item())
            _record(report, "intersect_multi", err)
            if not (torch.equal(got_m, want_m) and torch.equal(got_c, want_c)):
                raise SystemExit(f"[parity] MISMATCH intersect_multi B={B} "
                                 f"cap_a={cap_a} cap_b={cap_b} pol={pol} "
                                 f"bounds={'set' if bd is not None else 'None'} "
                                 f"excludes={'set' if ex is not None else 'None'}: {err}")
        kept[pol] = int(K.intersect_multi_ref(a, bs, pol, bounds, lbounds, excl)[1].sum())
    print(f"[parity] intersect_multi B={B} cap_a={cap_a} cap_b={cap_b} pols "
          f"{list(MULTI_POLS)} equal bit for bit; kept with bounds and excludes "
          f"{kept}", flush=True)
    pol = (1,) * (k - 1) + (0,)
    bs = bs_all[:k].contiguous()
    args = (a, bs, pol, bounds, lbounds, excl)
    times = kernel_times(lambda: K.intersect_multi(*args))
    plain_ms = cuda_ms(lambda: K.intersect_multi_ref(*args))
    a_live = _window_keys(a, bounds, lbounds)
    live = a_live + _window_keys(bs, bounds, lbounds)
    bound_ms, by = _bound(B, cap_b, live, a_live, k, B * 4 + B * cap_a * 4,
                          extra_in=excl.numel())
    print(f"[parity] intersect_multi B={B} cap_a={cap_a} k={k} cap_b={cap_b} "
          f"pol={pol}: {_times_text(times)}, {plain_ms:.4f} ms plain, bound "
          f"{bound_ms:.4f} ms ({live} window keys)", flush=True)
    if (B, cap_a, k, cap_b) == MULTI_TIMED:
        report["intersect_multi"].update(**times, plain_ms=plain_ms, bound_ms=bound_ms,
                                         bound_by=by, library_ms=None)


def values_like(gen, keys, dyadic: bool = True):
    """f32 values beside ``keys`` (0.0 on SENTINEL): dyadic ({1/4, .., 1}:
    products and these sums are exact in f32 in any order), else in
    [0.5, 2) (positive, so a relative tolerance holds for sums)."""
    if dyadic:
        v = torch.randint(1, 5, keys.shape, generator=gen, device=keys.device) * 0.25
    else:
        v = torch.rand(keys.shape, generator=gen, device=keys.device) * 1.5 + 0.5
    return torch.where(keys != SENTINEL, v.float(), 0.0)


def _max_err(got, want) -> float:
    return max((g.double() - w.double()).abs().max().item() if g.numel() else 0.0
               for g, w in zip(got, want))


def _parity_agg(K, report, gen, B, cap_a, k, cap_b):
    """The value-lane kernel at one shape, over every polarity and op, with
    and without bounds and excludes: dyadic values bit for bit; values in
    [0.5, 2) with marks, counts, max and min bit for bit and sums within
    rtol 1e-6 (f32 row sums in two orders); timed at MULTI_TIMED, op sum."""
    span = 2 * cap_b
    a = sorted_rows(gen, B, cap_a, span)
    bs_all = torch.stack([sorted_rows(gen, B, cap_b, span) for _ in range(3)])
    bounds, lbounds = bound_vectors(gen, B, span)
    excl = _excludes(gen, a)
    av, bv_all = values_like(gen, a), values_like(gen, bs_all)
    sc = values_like(gen, torch.zeros_like(bounds))
    for pol in MULTI_POLS:
        bs, bv = bs_all[: len(pol)].contiguous(), bv_all[: len(pol)].contiguous()
        for bd, lbd, ex in ((bounds, lbounds, excl), (None, None, excl),
                            (bounds, lbounds, None), (None, None, None)):
            for op in AGG_OPS:
                got = K.intersect_multi_agg(a, bs, pol, av, bv, sc, op, bd, lbd, ex)
                want = K.intersect_multi_agg_ref(a, bs, pol, av, bv, sc, op, bd, lbd, ex)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                _record(report, "intersect_multi_agg", err)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise SystemExit(
                        f"[parity] MISMATCH intersect_multi_agg B={B} cap_a={cap_a} "
                        f"cap_b={cap_b} pol={pol} op={op} bounds="
                        f"{'set' if bd is not None else 'None'} excludes="
                        f"{'set' if ex is not None else 'None'}: {err}")
    pol = (1,) * (k - 1) + (0,)
    bs, bv = bs_all[:k].contiguous(), bv_all[:k].contiguous()
    nav, nbv, nsc = (values_like(gen, x, dyadic=False)
                     for x in (a, bs, torch.zeros_like(bounds)))
    for op in AGG_OPS:
        got = K.intersect_multi_agg(a, bs, pol, nav, nbv, nsc, op, bounds, lbounds, excl)
        want = K.intersect_multi_agg_ref(a, bs, pol, nav, nbv, nsc, op, bounds, lbounds,
                                         excl)
        torch.cuda.synchronize()
        _record(report, "intersect_multi_agg", _max_err(got, want))
        vals_ok = torch.allclose(got[2], want[2], rtol=1e-6, atol=0) if op == "sum" \
            else torch.equal(got[2], want[2])
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and vals_ok):
            raise SystemExit(f"[parity] MISMATCH intersect_multi_agg non-dyadic B={B} "
                             f"cap_a={cap_a} cap_b={cap_b} op={op}: {_max_err(got, want)}")
    print(f"[parity] intersect_multi_agg B={B} cap_a={cap_a} cap_b={cap_b} pols "
          f"{list(MULTI_POLS)} x {list(AGG_OPS)}: dyadic values equal bit for bit; "
          f"values in [0.5, 2) at pol={pol}: sums within rtol 1e-6, the rest bit "
          f"for bit", flush=True)
    args = (a, bs, pol, av, bv, sc, "sum", bounds, lbounds, excl)
    times = kernel_times(lambda: K.intersect_multi_agg(*args))
    plain_ms = cuda_ms(lambda: K.intersect_multi_agg_ref(*args))
    a_live = _window_keys(a, bounds, lbounds)
    ref_live = _window_keys(bs, bounds, lbounds)
    inter_live = _window_keys(bs[: k - 1], bounds, lbounds)
    # keys of A and the refs, values of A and the INTER refs, the scale and
    # the excludes in; mark, counts and vals out
    bound_ms, by = _bound(B, cap_b, a_live + ref_live, a_live, k, B * cap_a * 4 + B * 8,
                          extra_in=a_live + inter_live + B + excl.numel())
    print(f"[parity] intersect_multi_agg B={B} cap_a={cap_a} k={k} cap_b={cap_b} "
          f"pol={pol} op=sum: {_times_text(times)}, {plain_ms:.4f} ms plain, bound "
          f"{bound_ms:.4f} ms", flush=True)
    if (B, cap_a, k, cap_b) == MULTI_TIMED:
        report["intersect_multi_agg"].update(**times, plain_ms=plain_ms, bound_ms=bound_ms,
                                             bound_by=by, library_ms=None)


def csr_of(stacks, value_stacks=()):
    """One CSR whose vertices hold the live keys of the given (B, cap) row
    matrices in turn (vertex j * B + i is row i of stack j), and the value
    planes beside them, one per list of value matrices in ``value_stacks``;
    SENTINEL / 0.0-padded past the last edge. -> (indptr, indices, [values],
    [ids of each stack])."""
    live = [x != SENTINEL for x in stacks]
    lens = torch.cat([m.sum(dim=1) for m in live])
    indptr = torch.zeros(lens.numel() + 1, dtype=torch.int32, device=DEVICE)
    indptr[1:] = torch.cumsum(lens, 0)
    pad = torch.full((128,), SENTINEL, dtype=torch.int32, device=DEVICE)
    indices = torch.cat([x[m] for x, m in zip(stacks, live)] + [pad])
    values = [torch.cat([v[m] for v, m in zip(vs, live)] + [torch.zeros(128, device=DEVICE)])
              for vs in value_stacks]
    B = stacks[0].shape[0]
    ids = [torch.arange(j * B, (j + 1) * B, dtype=torch.int32, device=DEVICE)
           for j in range(len(stacks))]
    return indptr, indices, values, ids


def _parity_count_csr(K, report, gen, B, cap_a, cap_b, cut):
    """The count leaf's CSR form at one shape: A and B from the CSR, and A
    padded (a carried base) with B from the CSR, each equal bit for bit to
    the plain version and to the padded form on the rows cut at the caps;
    one launch a call; timed at TIMED_SHAPE."""
    span = 2 * cap_b
    a, b = sorted_rows(gen, B, cap_a, span), sorted_rows(gen, B, cap_b, span)
    bounds, lbounds = bound_vectors(gen, B, span)
    indptr, indices, _, (va, vb) = csr_of([a, b])
    ca, cb = cap_a // cut, cap_b // cut
    a_cut, b_cut = a[:, :ca].contiguous(), b[:, :cb].contiguous()
    for bd, lbd in ((bounds, lbounds), (None, None)):
        n0 = K.intersect_count.launches
        got = K.intersect_count_csr(indptr, indices, vb, cb, va=va, cap_a=ca, bounds=bd,
                                    lbounds=lbd)
        got_pad = K.intersect_count_csr(indptr, indices, vb, cb, a=a_cut, bounds=bd,
                                        lbounds=lbd)
        launched = K.intersect_count.launches - n0
        want = K.intersect_count_csr_ref(indptr, indices, vb, cb, va=va, cap_a=ca,
                                         bounds=bd, lbounds=lbd)
        want_pad = K.intersect_count_ref(a_cut, b_cut, bd, lbd)
        torch.cuda.synchronize()
        _record(report, "intersect_count", max((got - want).abs().max().item(),
                                               (got_pad - want).abs().max().item()))
        if not (torch.equal(got, want) and torch.equal(got_pad, want)
                and torch.equal(want, want_pad)) or launched != 2:
            raise SystemExit(f"[csr] MISMATCH intersect_count_csr B={B} caps=({ca},{cb}) "
                             f"bounds={'set' if bd is not None else 'None'}, {launched} "
                             "launches for 2 calls")
    deg = indptr[1:] - indptr[:-1]
    print(f"[csr] intersect_count_csr B={B} caps=({ca},{cb}) from rows of ({cap_a},{cap_b}): "
          f"equal bit for bit (CSR and padded A); {int((deg > cb).sum())} rows cut, "
          f"{int((deg == 0).sum())} empty, {int((indptr[:-1] % 4 != 0).sum())} starts "
          f"off 16 bytes, {int((bounds == 0).sum())} bound-0 rows", flush=True)
    if (B, cap_a, cap_b) != TIMED_SHAPE or cut != 1:
        return
    args = (indptr, indices, vb, cap_b)
    kw = dict(va=va, cap_a=cap_a, bounds=bounds, lbounds=lbounds)
    times = kernel_times(lambda: K.intersect_count_csr(*args, **kw))
    plain_ms = cuda_ms(lambda: K.intersect_count_csr_ref(*args, **kw))
    a_live = _window_keys(a, bounds, lbounds)
    bound_ms, _ = _bound(B, cap_b, a_live + _window_keys(b, bounds, lbounds), a_live, 1,
                         B * 4)
    print(f"[csr] intersect_count_csr B={B} caps=({cap_a},{cap_b}): {_times_text(times)}, "
          f"{plain_ms:.4f} ms plain (padded_rows gathers + count), bound {bound_ms:.4f} ms",
          flush=True)
    report["intersect_count"].update({f"csr_{name}": v for name, v in times.items()},
                                     csr_plain_ms=plain_ms, csr_bound_ms=bound_ms)


def _parity_agg_csr(K, report, gen, B, cap_a, k, cap_b, cut):
    """The aggregate leaf's CSR form (no mark) at one shape, over the
    polarities of at most k refs, every op, with and without bounds and
    excludes, and three bases (CSR rows with their values, padded rows with
    1.0, padded rows with a_vals): dyadic values bit for bit against the
    plain version; values in [0.5, 2) with counts, max and min bit for bit
    and sums within rtol 1e-6; timed with a CSR base at MULTI_TIMED and at
    the weighted triangle leaf's shape."""
    span = 2 * cap_b
    a = sorted_rows(gen, B, cap_a, span)
    bs = [sorted_rows(gen, B, cap_b, span) for _ in range(k)]
    dy = [values_like(gen, x) for x in (a, *bs)]
    nd = [values_like(gen, x, dyadic=False) for x in (a, *bs)]
    indptr, indices, (vals, nvals), ids = csr_of([a, *bs], [dy, nd])
    va, vbs_all = ids[0], torch.stack(ids[1:])
    bounds, lbounds = bound_vectors(gen, B, span)
    excl = _excludes(gen, a)
    sc, nsc = values_like(gen, torch.zeros_like(bounds)), values_like(
        gen, torch.zeros_like(bounds), dyadic=False)
    ca, cb = cap_a // cut, cap_b // cut
    a_cut, av_cut = a[:, :ca].contiguous(), dy[0][:, :ca].contiguous()
    bases = {"csr": dict(va=va, cap_a=ca), "padded 1.0": dict(a=a_cut),
             "padded a_vals": dict(a=a_cut, a_vals=av_cut)}
    for pol in (p for p in MULTI_POLS if len(p) <= k):
        vbs = vbs_all[: len(pol)].contiguous()
        caps = tuple(cb if r % 2 == 0 else max(1, cb // 2) for r in range(len(pol)))
        for bd, lbd, ex in ((bounds, lbounds, excl), (None, None, None)):
            for op in AGG_OPS:
                for base, kw in bases.items():
                    args = (indptr, indices, vals, vbs, caps, pol, sc, op)
                    n0 = K.intersect_multi_agg.launches
                    got = K.intersect_multi_agg_csr(*args, **kw, bounds=bd, lbounds=lbd,
                                                    excludes=ex)
                    launched = K.intersect_multi_agg.launches - n0
                    want = K.intersect_multi_agg_csr_ref(*args, **kw, bounds=bd,
                                                         lbounds=lbd, excludes=ex)
                    torch.cuda.synchronize()
                    _record(report, "intersect_multi_agg", _max_err(got, want))
                    if not all(torch.equal(g, w) for g, w in zip(got, want)) or launched != 1:
                        raise SystemExit(
                            f"[csr] MISMATCH intersect_multi_agg_csr B={B} cap_a={ca} "
                            f"caps={caps} pol={pol} op={op} base {base} bounds="
                            f"{'set' if bd is not None else 'None'}: {_max_err(got, want)}, "
                            f"{launched} launches")
    pol = (1,) * (k - 1) + (0,)
    vbs = vbs_all[:k].contiguous()
    caps = (cb,) * k
    for op in AGG_OPS:
        args = (indptr, indices, nvals, vbs, caps, pol, nsc, op)
        kw = dict(va=va, cap_a=ca, bounds=bounds, lbounds=lbounds, excludes=excl)
        got = K.intersect_multi_agg_csr(*args, **kw)
        want = K.intersect_multi_agg_csr_ref(*args, **kw)
        torch.cuda.synchronize()
        _record(report, "intersect_multi_agg", _max_err(got, want))
        vals_ok = torch.allclose(got[1], want[1], rtol=1e-6, atol=0) if op == "sum" \
            else torch.equal(got[1], want[1])
        if not (torch.equal(got[0], want[0]) and vals_ok):
            raise SystemExit(f"[csr] MISMATCH intersect_multi_agg_csr non-dyadic B={B} "
                             f"cap_a={ca} cap_b={cb} op={op}: {_max_err(got, want)}")
    print(f"[csr] intersect_multi_agg_csr B={B} cap_a={ca} k={k} cap_b={cb} (odd refs "
          f"{max(1, cb // 2)}) from rows of ({cap_a},{cap_b}): pols "
          f"{[p for p in MULTI_POLS if len(p) <= k]} x {list(AGG_OPS)} x {list(bases)}: "
          f"dyadic values equal bit for bit; values in [0.5, 2): sums within rtol 1e-6, "
          f"the rest bit for bit", flush=True)
    if (B, cap_a, k, cap_b) not in (MULTI_TIMED, CSR_AGG_TRIANGLE) or cut != 1:
        return
    # MULTI_TIMED: k - 1 INTER refs then a SUB; the triangle leaf: its INTER ref
    n_int = k if (B, cap_a, k, cap_b) == CSR_AGG_TRIANGLE else k - 1
    pol = (1,) * n_int + (0,) * (k - n_int)
    args = (indptr, indices, vals, vbs, caps, pol, sc, "sum")
    kw = dict(va=va, cap_a=cap_a, bounds=bounds, lbounds=lbounds, excludes=excl)
    times = kernel_times(lambda: K.intersect_multi_agg_csr(*args, **kw))
    plain_ms = cuda_ms(lambda: K.intersect_multi_agg_csr_ref(*args, **kw))
    a_live = _window_keys(a, bounds, lbounds)
    stack = torch.stack(bs)
    ref_live = _window_keys(stack, bounds, lbounds)
    inter_live = _window_keys(stack[:n_int], bounds, lbounds)
    # keys of A and the refs, values of A and the INTER refs, the scale and
    # the excludes in; counts and vals out: no mark
    bound_ms, _ = _bound(B, cap_b, a_live + ref_live, a_live, k, B * 8,
                         extra_in=a_live + inter_live + B + excl.numel())
    print(f"[csr] intersect_multi_agg_csr B={B} cap_a={cap_a} k={k} cap_b={cap_b} "
          f"pol={pol} op=sum, no mark: {_times_text(times)}, {plain_ms:.4f} ms plain, "
          f"bound {bound_ms:.4f} ms", flush=True)
    if (B, cap_a, k, cap_b) != MULTI_TIMED:
        return
    report["intersect_multi_agg"].update({f"csr_{name}": v for name, v in times.items()},
                                         csr_plain_ms=plain_ms, csr_bound_ms=bound_ms)


def _check_level_form(K, report, name: str, label: str, run, want, launches: int):
    """One call of a CSR form: its output (a tensor or a tuple of them) bit
    for bit against its plain version's ``want``, ``launches`` launches on
    ``name``'s counter. Returns the output."""
    counter = getattr(K, name)
    n0 = counter.launches
    got = run()
    launched = counter.launches - n0
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max((g.long() - w.long()).abs().max().item() if g.numel() else 0
              for g, w in pairs)
    _record(report, name, err)
    if not all(g.dtype == w.dtype and torch.equal(g, w) for g, w in pairs) \
            or launched != launches:
        raise SystemExit(f"[csr] MISMATCH {label}: max err {err}, {launched} launches")
    return got


def _time_level_form(K, report, name: str, key: str, label: str, run, plain, bound) -> None:
    """Times of one CSR form beside its plain version and its bound; kept in
    ``report[name]`` under ``key`` at the timed shape."""
    times = kernel_times(run)
    plain_ms = cuda_ms(plain)
    bound_ms, by = bound
    print(f"[csr] {label}: {_times_text(times)}, {plain_ms:.4f} ms plain (gathers + "
          f"padded plain), bound {bound_ms:.4f} ms ({by})", flush=True)
    if key:
        report[name].update({f"{key}_{n}": v for n, v in times.items()},
                            **{f"{key}_plain_ms": plain_ms, f"{key}_bound_ms": bound_ms})


def _parity_level_csr(K, report, gen, B, cap_a, k, cap_b, cut):
    """The SUB and general levels' CSR forms at one shape: the SUB count leaf
    (CSR and padded base), the INTER and SUB marks over a padded base, the
    general count leaf (CSR and padded base) and the general expand mark,
    over the polarities of at most k refs (odd refs at half the cap), with
    and without bounds and E = 2 excludes, bit for bit against their plain
    versions; timed at MULTI_TIMED and CSR_LEVEL_WARP."""
    span = 2 * cap_b
    a = sorted_rows(gen, B, cap_a, span)
    bs = [sorted_rows(gen, B, cap_b, span) for _ in range(k)]
    indptr, indices, _, ids = csr_of([a, *bs])
    va, vbs_all = ids[0], torch.stack(ids[1:])
    bounds, lbounds = bound_vectors(gen, B, span)
    excl = _excludes(gen, a)
    ca, cb = cap_a // cut, cap_b // cut
    a_cut = a[:, :ca].contiguous()
    csr = (indptr, indices)
    bases = {"csr": dict(va=va, cap_a=ca), "padded": dict(a=a_cut)}
    shape = f"B={B} cap_a={ca} cap_b={cb}"
    for bd, lbd in ((bounds, lbounds), (None, None)):
        bk = dict(bounds=bd, lbounds=lbd)
        tag = f"bounds={'set' if bd is not None else 'None'}"
        for base, kw in bases.items():
            args = (*csr, vbs_all[0], cb)
            _check_level_form(K, report, "intersect_mark", f"sub_count_csr {shape} {base} {tag}",
                              lambda: K.intersect_sub_count_csr(*args, **kw, **bk),
                              K.intersect_sub_count_csr_ref(*args, **kw, **bk), 1)
        for sub in (False, True):
            args = (*csr, a_cut, vbs_all[0], cb, sub)
            _check_level_form(K, report, "intersect_mark", f"mark_csr {shape} sub={sub} {tag}",
                              lambda: K.intersect_mark_csr(*args, **bk),
                              K.intersect_mark_csr_ref(*args, **bk), 1)
    pols = [p for p in MULTI_POLS if len(p) <= k]
    for pol in pols:
        vbs = vbs_all[: len(pol)].contiguous()
        caps = tuple(cb if r % 2 == 0 else max(1, cb // 2) for r in range(len(pol)))
        for bd, lbd, ex in ((bounds, lbounds, excl), (None, None, excl),
                            (bounds, lbounds, None), (None, None, None)):
            bk = dict(bounds=bd, lbounds=lbd, excludes=ex)
            tag = (f"pol={pol} bounds={'set' if bd is not None else 'None'} "
                   f"excludes={'set' if ex is not None else 'None'}")
            for base, kw in bases.items():
                args = (*csr, vbs, caps, pol)
                _check_level_form(K, report, "intersect_multi",
                                  f"multi_csr {shape} {base} {tag}",
                                  lambda: K.intersect_multi_csr(*args, **kw, **bk),
                                  K.intersect_multi_csr_ref(*args, **kw, **bk), 1)
            args = (*csr, a_cut, vbs, caps, pol)
            _check_level_form(K, report, "intersect_multi", f"multi_mark_csr {shape} {tag}",
                              lambda: K.intersect_multi_mark_csr(*args, **bk),
                              K.intersect_multi_mark_csr_ref(*args, **bk), 1)
    deg = indptr[1:] - indptr[:-1]
    print(f"[csr] SUB / general level forms {shape} (odd refs {max(1, cb // 2)}) from rows "
          f"of ({cap_a},{cap_b}): sub_count_csr x 2 bases, mark_csr INTER and SUB, "
          f"multi_csr x 2 bases and multi_mark_csr over pols {pols} x bounds x excludes: "
          f"equal bit for bit; {int((deg > cb).sum())} rows cut, {int((deg == 0).sum())} "
          f"empty, {int((indptr[:-1] % 4 != 0).sum())} starts off 16 bytes, "
          f"{int((bounds == 0).sum())} bound-0 rows", flush=True)
    if (B, cap_a, k, cap_b) not in (MULTI_TIMED, CSR_LEVEL_WARP) or cut != 1:
        return
    key = "csr" if (B, cap_a, k, cap_b) == MULTI_TIMED else "csr_warp"
    pol = (1,) * (k - 1) + (0,)
    vbs = vbs_all[:k].contiguous()
    caps = (cap_b,) * k
    a_live = _window_keys(a, bounds, lbounds)
    ref_live = _window_keys(torch.stack(bs), bounds, lbounds)
    b0_live = _window_keys(bs[0], bounds, lbounds)
    mark_bytes = B * cap_a          # a 1-byte mark
    forms = (
        ("intersect_mark", "sub_count", f"sub_count_csr B={B} caps=({cap_a},{cap_b}) CSR base",
         lambda: K.intersect_sub_count_csr(*csr, vbs[0], cap_b, va=va, cap_a=cap_a,
                                           bounds=bounds, lbounds=lbounds),
         lambda: K.intersect_sub_count_csr_ref(*csr, vbs[0], cap_b, va=va, cap_a=cap_a,
                                               bounds=bounds, lbounds=lbounds),
         _bound(B, cap_b, a_live + b0_live, a_live, 1, B * 4)),
        ("intersect_mark", "mark", f"mark_csr B={B} caps=({cap_a},{cap_b}) SUB, bool mark",
         lambda: K.intersect_mark_csr(*csr, a, vbs[0], cap_b, True, bounds, lbounds),
         lambda: K.intersect_mark_csr_ref(*csr, a, vbs[0], cap_b, True, bounds, lbounds),
         _bound(B, cap_b, a_live + b0_live, a_live, 1, mark_bytes)),
        ("intersect_multi", "count", f"multi_csr B={B} cap_a={cap_a} k={k} cap_b={cap_b} "
         f"pol={pol} E=2 CSR base, no mark",
         lambda: K.intersect_multi_csr(*csr, vbs, caps, pol, va=va, cap_a=cap_a,
                                       bounds=bounds, lbounds=lbounds, excludes=excl),
         lambda: K.intersect_multi_csr_ref(*csr, vbs, caps, pol, va=va, cap_a=cap_a,
                                           bounds=bounds, lbounds=lbounds, excludes=excl),
         _bound(B, cap_b, a_live + ref_live, a_live, k, B * 4, extra_in=excl.numel())),
        ("intersect_multi", "mark", f"multi_mark_csr B={B} cap_a={cap_a} k={k} "
         f"cap_b={cap_b} pol={pol} E=2, bool mark",
         lambda: K.intersect_multi_mark_csr(*csr, a, vbs, caps, pol, bounds, lbounds, excl),
         lambda: K.intersect_multi_mark_csr_ref(*csr, a, vbs, caps, pol, bounds, lbounds,
                                                excl),
         _bound(B, cap_b, a_live + ref_live, a_live, k, mark_bytes, extra_in=excl.numel())),
    )
    for name, form, label, run, plain, bound in forms:
        _time_level_form(K, report, name, f"{key}_{form}", label, run, plain, bound)


def _parity_expand_csr(K, report, gen, B, cap_a, cap_b, cut):
    """The INTER expand level's CSR form at one shape, a CSR and a padded
    (carried) base, bounds set and None, out_cap at min(cap_a, cap_b) and
    above it; then the items pass on its rows at the engine's out_items and
    below the total: bit for bit against the plain versions, one launch a
    call each; timed at TIMED_SHAPE (a block a row) and EXPAND_WARP."""
    span = 2 * cap_b
    a, b = sorted_rows(gen, B, cap_a, span), sorted_rows(gen, B, cap_b, span)
    bounds, lbounds = bound_vectors(gen, B, span)
    indptr, indices, _, (va, vb) = csr_of([a, b])
    ca, cb = cap_a // cut, cap_b // cut
    csr = (indptr, indices, vb, cb)
    bases = {"csr": dict(va=va, cap_a=ca), "padded": dict(a=a[:, :ca].contiguous())}
    shape = f"B={B} caps=({ca},{cb})"
    totals = []
    for bd, lbd in ((bounds, lbounds), (None, None)):
        bk = dict(bounds=bd, lbounds=lbd)
        tag = f"bounds={'set' if bd is not None else 'None'}"
        for base, kw in bases.items():
            for out_cap in (min(ca, cb), max(ca, cb) + 128):
                rows, counts = _check_level_form(
                    K, report, "intersect_expand",
                    f"expand_csr {shape} out_cap={out_cap} {base} {tag}",
                    lambda: K.intersect_expand_csr(*csr, out_cap, **kw, **bk),
                    K.intersect_expand_csr_ref(*csr, out_cap, **kw, **bk), 1)
            offs = torch.cumsum(counts, 0, dtype=torch.int32) - counts
            total = int(counts.sum())
            totals.append(total)
            for items in (B * min(ca, cb), max(1, total // 2)):
                _check_level_form(K, report, "expand_items",
                                  f"items {shape} out_items={items} {base} {tag}",
                                  lambda: K.expand_items(rows, counts, offs, items),
                                  K.expand_items_ref(rows, counts, offs, items), 1)
    deg = indptr[1:] - indptr[:-1]
    print(f"[csr] expand_csr and expand_items {shape} from rows of ({cap_a},{cap_b}): "
          f"CSR and padded base x bounds x 2 out_caps, items at B x out_cap and half the "
          f"total: equal bit for bit; survivors {totals}; "
          f"{int((deg[:B] > ca).sum() + (deg[B:] > cb).sum())} rows cut, "
          f"{int((deg == 0).sum())} empty, {int((indptr[:-1] % 4 != 0).sum())} starts off "
          f"16 bytes, {int((bounds == 0).sum())} bound-0 rows", flush=True)
    if (B, cap_a, cap_b) not in (TIMED_SHAPE, EXPAND_WARP) or cut != 1:
        return
    key = "csr" if (B, cap_a, cap_b) == TIMED_SHAPE else "csr_warp"
    out_cap = min(cap_a, cap_b)
    kw = dict(va=va, cap_a=cap_a, bounds=bounds, lbounds=lbounds)
    csr = (indptr, indices, vb, cap_b)
    a_live = _window_keys(a, bounds, lbounds)
    live = a_live + _window_keys(b, bounds, lbounds)
    _time_level_form(K, report, "intersect_expand", key,
                     f"expand_csr B={B} caps=({cap_a},{cap_b}) CSR base, packed rows",
                     lambda: K.intersect_expand_csr(*csr, out_cap, **kw),
                     lambda: K.intersect_expand_csr_ref(*csr, out_cap, **kw),
                     _bound(B, cap_b, live, a_live, 1, B * 4 + B * out_cap * 4))
    rows, counts = K.intersect_expand_csr(*csr, out_cap, **kw)
    offs = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    items = B * out_cap
    total = int(counts.sum())
    args = (rows, counts, offs, items)
    times = kernel_times(lambda: K.expand_items(*args))
    plain_ms = cuda_ms(lambda: K.expand_items_ref(*args))
    # the survivors, counts and offs read; src and verts written in full
    bound_ms, by = _bytes_bound(total * 4 + B * 8 + items * 8)
    print(f"[csr] expand_items B={B} out_cap={out_cap} out_items={items} total={total}: "
          f"{_times_text(times)}, {plain_ms:.4f} ms plain (batch_compact_scan), bound "
          f"{bound_ms:.4f} ms", flush=True)
    if key == "csr":
        # no one PyTorch call writes both src and verts
        report["expand_items"].update(**times, plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=by, library_ms=None)
    else:
        report["expand_items"].update({f"warp_{n}": v for n, v in times.items()},
                                      warp_plain_ms=plain_ms, warp_bound_ms=bound_ms)


def phase_csr(report: dict) -> None:
    """The CSR-operand forms against their plain versions, and their times
    at the timed shapes."""
    from repro_torch.kernels import intersect as K
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    for shape in CSR_SHAPES:
        _parity_count_csr(K, report, gen, *shape)
    for shape in CSR_AGG_SHAPES:
        _parity_agg_csr(K, report, gen, *shape)
    for shape in CSR_AGG_SHAPES:
        _parity_level_csr(K, report, gen, *shape)
    for shape in EXPAND_SHAPES:
        _parity_expand_csr(K, report, gen, *shape)


def _vinter_bound(ak, bk, rows: int) -> tuple[float, str]:
    """Live keys and values of both operands read once, 4 bytes a row
    written; or log2 |B_i| compares per live A key at the int rate."""
    a_live, b_live = int((ak != SENTINEL).sum()), int((bk != SENTINEL).sum())
    bytes_ms = ((a_live + b_live) * 8 + rows * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = a_live * max(1, (bk.shape[1] - 1).bit_length()) / INT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _vinter_grid_bound(ak, bk) -> tuple[float, str]:
    """The grid form's: each stack's distinct live keys and values read
    once, nr x nc x 4 bytes written; or log2 cap_b compares per live A key
    per B row at the int rate."""
    nr, nc = ak.shape[0], bk.shape[0]
    a_live, b_live = int((ak != SENTINEL).sum()), int((bk != SENTINEL).sum())
    bytes_ms = ((a_live + b_live) * 8 + nr * nc * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = nc * a_live * max(1, (bk.shape[1] - 1).bit_length()) / INT_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _check_vinter(report, label: str, got, want, dyadic: bool) -> None:
    """Dyadic values bit for bit, others within rtol 1e-6."""
    torch.cuda.synchronize()
    _record(report, "vinter", _max_err([got], [want]))
    ok = torch.equal(got, want) if dyadic else torch.allclose(got, want, rtol=1e-6, atol=0)
    if not ok:
        raise SystemExit(f"[parity] MISMATCH {label} ({'dyadic' if dyadic else 'in [0.5, 2)'} "
                         f"values): {_max_err([got], [want])}")


def _parity_vinter(SV, report, gen, B, cap_a, cap_b):
    """S_VINTER at one shape for every op: dyadic values bit for bit (B's
    rows also as one row expanded over the batch), values in [0.5, 2)
    within rtol 1e-6; timed at VINTER_LONG."""
    span = cap_a + cap_b
    ak, bk = sorted_rows(gen, B, cap_a, span), sorted_rows(gen, B, cap_b, span)
    va, vb = values_like(gen, ak), values_like(gen, bk)
    nva, nvb = values_like(gen, ak, dyadic=False), values_like(gen, bk, dyadic=False)
    b1, vb1 = bk[:1].expand(B, cap_b), vb[:1].expand(B, cap_b)
    label = f"vinter B={B} caps=({cap_a},{cap_b})"
    for op in VINTER_OPS:
        for args in ((ak, va, bk, vb), (ak, va, b1, vb1)):
            _check_vinter(report, f"{label} op={op} b stride {args[2].stride(0)}",
                          SV.vinter(*args, op), SV.vinter_ref(*args, op), True)
        _check_vinter(report, f"{label} op={op}", SV.vinter(ak, nva, bk, nvb, op),
                      SV.vinter_ref(ak, nva, bk, nvb, op), False)
    args = (ak, va, bk, vb)
    bound_ms, by = _vinter_bound(ak, bk, B)
    text = f"bound {bound_ms:.4f} ms"
    if (B, cap_a, cap_b) == VINTER_LONG:
        times = kernel_times(lambda: SV.vinter(*args))
        plain_ms = cuda_ms(lambda: SV.vinter_ref(*args))
        text = f"{_times_text(times)}, {plain_ms:.4f} ms plain, {text} ({by})"
        report["vinter"].update({f"long_{n}": v for n, v in times.items()},
                                long_plain_ms=plain_ms, long_bound_ms=bound_ms)
    print(f"[parity] {label} ops {list(VINTER_OPS)}: dyadic values equal bit for bit, also "
          f"against one broadcast row; values in [0.5, 2) within rtol 1e-6; {text}",
          flush=True)


def _parity_vinter_grid(SV, report, gen, nr, nc, cap_a, cap_b):
    """The grid form at one shape for every op, against its plain version
    (batch_vinter over repeated rows): dyadic values bit for bit, values in
    [0.5, 2) within rtol 1e-6; timed at GRID_LONG."""
    span = cap_a + cap_b
    ak, bk = sorted_rows(gen, nr, cap_a, span), sorted_rows(gen, nc, cap_b, span)
    va, vb = values_like(gen, ak), values_like(gen, bk)
    nva, nvb = values_like(gen, ak, dyadic=False), values_like(gen, bk, dyadic=False)
    label = f"vinter_grid {nr} x {nc} caps=({cap_a},{cap_b})"
    for op in VINTER_OPS:
        _check_vinter(report, f"{label} op={op}", SV.vinter_grid(ak, va, bk, vb, op),
                      SV.vinter_grid_ref(ak, va, bk, vb, op), True)
        _check_vinter(report, f"{label} op={op}", SV.vinter_grid(ak, nva, bk, nvb, op),
                      SV.vinter_grid_ref(ak, nva, bk, nvb, op), False)
    bound_ms, by = _vinter_grid_bound(ak, bk)
    text = f"bound {bound_ms:.3g} ms ({by})"
    if (nr, nc, cap_a, cap_b) == GRID_LONG:
        times = kernel_times(lambda: SV.vinter_grid(ak, va, bk, vb))
        plain_ms = cuda_ms(lambda: SV.vinter_grid_ref(ak, va, bk, vb))
        text = f"{_times_text(times)}, {plain_ms:.4f} ms plain, {text}"
        report["vinter"].update({f"grid_long_{n}": v for n, v in times.items()},
                                grid_long_plain_ms=plain_ms, grid_long_bound_ms=bound_ms)
    print(f"[parity] {label} ops {list(VINTER_OPS)}: dyadic values equal bit for bit, "
          f"values in [0.5, 2) within rtol 1e-6; {text}", flush=True)


def dense_matrix(n: int, density: float, seed: int):
    """benchmarks/bench_sparse.py's Table VI twin: an (n, n) float32 matrix
    with normal entries at the given density."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n, n)) < density,
                    rng.normal(size=(n, n)), 0.0).astype(np.float32)


def ttv_block(t, n_keys: int, fiber_block: int = 512):
    """The first fibre block sparse.ttv gives S_VINTER for the CSF tensor
    ``t`` against phase_sparse's dense vector of ``n_keys`` keys, on the
    card: fibre keys and values (fiber_block, cap) and the vector's (1,
    cap_v), which ttv expands at row stride 0."""
    import numpy as np

    from repro_torch.core.stream import round_capacity
    f1 = min(fiber_block, t.num_fibers)
    lens = np.diff(t.fiber_ptr)
    cap = round_capacity(int(lens.max()))
    fk = np.full((f1, cap), SENTINEL, np.int32)
    fv = np.zeros((f1, cap), np.float32)
    for i in range(f1):
        lo, hi = t.fiber_ptr[i], t.fiber_ptr[i + 1]
        fk[i, : hi - lo], fv[i, : hi - lo] = t.k_ids[lo:hi], t.vals[lo:hi]
    cap_v = round_capacity(n_keys)
    vk = np.full((1, cap_v), SENTINEL, np.int32)
    vv = np.zeros((1, cap_v), np.float32)
    vk[0, :n_keys] = np.arange(n_keys)
    vv[0, :n_keys] = np.random.default_rng(4).normal(size=n_keys)
    return tuple(torch.from_numpy(x).to(DEVICE) for x in (fk, fv, vk, vv))


def _time_vinter_on_ttv_block(SV, report):
    """The paired form at the shape ttv gives it (its only caller): the
    first 512 fibres of chicago-s (caps 128, ~3.5 live keys a row) against
    the 240-key vector at row stride 0, op mac; beside torch.sparse.mm of
    the fibres (a sparse (512, 240) matrix) by the vector. These are the
    kernel line's main numbers."""
    from repro_torch.sparse import random_csf
    _, shape, nnz = SPARSE_TENSORS[0]
    fk, fv, vk, vv = ttv_block(random_csf(shape, nnz, seed=3), shape[2])
    n = fk.shape[0]
    args = (fk, fv, vk.expand(n, -1), vv.expand(n, -1))
    live = fk != SENTINEL
    fibres = torch.sparse_coo_tensor(torch.stack([live.nonzero()[:, 0], fk[live]]), fv[live],
                                     (n, shape[2])).coalesce()
    vec = vv[0, : shape[2], None]
    got, want = SV.vinter(*args), SV.vinter_ref(*args)
    library = torch.sparse.mm(fibres, vec)[:, 0]
    torch.cuda.synchronize()
    _record(report, "vinter", _max_err([got], [want]))
    # normal values cancel in a fibre's sum, and the plain version sums in
    # f32: the sparse phase's tolerance, against both
    for name, other in (("its plain version", want), ("torch.sparse.mm", library)):
        if not torch.allclose(got, other, rtol=1e-5, atol=1e-6):
            raise SystemExit(f"[parity] MISMATCH vinter ttv block against {name}: "
                             f"{(got - other).abs().max().item()}")
    times = kernel_times(lambda: SV.vinter(*args), reps=50)
    plain_ms = cuda_ms(lambda: SV.vinter_ref(*args), reps=50)
    library_ms = cuda_ms(lambda: torch.sparse.mm(fibres, vec), reps=50)
    bound_ms, by = _vinter_bound(fk, vk, n)       # the vector read once
    print(f"[parity] vinter ttv block: chicago-s fibres {n} x {fk.shape[1]} against the "
          f"{shape[2]}-key vector ({vk.shape[1]}, row stride 0), {int(live.sum())} live "
          f"keys, mac: {_times_text(times)}, {plain_ms:.4f} ms plain, {library_ms:.4f} ms "
          f"torch.sparse.mm, bound {bound_ms:.3g} ms ({by})", flush=True)
    report["vinter"].update(**times, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                            library_ms=library_ms)


def _time_vinter_on_spmm_block(SV, report):
    """S_VINTER at the shape spmm gives it, on real data: the first 64 x 64
    block of email-core's row x column pairs (caps 128, op mac), in the
    grid form spmm calls (grid_* keys) and in the paired form (B = 4096
    pairs formed by repeat_interleave / repeat, as spmm did before the grid
    form: spmm_pair_* keys, kept to compare with a parent), beside
    torch.sparse.mm of the same block (the library's sparse product)."""
    import numpy as np

    from repro_torch.sparse import from_dense
    a_d, b_d = dense_matrix(1005, 0.025, 1), dense_matrix(1005, 0.025, 2)
    a, b = from_dense(a_d), from_dense(b_d, "csc")
    rows = np.nonzero(np.diff(a.indptr) > 0)[0][:64]
    cols = np.nonzero(np.diff(b.indptr) > 0)[0][:64]
    ak, av, bk, bv = (torch.from_numpy(x).to(DEVICE)
                      for x in (*a.padded_rows(rows), *b.padded_rows(cols)))
    nr, nc = len(rows), len(cols)
    a_sp = torch.from_numpy(a_d[rows]).to(DEVICE).to_sparse()
    b_sp = torch.from_numpy(b_d[:, cols]).to(DEVICE).to_sparse()
    block = torch.sparse.mm(a_sp, b_sp).to_dense()
    library_ms = cuda_ms(lambda: torch.sparse.mm(a_sp, b_sp), reps=50)
    args = (ak.repeat_interleave(nc, 0), av.repeat_interleave(nc, 0), bk.repeat(nr, 1),
            bv.repeat(nr, 1))
    forms = [("vinter", "spmm_pair_", lambda: SV.vinter(*args),
              lambda: SV.vinter_ref(*args), _vinter_bound(args[0], args[2], nr * nc))]
    if hasattr(SV, "vinter_grid"):
        grid = (ak, av, bk, bv)
        forms.append(("vinter_grid", "grid_", lambda: SV.vinter_grid(*grid),
                      lambda: SV.vinter_grid_ref(*grid), _vinter_grid_bound(ak, bk)))
    for name, key, run, plain, (bound_ms, by) in forms:
        got = run().reshape(nr, nc)
        torch.cuda.synchronize()
        if not torch.allclose(got, block, rtol=1e-5, atol=1e-6):
            raise SystemExit(f"[parity] {name} spmm block != torch.sparse.mm: "
                             f"{(got - block).abs().max().item()}")
        times = kernel_times(run, reps=50)
        plain_ms = cuda_ms(plain, reps=50)
        print(f"[parity] {name} email-core spmm block {nr} x {nc} caps=({ak.shape[1]},"
              f"{bk.shape[1]}) mac: {_times_text(times)}, {plain_ms:.4f} ms plain, "
              f"{library_ms:.4f} ms torch.sparse.mm of the block, bound {bound_ms:.3g} ms "
              f"({by})", flush=True)
        report["vinter"].update({f"{key}{n}": v for n, v in times.items()},
                                **{f"{key}plain_ms": plain_ms, f"{key}bound_ms": bound_ms,
                                   f"{key}bound_by": by, f"{key}library_ms": library_ms})


def _bytes_bound(nbytes: int) -> tuple[float, str]:
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def offset_view(x, offset: int):
    """x's values as a contiguous view ``offset`` elements into a flat
    buffer: a storage offset that puts its rows off 16-byte boundaries."""
    flat = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    flat[offset:] = x.reshape(-1)
    return flat[offset:].view(x.shape)


def _parity_compact(CP, report, gen, B, cap, out_cap, densities):
    """compact_rows bit for bit at one shape over keep densities, with keep
    set on SENTINEL slots (they must not count), an all-dead row, the mask
    as bool and as int32, and both arrays also as views at a storage offset
    (the scalar loads); timed at COMPACT_TIMED and COMPACT_WARP beside the
    masked sort of the JAX host path."""
    a = sorted_rows(gen, B, cap, 4 * cap)
    for density in densities:
        keep = torch.rand((B, cap), generator=gen, device=DEVICE) < density
        keep[1] = False
        for k in (keep, torch.where(keep, 3, -1).to(torch.int32)):
            want = CP.compact_rows_ref(a, k, out_cap)
            for ta, tk in ((a, k), (offset_view(a, 1), offset_view(k, 1))):
                got = CP.compact_rows(ta, tk, out_cap)
                torch.cuda.synchronize()
                err = max((got[0] - want[0]).abs().max().item(),
                          (got[1] - want[1]).abs().max().item())
                _record(report, "compact_rows", err)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])) \
                        or got[1][1] != 0:
                    raise SystemExit(f"[parity] MISMATCH compact_rows B={B} cap={cap} "
                                     f"out_cap={out_cap} density={density} keep {k.dtype} "
                                     f"storage offset {ta.storage_offset()}: {err}")
        cut = int((want[1] > out_cap).sum())
        print(f"[parity] compact_rows B={B} cap={cap} out_cap={out_cap} density "
              f"{density}: equal bit for bit (bool and int32 keep, also at a storage "
              f"offset); {cut} rows cut at out_cap", flush=True)
        shape = (B, cap, out_cap, density)
        if shape not in (COMPACT_TIMED, COMPACT_WARP):
            continue
        times = kernel_times(lambda: CP.compact_rows(a, keep, out_cap))
        plain_ms = cuda_ms(lambda: CP.compact_rows_ref(a, keep, out_cap))

        def masked_sort():
            masked = torch.where(keep, a, SENTINEL)
            return (torch.sort(masked, dim=1).values[:, :out_cap],
                    (masked != SENTINEL).sum(dim=1, dtype=torch.int32))
        library_ms = cuda_ms(masked_sort)
        if not all(torch.equal(x, y) for x, y in zip(masked_sort(), want)):
            raise SystemExit("[parity] compact_rows != the masked sort")
        live = int((a != SENTINEL).sum())
        # live keys and their keep flags read, rows and counts written
        bound_ms, by = _bytes_bound(live * 5 + B * out_cap * 4 + B * 4)
        print(f"[parity] compact_rows B={B} cap={cap} out_cap={out_cap} density "
              f"{density}: {_times_text(times)}, {plain_ms:.4f} ms plain, {library_ms:.4f} "
              f"ms masked sort (torch.sort), bound {bound_ms:.4f} ms", flush=True)
        key = "" if shape == COMPACT_TIMED else "warp_"
        report["compact_rows"].update({f"{key}{n}": v for n, v in times.items()},
                                      **{f"{key}plain_ms": plain_ms,
                                         f"{key}bound_ms": bound_ms, f"{key}bound_by": by,
                                         f"{key}library_ms": library_ms})


def _compact_team_sweep(CP, gen) -> None:
    """compact_rows with each team forced at COMPACT_SWEEP's caps (B 2048,
    out_cap = cap, density 0.3): where the wrapper's warp/block switch goes."""
    if not hasattr(CP, "WARP_MAX_CAP"):
        return
    switch = CP.WARP_MAX_CAP
    try:
        for cap in COMPACT_SWEEP:
            a = sorted_rows(gen, 2048, cap, 4 * cap)
            keep = torch.rand((2048, cap), generator=gen, device=DEVICE) < 0.3
            ms = {}
            for team, limit in (("warp", 1 << 30), ("block", 0)):
                CP.WARP_MAX_CAP = limit
                ms[team] = kernel_times(lambda: CP.compact_rows(a, keep, cap),
                                        host_calls=10)["device_ms"]
            print(f"[parity] compact_rows team sweep B=2048 cap={cap}: warp a row "
                  f"{ms['warp']:.4f} ms device, block a row {ms['block']:.4f} ms -> "
                  f"{min(ms, key=ms.get)} (the wrapper: "
                  f"{'warp' if cap <= switch else 'block'})", flush=True)
    finally:
        CP.WARP_MAX_CAP = switch


def _parity_bitmap(BM, report, gen, B, words):
    """bitmap_and_count bit for bit on random words (bit 31 included);
    timed at BITMAP_TIMED."""
    a, b = (torch.randint(-2**31, 2**31 - 1, (B, words), generator=gen, device=DEVICE,
                          dtype=torch.int32) for _ in range(2))
    a[0] = -1
    got, want = BM.bitmap_and_count(a, b), BM.bitmap_and_count_ref(a, b)
    torch.cuda.synchronize()
    _record(report, "bitmap_and_count", (got - want).abs().max().item())
    if not torch.equal(got, want):
        raise SystemExit(f"[parity] MISMATCH bitmap_and_count B={B} W={words}")
    times = kernel_times(lambda: BM.bitmap_and_count(a, b))
    plain_ms = cuda_ms(lambda: BM.bitmap_and_count_ref(a, b))
    bound_ms, by = _bytes_bound(2 * B * words * 4 + B * 4)
    print(f"[parity] bitmap_and_count B={B} W={words}: equal bit for bit; "
          f"{_times_text(times)}, {plain_ms:.4f} ms plain, bound {bound_ms:.4f} ms",
          flush=True)
    if (B, words) == BITMAP_TIMED:
        # PyTorch has no popcount: no one call computes this function
        report["bitmap_and_count"].update(**times, plain_ms=plain_ms, bound_ms=bound_ms,
                                          bound_by=by, library_ms=None)


def _parity_xinter(gen):
    """ops.xinter (the mark kernel, then compact-rows) on the card against
    core.batch.batch_inter on the CPU."""
    from repro_torch.core.batch import batch_inter
    from repro_torch.kernels import ops
    for B, cap_a, cap_b, out_cap in ((2048, 256, 128, None), (512, 2048, 2048, 256)):
        a, b = sorted_rows(gen, B, cap_a, 2 * cap_b), sorted_rows(gen, B, cap_b, 2 * cap_b)
        bounds, lbounds = bound_vectors(gen, B, 2 * cap_b)
        got = ops.xinter(a, b, bounds, out_cap=out_cap, lbounds=lbounds)
        want = batch_inter(a.cpu(), b.cpu(), bounds.cpu(), out_cap=out_cap,
                           lbounds=lbounds.cpu())
        if not all(torch.equal(x.cpu(), y) for x, y in zip(got, want)):
            raise SystemExit(f"[parity] MISMATCH xinter B={B} caps=({cap_a},{cap_b})")
        print(f"[parity] xinter B={B} caps=({cap_a},{cap_b}) out_cap={out_cap}: equal "
              f"to batch_inter on the CPU, bit for bit", flush=True)


def phase_parity() -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels import bitmap as BM
    from repro_torch.kernels import compact as CP
    from repro_torch.kernels import intersect as K
    from repro_torch.kernels import svinter as SV
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    report = {name: {"max_abs_err": 0} for name in KERNELS}
    for B, cap_a, cap_b in PARITY_SHAPES:
        _parity_pair(K, report, gen, B, cap_a, cap_b)
    for shape in MULTI_SHAPES:
        _parity_multi(K, report, gen, *shape)
        _parity_agg(K, report, gen, *shape)
    for shape in VINTER_SHAPES:
        _parity_vinter(SV, report, gen, *shape)
    if hasattr(SV, "vinter_grid"):
        for shape in GRID_SHAPES:
            _parity_vinter_grid(SV, report, gen, *shape)
    _time_vinter_on_ttv_block(SV, report)
    _time_vinter_on_spmm_block(SV, report)
    for (B, cap, out_cap), densities in COMPACT_SHAPES:
        _parity_compact(CP, report, gen, B, cap, out_cap, densities)
    _compact_team_sweep(CP, gen)
    for shape in BITMAP_SHAPES:
        _parity_bitmap(BM, report, gen, *shape)
    _parity_xinter(gen)
    return report


def build_graphs() -> dict:
    """The main path's graphs, built on the host (set-up, not timed)."""
    from repro_torch.graph.datasets import dataset_stats, get_dataset
    graphs = {}
    for name, scale, _ in MAIN_PATH:
        t0 = time.perf_counter()
        graphs[name, scale] = get_dataset(name, scale)
        print(f"[main] {name} x{scale}: {dataset_stats(graphs[name, scale])} "
              f"built on the host in {time.perf_counter() - t0:.2f}s", flush=True)
    return graphs


def _mine(miner, kernels, label: str, query: str, want: int):
    """One counted query: (count, launches per kernel, the runner counters it
    added); exits on a count that differs from the JAX package's."""
    before = [k.launches for k in kernels]
    st0 = dict(miner.stats["runner"])
    chunks0 = miner.metrics.counter("feed_chunks").value
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = miner.count(query)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = [k.launches - n for k, n in zip(kernels, before)]
    st = {k: v - st0[k] for k, v in miner.stats["runner"].items()}
    st.update(feed_chunks=miner.metrics.counter("feed_chunks").value - chunks0, wall=dt)
    print(f"[main] {label} {query} = {got} (JAX package: {want}) {dt:.3f}s wall; "
          "launches " + " ".join(f"{k.__name__.removeprefix('intersect_')} {n}"
                                 for k, n in zip(kernels, launched))
          + f"; feed_chunks {st['feed_chunks']} "
          f"exec_misses {st['exec_misses']} items {st['items']} dispatches "
          f"{st['level_kernel_dispatches']} compactions {st['device_compactions']}",
          flush=True)
    if got != want:
        raise SystemExit(f"[main] MISMATCH {label} {query}: {got} != {want}")
    return got, launched, st


def count_gathers(run):
    """(run(), calls of the engine's padded_rows and padded_value_rows during
    it): the leaves that read the CSR gather no padded rows."""
    from repro_torch.mining import engine
    calls = dict.fromkeys(("padded_rows", "padded_value_rows"), 0)
    saved = {name: getattr(engine, name) for name in calls}

    def counted(name):
        def gather(*args, **kwargs):
            calls[name] += 1
            return saved[name](*args, **kwargs)
        return gather
    for name in calls:
        setattr(engine, name, counted(name))
    out = run()
    for name, fn in saved.items():
        setattr(engine, name, fn)
    return out, calls


# queries whose every level reads its rows from the CSR: no padded gathers
GATHER_FREE = ("triangle", "4-clique", "5-clique", "three-chain-induced", "diamond", "paw")
# padded-row gathers per call of the level-2 expand of the queries whose
# level 2 is a SUB or general level: its fresh base; no count leaf, INTER
# expand level, SUB or general reference gathers
LEVEL2_GATHERS = {"4-cycle": 1, "4-path": 1, "4-star": 1}


def phase_main_path(graphs: dict):
    """Drive the port's Miner; every count must equal the JAX package's.
    Returns (per-query results, launches per count-path kernel)."""
    from repro_torch import Miner

    kernels = tuple(wrappers()[name] for name in COUNT_KERNELS)
    zero_launches()
    counts = {}
    for name, scale, queries in MAIN_PATH:
        miner = Miner(graphs[name, scale], device=DEVICE)
        for query, want in queries:
            execs = dict(miner.runner.level_execs)
            counts[name, scale, query], gathers = count_gathers(
                lambda: _mine(miner, kernels, f"{name} x{scale}", query, want))
            level2 = miner.runner.level_execs.get(("expand", 2), 0) \
                - execs.get(("expand", 2), 0)
            expect = 0 if query in GATHER_FREE else LEVEL2_GATHERS.get(query)
            print(f"[main] {name} x{scale} {query}: padded-row gathers {gathers} over "
                  f"{level2} level-2 expand calls" + ("" if expect is None else
                                                      f" (expected {expect} a call)"),
                  flush=True)
            if expect is not None and (gathers["padded_value_rows"]
                                       or gathers["padded_rows"] != expect * level2):
                raise SystemExit(f"[main] {name} {query}: padded-row gathers {gathers} "
                                 f"!= {expect} per level-2 expand call")
    # mico's induced three-chains, independently: Σ_v C(d_v, 2) − 3·triangles
    d = graphs["mico", 1.0].degrees.cpu().numpy().astype("int64")
    wedges = int((d * (d - 1) // 2).sum())
    closed = wedges - 3 * counts["mico", 1.0, "triangle"][0]
    print(f"[main] mico x1.0 three-chain-induced closed form {wedges} - 3 x "
          f"{counts['mico', 1.0, 'triangle'][0]} = {closed}", flush=True)
    if closed != counts["mico", 1.0, "three-chain-induced"][0]:
        raise SystemExit(f"[main] MISMATCH mico three-chain closed form {closed}")
    # fused_level=False: each call of a general level launches one mark per
    # reference instead of one k-reference kernel
    name, scale, query, want, k = UNFUSED
    miner = Miner(graphs[name, scale], device=DEVICE, fused_level=False)
    _, launched, st = _mine(miner, kernels, f"{name} x{scale} fused_level=False",
                            query, want)
    _, f_launched, f_st = counts[name, scale, query]
    mark, multi = COUNT_KERNELS.index("intersect_mark"), COUNT_KERNELS.index("intersect_multi")
    calls = f_launched[multi]
    rise = st["level_kernel_dispatches"] - f_st["level_kernel_dispatches"]
    print(f"[main] fused_level=False {query}: dispatches {st['level_kernel_dispatches']} "
          f"vs {f_st['level_kernel_dispatches']} fused, +{rise} over {calls} "
          f"general-level calls of k = {k} references; mark launches "
          f"{launched[mark]} vs {f_launched[mark]} fused", flush=True)
    if calls <= 0 or rise != (k - 1) * calls or launched[multi] \
            or launched[mark] != f_launched[mark] + k * calls:
        raise SystemExit("[main] fused_level=False did not trade each k-reference "
                         "launch for k mark launches")
    launches = {k.__name__: k.launches for k in kernels}
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"[main] {name} was never launched on the main path")
    return counts, launches


def weighted(g):
    """``g`` with the dyadic edge weights the JAX constants were taken with."""
    from repro_torch.graph import edge_list, edge_weights, with_edge_values
    return with_edge_values(g, edge_weights(edge_list(g), seed=0))


def phase_weighted(graphs: dict, counts: dict) -> dict:
    """Drive Miner.aggregate; every value must equal the JAX package's, with
    its unweighted twin's feed chunks and level dispatches (tailed-triangle's
    count plan folds its last level into a degree factor, which a weighted
    plan cannot), and one value-lane launch per aggregate-leaf call with
    references (tailed-triangle's leaf has none: the plain form)."""
    from repro_torch import Miner

    agg = wrappers()["intersect_multi_agg"]
    zero_launches()
    for name, scale, queries in WEIGHTED:
        miner = Miner(weighted(graphs[name, scale]), device=DEVICE)
        lanes = miner.metrics.counter("value_lane_dispatches")
        chunks = miner.metrics.counter("feed_chunks")
        for query, op, want in queries:
            n0, v0, c0 = agg.launches, lanes.value, chunks.value
            st0 = dict(miner.stats["runner"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, gathers = count_gathers(lambda: miner.aggregate(query, op))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if query in GATHER_FREE and any(gathers.values()):
                raise SystemExit(f"[weighted] {name} {query} {op}: the leaf gathered "
                                 f"padded rows {gathers}")
            calls, launched = lanes.value - v0, agg.launches - n0
            disp = miner.stats["runner"]["level_kernel_dispatches"] - st0["level_kernel_dispatches"]
            _, _, twin = counts[name, scale, TWIN.get((name, query), query)]
            exact = op != "sum" or exact_sum(want, PATTERN_EDGES[query])
            rule = "bit for bit" if exact else "rtol 1e-6"
            print(f"[weighted] {name} x{scale} {query} {op} = {got!r} (JAX package: "
                  f"{want!r}, {rule}) {dt:.3f}s wall (count {twin['wall']:.3f}s); "
                  f"padded gathers {sum(gathers.values())}; "
                  f"multi_agg launches {launched} over {calls} leaf calls; feed_chunks "
                  f"{chunks.value - c0} (count {twin['feed_chunks']}) dispatches {disp} "
                  f"(count {twin['level_kernel_dispatches']})", flush=True)
            if not (got == want if exact else abs(got - want) <= 1e-6 * abs(want)):
                raise SystemExit(f"[weighted] MISMATCH {name} {query} {op}: {got!r} != "
                                 f"{want!r}")
            if calls <= 0 or launched != (0 if query == "tailed-triangle" else calls):
                raise SystemExit(f"[weighted] {name} {query}: {launched} value-lane "
                                 f"launches for {calls} leaf calls")
            if query != "tailed-triangle" and (
                    chunks.value - c0 != twin["feed_chunks"]
                    or disp != twin["level_kernel_dispatches"]):
                raise SystemExit(f"[weighted] {name} {query}: feed chunks or dispatches "
                                 "differ from the unweighted twin's")
    if agg.launches <= 0:
        raise SystemExit("[weighted] intersect_multi_agg was never launched")
    return {"intersect_multi_agg": agg.launches}


def phase_sparse() -> dict:
    """spmsp_matmul and ttv at the Table VI sizes against float64 numpy
    (rtol 1e-5, atol 1e-6), each product's wall and S_VINTER launches: one
    a (row block, column block) for spmm (the grid form where the tree has
    it) and one a fibre block for ttv (the paired form), as in the JAX
    package."""
    import numpy as np

    from repro_torch.sparse import from_dense, random_csf, spmsp_matmul, ttv
    counters = [fn for name, fn in wrappers().items() if name in ("vinter", "vinter_grid")]

    def launched() -> int:
        return sum(fn.launches for fn in counters)
    zero_launches()
    for name, n, density in SPARSE_MATRICES:
        a_d, b_d = dense_matrix(n, density, 1), dense_matrix(n, density, 2)
        a, b = from_dense(a_d), from_dense(b_d, "csc")
        n0 = launched()
        c, dt = _timed(lambda: spmsp_matmul(a, b, device=DEVICE))
        blocks = -(-int((np.diff(a.indptr) > 0).sum()) // 64) \
            * -(-int((np.diff(b.indptr) > 0).sum()) // 64)
        want = a_d.astype(np.float64) @ b_d.astype(np.float64)
        err = float(np.abs(c - want).max())
        print(f"[sparse] spmm {name} n={n} density={density}: nnz {a.nnz} x {b.nnz}, "
              f"{dt:.3f}s wall, vinter launches {launched() - n0} ({blocks} blocks), max "
              f"abs err {err:.3g} against float64 numpy", flush=True)
        if not np.allclose(c, want, rtol=1e-5, atol=1e-6):
            raise SystemExit(f"[sparse] MISMATCH spmm {name}: {err}")
        if launched() - n0 != blocks:
            raise SystemExit(f"[sparse] spmm {name}: {launched() - n0} launches, not one "
                             f"a block")
    for name, shape, nnz in SPARSE_TENSORS:
        t = random_csf(shape, nnz, seed=3)
        vec = np.random.default_rng(4).normal(size=shape[2]).astype(np.float32)
        n0 = launched()
        (ii, jj, vv), dt = _timed(lambda: ttv(t, np.arange(shape[2], dtype=np.int32), vec,
                                              device=DEVICE))
        dense = np.zeros(shape)
        fib = np.repeat(np.arange(t.num_fibers), np.diff(t.fiber_ptr))
        dense[t.i_ids[fib], t.j_ids[fib], t.k_ids] = t.vals
        want = (dense @ vec.astype(np.float64))[ii, jj]
        err = float(np.abs(vv - want).max())
        print(f"[sparse] ttv {name} {shape} nnz={nnz}: {t.num_fibers} fibres, {dt:.3f}s "
              f"wall, vinter launches {launched() - n0}, max abs err {err:.3g} against "
              "float64 numpy", flush=True)
        if not np.allclose(vv, want, rtol=1e-5, atol=1e-6):
            raise SystemExit(f"[sparse] MISMATCH ttv {name}: {err}")
        if launched() - n0 != -(-t.num_fibers // 512):
            raise SystemExit(f"[sparse] ttv {name}: not one launch a fibre block")
    per = {fn.__name__: fn.launches for fn in counters}
    print(f"[sparse] launches by form: {per}", flush=True)
    if launched() <= 0 or any(v <= 0 for v in per.values()):
        raise SystemExit("[sparse] a vinter form was never launched")
    return {"vinter": launched(), "vinter_grid": per.get("vinter_grid", 0)}


def _timed(run):
    """(result, seconds) of ``run()``, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _level2(level_execs: dict) -> int:
    return sum(v for (kind, lv), v in level_execs.items() if kind == "expand" and lv == 2)


def _forest_report(graphs_email1) -> None:
    """benchmarks/bench_mining.py's forest report on email-eu-core 1.0: the
    six 4-motif plans run independently against one forest pass, on built
    executables; feed passes, level-2 executions and ops, and both walls."""
    from repro_torch import Miner
    from repro_torch.mining.forest import build_forest
    from repro_torch.mining.plan import FOUR_MOTIFS, compile_pattern
    plans = [compile_pattern(p) for p in FOUR_MOTIFS.values()]
    indep_m, fused_m = Miner(graphs_email1, device=DEVICE), Miner(graphs_email1, device=DEVICE)
    [indep_m.runner.run(pl) for pl in plans]           # executables built
    fused_m.run_plans(plans)
    indep_m.runner.level_execs.clear()
    fused_m.runner.level_execs.clear()
    indep, t_ind = _timed(lambda: [indep_m.runner.run(pl) for pl in plans])
    fused, t_fus = _timed(lambda: fused_m.run_plans(plans))
    st = build_forest(plans).sharing_stats()
    got = {"feed_passes": (st["feed_passes"]["independent"], st["feed_passes"]["fused"]),
           "level2_execs": (_level2(indep_m.runner.level_execs),
                            _level2(fused_m.runner.level_execs)),
           "level2_ops_static": tuple(sum(v for (_, lv), v in st[k].items() if lv == 2)
                                      for k in ("plan_ops", "forest_ops"))}
    print(f"[forest] email-eu-core x1.0 4-motif plans: counts {fused}; {got}; walls "
          f"{t_ind:.3f}s independent, {t_fus:.3f}s fused (x{t_ind / t_fus:.2f})",
          flush=True)
    if fused != indep or got != FOREST_REPORT:
        raise SystemExit(f"[forest] MISMATCH email-eu-core 1.0: {fused} vs {indep}, "
                         f"{got} vs {FOREST_REPORT}")


def phase_forest(graphs: dict) -> None:
    """Miner.count_many and aggregate_many: each result equal to the JAX
    package's and to per-query calls in the same session."""
    from repro_torch import Miner
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.mining.plan import (FOUR_MOTIF_SHAPES, THREE_CHAIN_INDUCED, TRIANGLE,
                                         compile_pattern)
    want_main = {(n, q): w for n, _, qs in MAIN_PATH for q, w in qs}
    names = list(FOUR_MOTIF_SHAPES)
    for name, queries, want in (
            ("mico", [TRIANGLE, THREE_CHAIN_INDUCED],
             [want_main["mico", "triangle"], want_main["mico", "three-chain-induced"]]),
            ("wiki-vote", names, [WIKI_4CLIQUE] + [want_main["wiki-vote", q]
                                                   for q in names[1:]])):
        miner = Miner(graphs[name, 1.0], device=DEVICE)
        st0 = dict(miner.stats["runner"])
        got, dt = _timed(lambda: miner.count_many(queries))
        st = {k: v - st0[k] for k, v in miner.stats["runner"].items()}
        execs = dict(miner.runner.level_execs)
        single, dt1 = _timed(lambda: [miner.count(q) for q in queries])
        print(f"[forest] {name} x1.0 count_many = {got} (JAX package: {want}) {dt:.3f}s "
              f"wall, per-query {dt1:.3f}s; level execs {execs}; "
              f"items {st['items']} compactions {st['device_compactions']} rides "
              f"{st['count_rides']}", flush=True)
        if got != want or single != want:
            raise SystemExit(f"[forest] MISMATCH {name}: {got} / {single} != {want}")
    _forest_report(get_dataset("email-eu-core", 1.0))
    # the session mix of bench_mining.py, twice on one session
    g = graphs["email-eu-core", 0.25]
    miner = Miner(g, device=DEVICE)

    def mix():
        return {"T": miner.count("triangle"), "TC": miner.count("three-chain"),
                "TT": miner.count("tailed-triangle"), "4C": miner.count("4-clique"),
                "4M": dict(zip(names, miner.count_many(names)))}
    first, t1 = _timed(mix)
    rebuilds = miner.stats["rebuilds"]
    second, t2 = _timed(mix)
    st = miner.stats
    print(f"[forest] email-eu-core x0.25 session mix: {first}; rebuilds {rebuilds} then "
          f"{st['rebuilds'] - rebuilds}, cache entries {st['exec_cache']['entries']}; "
          f"{t1:.3f}s then {t2:.3f}s", flush=True)
    if not (first == second == SESSION_COUNTS and st["rebuilds"] == rebuilds
            and st["exec_cache"]["entries"] == SESSION_EXEC_ENTRIES):
        raise SystemExit("[forest] MISMATCH email-eu-core session mix")
    # aggregate_many, and a count and an aggregate leaf in one feed pass
    wm = Miner(weighted(g), device=DEVICE)
    batch, dt = _timed(lambda: wm.aggregate_many(names, "sum"))
    single = [wm.aggregate(q, "sum") for q in names]
    chunks = wm.metrics.counter("feed_chunks")
    c0 = chunks.value
    both = wm.run_plans([compile_pattern(TRIANGLE), compile_pattern(TRIANGLE, aggregate="sum")])
    fused_chunks = chunks.value - c0
    c0 = chunks.value
    wm.count("triangle")
    print(f"[forest] email-eu-core x0.25 aggregate_many 4M sum = {batch} {dt:.3f}s (per "
          f"query {single}); T count + T sum in one pass: {both}, {fused_chunks} feed "
          f"chunks (T alone {chunks.value - c0})", flush=True)
    if batch != single or both != [SESSION_COUNTS["T"], 2835.9375] \
            or fused_chunks != chunks.value - c0:
        raise SystemExit("[forest] MISMATCH aggregate_many / fused count + aggregate")


# The brute-force oracles (mining/reference.py) on the card: the 4-motif
# census of email-eu-core 0.25 against the session's count_many, then the
# other oracles against a card session on two tiny generated graphs (the
# permutation oracles are exponential: 20 vertices), weights seed 11 as in
# tests/test_values.py, and FSM on tests/test_fsm.py's first labelled graph.
REFERENCE_TINY = (("erdos_renyi(20, 70, seed=7)", "erdos_renyi", (20, 70), 7),
                  ("clique_planted(20, 40, (6, 5), seed=1)", "clique_planted",
                   (20, 40, (6, 5)), 1))
REFERENCE_MOTIFS = ("diamond", "paw", "4-cycle")
REFERENCE_FSM = (22, 55, 1, 2, 2)        # erdos_renyi(22, 55, seed), seed, labels, support
CENSUS_LIMIT_S = 60.0                    # the census of email-eu-core 0.25 on the card


def _reference_tiny(card: str) -> None:
    """(b): the oracles against a card session on REFERENCE_TINY's graphs and
    REFERENCE_FSM's; weighted results bit for bit."""
    import importlib
    import struct

    from repro_torch import Miner
    from repro_torch.graph import build_csr, edge_list, edge_weights, generators, with_edge_values
    from repro_torch.mining import reference as R
    from repro_torch.mining.plan import FOUR_MOTIFS, THREE_CHAIN_INDUCED, TRIANGLE, clique_pattern
    F = importlib.import_module("repro_torch.mining.fsm")
    for label, gen, args, seed in REFERENCE_TINY:
        g = build_csr(getattr(generators, gen)(*args, seed=seed), args[0])
        m = Miner(g, device=DEVICE)
        t0 = time.perf_counter()
        want = {"triangle": R.triangle_count(g), "4-clique": R.clique_count(g, 4),
                "5-clique": R.clique_count(g, 5),
                "tailed-triangle": R.tailed_triangle_count(g),
                "three-chain-induced": R.three_chain_count(g, induced=True),
                **{q: R.pattern_count_oracle(g, FOUR_MOTIFS[q]) for q in REFERENCE_MOTIFS}}
        t_oracle = time.perf_counter() - t0
        got = {q: m.count(q) for q in want}
        wg = with_edge_values(g, edge_weights(edge_list(g), seed=11))
        wm = Miner(wg, device=DEVICE)
        agg = {}
        for name, pat in (("triangle", TRIANGLE), ("three-chain-induced", THREE_CHAIN_INDUCED),
                          ("4-clique", clique_pattern(4))):
            for op in AGG_OPS:
                a, b = float(wm.aggregate(pat, op)), R.weighted_pattern_oracle(wg, pat, op)
                agg[name, op] = (a, b, struct.pack("<d", a) == struct.pack("<d", b))
        print(f"[reference] {label}: card session {got}; oracles equal "
              f"{got == want} ({t_oracle:.2f}s of host enumeration); weighted (card, "
              f"oracle, bit for bit): " + "; ".join(f"{n} {op} {a!r} {b!r} {same}"
                                                   for (n, op), (a, b, same) in agg.items())
              + f" ({card})", flush=True)
        if got != want or not all(same for _, _, same in agg.values()):
            raise SystemExit(f"[reference] MISMATCH {label}: {got} != {want} or {agg}")
    n, e, seed, nlab, support = REFERENCE_FSM
    g = build_csr(generators.erdos_renyi(n, e, seed=seed), n)
    labels = F.random_labels(n, nlab, seed=seed)
    got = F.fsm(g, labels, support, miner=Miner(g, device=DEVICE))
    want = R.fsm_oracle(g, labels, support, metric="mni")
    print(f"[reference] fsm erdos_renyi({n}, {e}, seed={seed}) labels {nlab} support "
          f"{support}: {len(got)} frequent patterns on the card, oracle {len(want)}, equal "
          f"{got == want} ({card})", flush=True)
    if got != want:
        raise SystemExit(f"[reference] MISMATCH fsm: {got} != {want}")


def phase_reference(graphs: dict, card: str, src: Path) -> None:
    """The brute-force oracles on the card. (a) reference.four_motif_counts
    of email-eu-core 0.25 on the card (its wall, cold and warm, and its peak
    memory) equal to a card Miner's count_many of the six 4-motifs and to
    baseline.json's session counts; (b) _reference_tiny; (c) the launcher
    ``launch.mine --app F4M --check --torch-profile DIR`` in a subprocess:
    both OK lines, and its Chrome trace holds the device events of every
    hand kernel that (a)'s count_many launched."""
    import os
    import tempfile

    from repro_torch import Miner
    from repro_torch.mining import reference as R
    from repro_torch.mining.plan import FOUR_MOTIF_SHAPES
    names = list(FOUR_MOTIF_SHAPES)
    g = graphs["email-eu-core", 0.25]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    census, t_cold = _timed(lambda: R.four_motif_counts(g, device=DEVICE))
    peak = torch.cuda.max_memory_allocated() - base
    again, t_warm = _timed(lambda: R.four_motif_counts(g, device=DEVICE))
    miner = Miner(g, device=DEVICE)
    K = wrappers()
    zero_launches()
    fused, t_fused = _timed(lambda: dict(zip(names, miner.count_many(names))))
    launched = {name: fn.launches for name, fn in K.items() if fn.launches}
    n = g.num_vertices
    print(f"[reference] (a) email-eu-core x0.25 4-motif census on the card, C({n}, 4) = "
          f"{math.comb(n, 4)} quadruples: {census}; {t_cold:.3f}s cold, {t_warm:.3f}s warm, "
          f"peak {peak / 2**20:.1f} MiB; count_many {t_fused:.3f}s, equal {census == fused}, "
          f"launches {launched} ({card})", flush=True)
    if not (census == again == fused == SESSION_COUNTS["4M"]) or t_cold > CENSUS_LIMIT_S \
            or peak > 2**30:
        raise SystemExit(f"[reference] MISMATCH census {census} / {again} against "
                         f"count_many {fused}, or {t_cold:.1f}s / {peak} bytes over its limits")
    _reference_tiny(card)
    env = {**os.environ, "PYTHONPATH": str(src.resolve())}
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.mine", "--app", "F4M", "--dataset",
               "email-eu-core", "--scale", "0.25", "--check", "--torch-profile", d]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(f"[reference] (c) launch.mine exit {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        files = os.listdir(d)
        trace = json.load(open(os.path.join(d, "trace.json")))
    ok_lines = [line for line in proc.stdout.splitlines() if line.endswith(" OK")]
    owned: dict = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "kernel":
            name = kernel_owner(e.get("name", ""))
            if name is not None:
                owned[name] = owned.get(name, 0) + 1
    print(f"[reference] (c) launch.mine F4M email-eu-core x0.25 --check --torch-profile: "
          f"{ok_lines}; trace files {files}, {len(trace['traceEvents'])} events, hand "
          f"kernels' device events {owned} ({dt:.1f}s with start-up, {card})", flush=True)
    if ok_lines != ["[mine] fused == independent per-plan counts OK",
                    "[mine] fused == brute-force census OK"] or not set(launched) <= set(owned):
        raise SystemExit(f"[reference] (c) the launcher's check or trace falls short: "
                         f"{ok_lines}, {owned} against {launched}")


def phase_host(graphs: dict) -> dict:
    """device_compact=False: the mask, one compact-rows launch and one host
    read per expand call, then the host oracle. Returns the compact-rows
    launches of the run."""
    from repro_torch import Miner
    from repro_torch.mining.plan import FOUR_MOTIF_SHAPES
    cp = wrappers()["compact_rows"]
    names = list(FOUR_MOTIF_SHAPES)
    zero_launches()
    host_compactions = 0
    miner = Miner(graphs["email-eu-core", 0.25], device=DEVICE, device_compact=False)
    got = miner.count_many(names)
    st = dict(miner.stats["runner"])
    host_compactions += st["host_compactions"]
    print(f"[host] email-eu-core x0.25 4M = {got}; {st}; level execs "
          f"{dict(miner.runner.level_execs)}", flush=True)
    if got != list(SESSION_COUNTS["4M"].values()) \
            or {k: st[k] for k in HOST_4M} != HOST_4M \
            or dict(miner.runner.level_execs) != HOST_4M_EXECS:
        raise SystemExit("[host] MISMATCH email-eu-core 4M counters")
    for name, scale, runs in (("wiki-vote", 1.0, (("4-clique",), names)),
                              ("mico", 1.0, (("4-clique",),))):
        dev = Miner(graphs[name, scale], device=DEVICE)
        host = Miner(graphs[name, scale], device=DEVICE, device_compact=False)
        for queries in runs:
            want, t_dev = _timed(lambda: dev.count_many(list(queries)))
            h0 = host.stats["runner"]["host_compactions"]
            got, t_host = _timed(lambda: host.count_many(list(queries)))
            h = host.stats["runner"]["host_compactions"] - h0
            host_compactions += h
            print(f"[host] {name} x{scale} {list(queries)}: host path {got} "
                  f"{t_host:.3f}s, device path {want} {t_dev:.3f}s (wave_speedup "
                  f"x{t_host / t_dev:.2f}); {h} host compactions", flush=True)
            if got != want:
                raise SystemExit(f"[host] MISMATCH {name} {queries}: {got} != {want}")
    print(f"[host] compact_rows launches {cp.launches}, host compactions "
          f"{host_compactions}", flush=True)
    if cp.launches <= 0 or cp.launches != host_compactions:
        raise SystemExit("[host] compact_rows launches != host compactions")
    return {"compact_rows": cp.launches}


def _sha(rows) -> str:
    import hashlib

    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(rows, dtype=np.int32).tobytes()).hexdigest()


# the kernels an expand or emit level of each shape launches once a call
# (WaveRunner._fused_shape: 'inter', 'sub', or a general level with
# references, None)
LEVEL_KERNELS = {"inter": ("intersect_expand", "expand_items"), "sub": ("intersect_mark",),
                 None: ("intersect_multi",)}
EMIT_KERNELS = ("intersect_expand", "expand_items", "intersect_mark", "intersect_multi",
                "compact_rows")


def _emit_launches_expected(plan, calls: dict) -> dict:
    """Launches per kernel that ``plan``'s expand and emit levels owe for
    ``calls`` level calls by (kind, level) on the device path."""
    from repro_torch.mining.engine import WaveRunner
    want = dict.fromkeys(EMIT_KERNELS, 0)
    for op in plan.ops:
        for name in LEVEL_KERNELS[WaveRunner._fused_shape(op)]:
            want[name] += calls.get((op.kind, op.level), 0)
    return want


def np_equal(a, b) -> bool:
    """Whether two host matrices are equal, shape and rows."""
    return a.shape == b.shape and bool((a == b).all())

def _embed(miner, query: str):
    """(embeddings, seconds, launches per emit-path kernel, level calls by
    (kind, level), padded-row gathers) of one Miner.embeddings call."""
    W = wrappers()
    before = {k: W[k].launches for k in EMIT_KERNELS}
    execs0 = dict(miner.runner.level_execs)
    (emb, dt), gathers = count_gathers(lambda: _timed(lambda: miner.embeddings(query)))
    launched = {k: W[k].launches - before[k] for k in EMIT_KERNELS}
    calls = {key: v - execs0.get(key, 0) for key, v in miner.runner.level_execs.items()
             if v != execs0.get(key, 0)}
    return emb, dt, launched, calls, gathers


def _check_on_card(miner, emb) -> tuple[float, int]:
    """youtube's triangles checked on the card: v0 > v1 > v2, each of the
    three pairs an edge (its src·2^31 + dst key found in the graph's sorted
    edge keys), no row twice. Returns (seconds, rows)."""
    g = miner.graph
    t0 = time.perf_counter()
    e = torch.from_numpy(emb).to(DEVICE).long()
    ok = bool(((e[:, 0] > e[:, 1]) & (e[:, 1] > e[:, 2])).all())
    keys = g.edge_keys
    for i, j in ((0, 1), (0, 2), (1, 2)):
        want = (e[:, i] << 31) + e[:, j]
        pos = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
        ok = ok and bool((keys[pos] == want).all())
    packed = torch.sort((e[:, 0] << 42) | (e[:, 1] << 21) | e[:, 2]).values
    ok = ok and bool((packed[1:] != packed[:-1]).all())
    torch.cuda.synchronize()
    if not ok:
        raise SystemExit("[emit] youtube triangles: a row out of order, a pair not an "
                         "edge or a row twice")
    return time.perf_counter() - t0, len(emb)


def _busy(run) -> tuple[float, float, float, object]:
    """(untraced wall ms, device busy ms, traced wall ms, result) of
    ``run()``: one untraced timed run, then one under torch.profiler (CUDA
    activity only) whose device events' durations are summed straight from
    the trace (no per-event Python objects: a run of 10^5 launches stays
    cheap to account)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out, wall = _timed(run)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, traced = _timed(run)
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()) / 1e6
    return wall * 1e3, busy, traced * 1e3, out


def phase_emit(graphs: dict, card: str) -> dict:
    """Miner.embeddings on the card: every matrix equal to the JAX package's
    row for row (sha256), its row count the count's, each expand and emit
    level call one launch of its shape's kernels and no padded-row gather
    on mico; youtube's 10152197 triangles checked on the card; mico's
    triangles on the host path equal to the device path's, one compact-rows
    launch per host compaction. Returns the path's launches per kernel."""
    from repro_torch import Miner
    W = wrappers()
    want_count = {(n, s, q): w for n, s, qs in MAIN_PATH for q, w in qs}
    zero_launches()
    device_rows = {}
    for name, scale, queries in EMIT:
        miner = Miner(graphs[name, scale], device=DEVICE)
        for query, rows, sha in queries:
            emb, dt, launched, calls, gathers = _embed(miner, query)
            plan = miner.compile(query, emit=True)
            want = _emit_launches_expected(plan, calls)
            got_sha = _sha(emb)
            device_rows[name, scale, query] = emb
            print(f"[emit] {name} x{scale} {query}: {emb.shape} rows, sha256 {got_sha[:16]} "
                  f"(JAX package: {rows}, {sha[:16]}) {dt:.3f}s wall ({card}); level calls "
                  f"{calls}; launches {launched}; padded-row gathers {gathers}", flush=True)
            if got_sha != sha or emb.shape != (rows, plan.k) \
                    or rows != want_count.get((name, scale, query), rows):
                raise SystemExit(f"[emit] MISMATCH {name} {query}: {emb.shape} {got_sha}")
            if launched != want:
                raise SystemExit(f"[emit] {name} {query}: launches {launched} != {want}")
            if name == "mico" and any(gathers.values()):
                raise SystemExit(f"[emit] {name} {query}: padded-row gathers {gathers}")
    name, scale, query = EMIT_CHECKED
    miner = Miner(graphs[name, scale], device=DEVICE)
    emb, dt, launched, calls, _ = _embed(miner, query)
    check_s, rows = _check_on_card(miner, emb)
    t0 = time.perf_counter()
    wall, busy, traced, again = _busy(lambda: miner.embeddings(query))
    print(f"[emit] {name} x{scale} {query}: {rows} rows ({emb.nbytes / 1e6:.0f} MB), "
          f"first call {dt:.3f}s wall, then {wall:.1f} ms untraced, device busy "
          f"{busy:.1f} ms = {100 * busy / wall:.1f}% ({card}; traced run {traced:.1f} ms, "
          f"accounted in {time.perf_counter() - t0 - (wall + traced) / 1e3:.1f}s); checked "
          f"on the card in {check_s:.3f}s; emit calls {calls}; launches {launched}",
          flush=True)
    if rows != want_count[name, scale, query] or not (again == emb).all():
        raise SystemExit(f"[emit] MISMATCH {name} {query}: {rows} rows")
    # the host path: the keep mask (one mark launch per reference), one
    # compact-rows launch and the compact oracle per emit call
    host = Miner(graphs["mico", 1.0], device=DEVICE, device_compact=False)
    cp0, mk0 = W["compact_rows"].launches, W["intersect_mark"].launches
    emb, dt = _timed(lambda: host.embeddings("triangle"))
    st = host.stats["runner"]
    cp, mk = W["compact_rows"].launches - cp0, W["intersect_mark"].launches - mk0
    print(f"[emit] mico x1.0 triangle, host path: {emb.shape} rows {dt:.3f}s wall ({card}); "
          f"{st['host_compactions']} host compactions, compact_rows launches {cp}, mark "
          f"launches {mk}", flush=True)
    if not np_equal(emb, device_rows["mico", 1.0, "triangle"]) \
            or cp != st["host_compactions"] or mk != st["host_compactions"] or cp <= 0:
        raise SystemExit("[emit] MISMATCH mico triangle host path")
    launches = {k: W[k].launches for k in EMIT_KERNELS}
    for k, n in launches.items():
        if n <= 0:
            raise SystemExit(f"[emit] {k} was never launched on the emit path")
    return launches


def phase_fsm(graphs: dict, card: str) -> None:
    """The FSM feed through a forest of [triangle count, triangle emit] on
    mico (its count the emitted rows, its feed chunks a lone triangle's),
    then fsm and sfsm on email-eu-core 1.0 against the JAX package's result
    dicts, each wall with the share spent in the triangle feed."""
    import hashlib
    import importlib

    from repro_torch import Miner
    from repro_torch.graph.datasets import get_dataset
    from repro_torch.mining import apps
    from repro_torch.mining.plan import TRIANGLE, compile_pattern
    # the module (the package's ``fsm`` attribute is the function)
    F = importlib.import_module("repro_torch.mining.fsm")
    miner = Miner(graphs["mico", 1.0], device=DEVICE)
    chunks = miner.metrics.counter("feed_chunks")
    c0 = chunks.value
    (count, tris), dt = _timed(
        lambda: miner.run_plans([compile_pattern(TRIANGLE), *apps.FSM_FEED_PLANS]))
    fused = chunks.value - c0
    c0 = chunks.value
    alone = miner.count("triangle")
    alone_chunks = chunks.value - c0
    feed = apps.fsm_pattern_feed(graphs["mico", 1.0], miner=miner)[0]
    print(f"[fsm] mico x1.0 [T count, T emit] through one forest: count {count}, "
          f"{tris.shape} rows, {fused} feed chunks (T alone {alone_chunks}) {dt:.3f}s wall "
          f"({card}); fsm_pattern_feed rows sha256 {_sha(feed)[:16]}", flush=True)
    if not (count == len(tris) == alone == EMIT[0][2][0][1]) or fused != alone_chunks \
            or _sha(tris) != EMIT[0][2][0][2] or not np_equal(feed, tris):
        raise SystemExit("[fsm] MISMATCH mico forest feed")
    name, scale, nlab, support, max_edges = FSM_CELL
    g = get_dataset(name, scale)
    labels = F.random_labels(g.num_vertices, nlab, seed=1)
    feed_s = [0.0]
    saved = F.fsm_pattern_feed

    def timed_feed(*a, **k):
        out, t = _timed(lambda: saved(*a, **k))
        feed_s[0] += t
        return out
    F.fsm_pattern_feed = timed_feed
    try:
        for fn in (F.fsm, F.sfsm):
            fsm_miner = Miner(g, device=DEVICE)
            feed_s[0] = 0.0
            res, dt = _timed(lambda: fn(g, labels, support, max_edges=max_edges,
                                        miner=fsm_miner))
            got = (len(res), hashlib.sha256(repr(sorted(res.items())).encode()).hexdigest())
            want = FSM_WANT[fn.__name__]
            print(f"[fsm] {fn.__name__} {name} x{scale} labels {nlab} support {support}: "
                  f"{got[0]} patterns, sha256 {got[1][:16]} (JAX package: {want[0]}, "
                  f"{want[1][:16]}) {dt:.3f}s wall ({card}), triangle feed {feed_s[0]:.3f}s "
                  f"= {100 * feed_s[0] / dt:.1f}% of it", flush=True)
            if got != want:
                raise SystemExit(f"[fsm] MISMATCH {fn.__name__}: {got} != {want}")
    finally:
        F.fsm_pattern_feed = saved


def _telemetry_mix(miner, names) -> dict:
    return {"T": miner.count("triangle"), "TC": miner.count("three-chain"),
            "TT": miner.count("tailed-triangle"), "4C": miner.count("4-clique"),
            "4M": list(miner.count_many(names))}


def phase_telemetry(graphs: dict, card: str) -> None:
    """benchmarks/ci_gate.py:measure_telemetry's mix on a traced and an
    untraced Miner: the baseline.json values, the same counts, stats and
    kernel launches both ways; then mico's 4-clique traced and untraced."""
    from repro_torch import Miner
    from repro_torch.mining.plan import FOUR_MOTIF_SHAPES
    from repro_torch.obs import Telemetry
    W = wrappers()
    names = list(FOUR_MOTIF_SHAPES)
    g = graphs["email-eu-core", 0.25]
    runs = {}
    for traced in (True, False):
        tel = Telemetry(enabled=traced)
        miner = Miner(g, device=DEVICE, telemetry=tel)
        before = {k: fn.launches for k, fn in W.items()}
        counts, dt = _timed(lambda: _telemetry_mix(miner, names))
        runs[traced] = (miner, tel, counts, {k: fn.launches - before[k] for k, fn in W.items()},
                        dt)
    miner, tel, counts, launched, dt = runs[True]
    plain, _, plain_counts, plain_launched, plain_dt = runs[False]
    reg = tel.metrics
    rs = dict(miner.runner.stats)
    sess = miner.stats
    keys = tuple(TELEMETRY["session_counters"])
    by_cat: dict = {}
    for sp in tel.tracer.spans():
        by_cat[sp.cat] = by_cat.get(sp.cat, 0) + 1
    got = {"span_counts": dict(sorted(by_cat.items())),
           "runner_stats": dict(sorted(rs.items())),
           "session_counters": {k: sess[k] for k in keys},
           "registry_equals_legacy": all(reg.value(k) == v for k, v in rs.items())
           and all(reg.value(k) == sess[k] for k in keys),
           "enabled_disabled_parity": counts == plain_counts and sess == plain.stats}
    print(f"[telemetry] email-eu-core x0.25 mix traced {dt:.3f}s, untraced {plain_dt:.3f}s "
          f"({card}): {got}; launches traced {launched}, untraced {plain_launched}",
          flush=True)
    if got != TELEMETRY or launched != plain_launched \
            or counts["4M"] != list(SESSION_COUNTS["4M"].values()):
        raise SystemExit(f"[telemetry] MISMATCH: {got} != {TELEMETRY}, or launches differ")
    # mico's 4-clique on one session, its tracer off, on, off, on
    tel = Telemetry()
    m4 = Miner(graphs["mico", 1.0], device=DEVICE, telemetry=tel)
    m4.count("4-clique")                           # executables built
    walls = {False: [], True: []}
    for traced in (False, True, False, True):
        tel.tracer.enabled = traced
        tel.tracer.clear()
        got4, dt = _timed(lambda: m4.count("4-clique"))
        walls[traced].append(dt)
        if got4 != EMIT[0][2][1][1]:
            raise SystemExit(f"[telemetry] MISMATCH mico 4-clique {got4}")
    top = sorted(tel.tracer.level_seconds().items(), key=lambda kv: -kv[1])[:6]
    print(f"[telemetry] mico x1.0 4-clique, tracer off/on/off/on: "
          f"{walls[False][0]:.3f}, {walls[True][0]:.3f}, {walls[False][1]:.3f}, "
          f"{walls[True][1]:.3f}s ({card}); last traced run's self-time "
          + " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in top), flush=True)


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _gate_mix(miner, names) -> dict:
    """benchmarks/bench_mining.py's sharded_scaling_report mix."""
    res = {"T": miner.count("triangle"), "TC": miner.count("three-chain"),
           "TT": miner.count("tailed-triangle"), "4C": miner.count("4-clique")}
    res.update(zip(names, miner.count_many(names)))
    return res


class _PathLaunches:
    """A phase's launches per kernel, of the calls run through it alone:
    each such call has every count set to 0 just before it and read just
    after it, and the reads are summed, so no comparison run beside them
    (the shard phase's mesh-1 runs, the serve phase's sequential session)
    counts."""

    def __init__(self, kernels=SHARD_KERNELS):
        self.total = dict.fromkeys(kernels, 0)

    def __call__(self, run):
        zero_launches()
        out = run()
        W = wrappers()
        for k in self.total:
            self.total[k] += W[k].launches
        return out


def _shard_gate(g, names, card: str, on_mesh: _PathLaunches) -> None:
    """ci_gate.py's measure_sharded mix, twice at mesh 1 and 8, then its
    measure_telemetry mix traced and untraced at mesh 8: baseline.json's
    values. The mesh-8 runs go through ``on_mesh``."""
    from repro_torch import Miner
    from repro_torch.obs import Telemetry
    want_counts = {**{k: SESSION_COUNTS[k] for k in ("T", "TC", "TT", "4C")},
                   **SESSION_COUNTS["4M"]}
    got = {}
    for shards in (1, SHARDS):
        kw = {} if shards == 1 else {"mesh": shards, "mesh_devices": SHARD_DEVICES}
        m = Miner(g, device=DEVICE, **kw)
        track = on_mesh if shards != 1 else (lambda run: run())
        first, t1 = _timed(lambda: track(lambda: _gate_mix(m, names)))
        rebuilds, execs = m.stats["rebuilds"], sum(m.runner.level_execs.values())
        psums = m.stats["runner"].get("psum_reductions", 0)
        second, t2 = _timed(lambda: track(lambda: _gate_mix(m, names)))
        rs = m.stats["runner"]
        got[shards] = {"dispatches": sum(m.runner.level_execs.values()) - execs,
                       "psums": rs.get("psum_reductions", 0) - psums,
                       "feed": [v // 2 for v in rs.get("shard_feed_items", [])],
                       "rebuilds": m.stats["rebuilds"] - rebuilds}
        print(f"[shard] email-eu-core x0.25 gate mix at mesh {shards}: {first == want_counts} "
              f"counts; {t1:.3f}s then {t2:.3f}s ({card}); second pass {got[shards]}",
              flush=True)
        if not first == second == want_counts:
            raise SystemExit(f"[shard] MISMATCH gate mix at mesh {shards}: {second}")
    summary = {"dispatches_per_pass": {s: r["dispatches"] for s, r in got.items()},
               "psum_reductions_per_pass": got[SHARDS]["psums"],
               "shard_feed_items": got[SHARDS]["feed"],
               "rebuilds_second_pass": max(r["rebuilds"] for r in got.values())}
    if summary != SHARDED:
        raise SystemExit(f"[shard] MISMATCH sharded counters {summary} != {SHARDED}")
    runs = {}
    for traced in (True, False):
        tel = Telemetry(enabled=traced)
        m = Miner(g, device=DEVICE, mesh=SHARDS, mesh_devices=SHARD_DEVICES, telemetry=tel)
        counts, dt = _timed(lambda: on_mesh(lambda: _telemetry_mix(m, names)))
        runs[traced] = (m, tel, counts, dt)
    (m, tel, counts, dt), (plain, _, plain_counts, plain_dt) = runs[True], runs[False]
    reg, rs, sess = tel.metrics, dict(m.runner.stats), m.stats
    keys = tuple(TELEMETRY_MESH8["session_counters"])
    fam = reg.series("shard_feed_items")
    by_cat: dict = {}
    for sp in tel.tracer.spans():
        by_cat[sp.cat] = by_cat.get(sp.cat, 0) + 1
    tgot = {"span_counts": dict(sorted(by_cat.items())),
            "runner_stats": dict(sorted(rs.items())),
            "session_counters": {k: sess[k] for k in keys},
            "registry_equals_legacy": all(reg.value(k) == v for k, v in rs.items()
                                          if not isinstance(v, list))
            and [fam[(("shard", s),)].value for s in range(SHARDS)] == rs["shard_feed_items"]
            and all(reg.value(k) == sess[k] for k in keys),
            "enabled_disabled_parity": counts == plain_counts and sess == plain.stats}
    print(f"[shard] email-eu-core x0.25 telemetry mix at mesh {SHARDS}: traced {dt:.3f}s, "
          f"untraced {plain_dt:.3f}s ({card}): {tgot}", flush=True)
    if tgot != TELEMETRY_MESH8:
        raise SystemExit(f"[shard] MISMATCH mesh-8 telemetry {tgot} != {TELEMETRY_MESH8}")


def phase_shard(graphs: dict, card: str) -> dict:
    """Miner(mesh=8) over one card (eight shards on cuda:0): baseline.json's
    sharded and mesh-8 telemetry counters on email-eu-core 0.25; mico at full
    width (MAIN_PATH's six counts, the weighted T sum, the T embeddings'
    sorted rows equal to the unsharded session's) and wiki-vote's 4-motifs;
    the walls at mesh 1 and 8 and the device busy share of mico 4C; on a
    host of two or more cards, mico T and 4C over a mesh of distinct cards.
    Returns the launches per kernel of the phase's sharded runs alone (the
    mesh-1 runs beside them are left out of the count)."""
    import numpy as np

    from repro_torch import Miner
    from repro_torch.mining.plan import FOUR_MOTIF_SHAPES
    names = list(FOUR_MOTIF_SHAPES)
    want = {(n, q): w for n, _, qs in MAIN_PATH for q, w in qs}
    on_mesh = _PathLaunches()
    _shard_gate(graphs["email-eu-core", 0.25], names, card, on_mesh)
    mico = graphs["mico", 1.0]
    one = Miner(mico, device=DEVICE)
    mesh = Miner(mico, device=DEVICE, mesh=SHARDS, mesh_devices=SHARD_DEVICES)
    walls = {}
    for query in SHARD_MICO:
        for label, m, track in (("1", one, lambda run: run()),
                                (str(SHARDS), mesh, on_mesh)):
            got, first = _timed(lambda: track(lambda: m.count(query)))
            again, warm = _timed(lambda: track(lambda: m.count(query)))
            walls[query, label] = warm
            if got != want["mico", query] or again != got:
                raise SystemExit(f"[shard] MISMATCH mico {query} at mesh {label}: {got}")
            print(f"[shard] mico x1.0 {query} at mesh {label} = {got} (MAIN_PATH: "
                  f"{want['mico', query]}): first {first:.3f}s, again {warm:.3f}s ({card})",
                  flush=True)
    print(f"[shard] mico x1.0 six queries, warm walls: mesh 1 "
          f"{sum(walls[q, '1'] for q in SHARD_MICO):.3f}s, mesh {SHARDS} "
          f"{sum(walls[q, str(SHARDS)] for q in SHARD_MICO):.3f}s ({card}); runner at mesh "
          f"{SHARDS}: {mesh.stats['runner']}", flush=True)
    for label, m, track in (("1", one, lambda run: run()), (str(SHARDS), mesh, on_mesh)):
        wall, busy, traced, got = _busy(lambda: track(lambda: m.count("4-clique")))
        print(f"[shard] mico x1.0 4-clique at mesh {label}: {wall:.1f} ms untraced, device "
              f"busy {busy:.1f} ms = {100 * busy / wall:.1f}% ({card}; traced run "
              f"{traced:.1f} ms)", flush=True)
        if got != want["mico", "4-clique"]:
            raise SystemExit(f"[shard] MISMATCH mico 4-clique under the profiler: {got}")
    w_one = Miner(weighted(mico), device=DEVICE)
    w_mesh = Miner(weighted(mico), device=DEVICE, mesh=SHARDS, mesh_devices=SHARD_DEVICES)
    wsum = dict(((q, op), v) for q, op, v in WEIGHTED[0][2])["triangle", "sum"]
    got, dt = _timed(lambda: on_mesh(lambda: w_mesh.aggregate("triangle", "sum")))
    print(f"[shard] mico x1.0 weighted triangle sum at mesh {SHARDS} = {got!r} (JAX "
          f"package: {wsum!r}) {dt:.3f}s ({card})", flush=True)
    if got != wsum or w_one.aggregate("triangle", "sum") != wsum:
        raise SystemExit(f"[shard] MISMATCH mico weighted triangle sum {got!r}")
    rows, dt = _timed(lambda: on_mesh(lambda: mesh.embeddings("triangle")))
    flat = one.embeddings("triangle")

    def ordered(e):
        return e[np.lexsort(e.T[::-1])]
    sha, flat_sha = _sha(ordered(rows)), _sha(ordered(flat))
    print(f"[shard] mico x1.0 triangle embeddings at mesh {SHARDS}: {rows.shape} rows "
          f"{dt:.3f}s ({card}); sorted sha256 {sha[:16]} (mesh 1: {flat_sha[:16]}; "
          f"mesh 1 unsorted {_sha(flat)[:16]}, JAX package {EMIT[0][2][0][2][:16]})",
          flush=True)
    if sha != flat_sha or _sha(flat) != EMIT[0][2][0][2] or rows.shape != flat.shape:
        raise SystemExit("[shard] MISMATCH mico triangle embeddings at mesh 8")
    wiki = Miner(graphs["wiki-vote", 1.0], device=DEVICE, mesh=SHARDS,
                 mesh_devices=SHARD_DEVICES)
    got, dt = _timed(lambda: on_mesh(lambda: wiki.count_many(names)))
    want4 = [WIKI_4CLIQUE] + [want["wiki-vote", q] for q in names[1:]]
    print(f"[shard] wiki-vote x1.0 count_many 4M at mesh {SHARDS} = {got} (JAX package: "
          f"{want4}) {dt:.3f}s ({card})", flush=True)
    if got != want4:
        raise SystemExit(f"[shard] MISMATCH wiki-vote 4M at mesh {SHARDS}")
    cards = torch.cuda.device_count()
    print(f"[shard] torch.cuda.device_count() = {cards}", flush=True)
    if cards >= 2:
        k = min(cards, SHARDS)
        multi = Miner(mico, device=DEVICE, mesh=k)
        for query in ("triangle", "4-clique"):
            _sync_all()
            t0 = time.perf_counter()
            got = on_mesh(lambda: multi.count(query))
            _sync_all()
            print(f"[shard] mico x1.0 {query} over {k} cards = {got} "
                  f"{time.perf_counter() - t0:.3f}s", flush=True)
            if got != want["mico", query]:
                raise SystemExit(f"[shard] MISMATCH mico {query} over {k} cards")
    else:
        print("[shard] one card: the mesh over distinct cards was not run", flush=True)
    launches = on_mesh.total
    print(f"[shard] launches of the mesh-{SHARDS} runs alone {launches}", flush=True)
    for k, n in launches.items():
        if n <= 0:
            raise SystemExit(f"[shard] {k} was never launched on the shard path")
    return launches


def _served(handles, label: str) -> list:
    """Every handle's results; exits unless each request ended ``done`` (a
    kernel that fails to build or launch inside a tick fails its group's
    requests, and the service routes the cause to them)."""
    for h in handles:
        if h.state != "done":
            raise SystemExit(f"[serve] {label}: request {h.id} ended {h.state}: {h.error!r}")
    return [h.result(0) for h in handles]


def _service(g, cache: bool = False, bulk: bool = False):
    """A MiningService on the card: a ``default`` session, and with ``bulk``
    a mesh-8 session over SHARD_DEVICES beside it."""
    from repro_torch.mining import MinerConfig
    from repro_torch.serving import MiningService, WorkerSpec
    specs = [WorkerSpec("default", MinerConfig(device=DEVICE))]
    if bulk:
        specs.append(WorkerSpec("bulk", MinerConfig(device=DEVICE, mesh=SHARDS,
                                                    mesh_devices=SHARD_DEVICES)))
    return MiningService(g, workers=tuple(specs), cache_results=cache)


def _serving_batching(svc, classes, track, rounds: int = 3) -> dict:
    """bench_serving.py's batching_report: the mix as concurrent requests,
    one tick a round; the rounds' counts equal, steady rounds build nothing."""
    first, steady = None, 0
    for r in range(rounds):
        before = svc.stats["retraces"]
        handles = [svc.submit(qs, traffic_class=tc) for qs, tc in zip(SERVING_MIX, classes)]
        tick = track(svc.tick)
        res = dict(zip(SERVING_LABELS, [v for vs in _served(handles, f"gate round {r}")
                                        for v in vs]))
        if first is None:
            first = res
        elif res != first:
            raise SystemExit(f"[serve] gate round {r} counts {res} != round 0's {first}")
        else:
            steady += svc.stats["retraces"] - before
    fp = tick["feed_passes"]
    return {"counts": first, "feed_passes": [fp["independent"], fp["fused"]],
            "sharing_ok": fp["fused"] < fp["independent"], "steady_retraces": steady,
            "workers": sorted(svc.stats["workers"])}


def _sequential(miner, mixes, requests: int) -> dict:
    """A warmed session serving the request stream one request at a time:
    qps, p50 and p99 (bench_serving.py's load_report baseline)."""
    from repro_torch.serving import percentile
    for qs in mixes:
        miner.count_many(list(qs))
    lat = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(requests):
        t1 = time.perf_counter()
        miner.count_many(list(mixes[i % len(mixes)]))
        lat.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    return {"qps": requests / wall, "p50_s": percentile(lat, 50), "p99_s": percentile(lat, 99)}


def _burst(svc, mixes, requests: int, clients: int, track) -> dict:
    """LoadGenerator's burst (qps=None) on a warmed service; exits unless
    every request completed."""
    from repro_torch.serving import LoadGenerator
    res = track(LoadGenerator(svc, [(qs, "default") for qs in mixes], requests=requests,
                              clients=clients, qps=None).run)
    if res["completed"] != requests or res["failed"] or res["timeouts"] or res["rejected"]:
        raise SystemExit(f"[serve] burst load did not complete: {res}")
    return res


def _load_text(res: dict, seq: dict) -> str:
    return (f"service {res['qps']:.2f} qps, p50 {res['p50_s'] * 1e3:.1f} ms, p99 "
            f"{res['p99_s'] * 1e3:.1f} ms; sequential warmed session {seq['qps']:.2f} qps, "
            f"p50 {seq['p50_s'] * 1e3:.1f} ms, p99 {seq['p99_s'] * 1e3:.1f} ms "
            f"(qps x{res['qps'] / seq['qps']:.3f}, p99 x{res['p99_s'] / seq['p99_s']:.3f})")


def _serving_gate(g, card: str, track) -> None:
    """ci_gate.py's measure_serving on email-eu-core 0.25 on the card, the
    logic of bench_serving.py: batching, cache, the mixed pool with a mesh-8
    bulk worker on one card, and the burst load; baseline.json's values."""
    from repro_torch import Miner
    default = ["default"] * len(SERVING_MIX)
    b = _serving_batching(_service(g), default, track)
    got = {"counts": b["counts"], "batch_requests": len(SERVING_MIX),
           "feed_passes": b["feed_passes"], "sharing_ok": b["sharing_ok"],
           "steady_retraces": b["steady_retraces"]}
    svc = _service(g, cache=True)
    [svc.submit(qs) for qs in SERVING_MIX]
    track(svc.run_until_idle)
    warm = svc.cache.snapshot()
    handles = [svc.submit(qs) for qs in SERVING_MIX]
    tick = track(svc.tick)
    _served(handles, "gate cache pass")
    snap = svc.cache.snapshot()
    svc.set_graph(g)
    after = svc.cache.snapshot()
    got["cache"] = {"first_pass_misses": warm["misses"], "entries": snap["entries"],
                    "second_pass_hits": snap["hits"] - warm["hits"],
                    "cached_tick_executed": tick["executed"],
                    "invalidations": after["invalidations"],
                    "entries_after_bump": after["entries"]}
    if not all(h.from_cache for h in handles):
        raise SystemExit("[serve] gate: the second pass was not served from the cache")
    bm = _serving_batching(_service(g, bulk=True), default[:-1] + ["bulk"], track)
    got.update({"mesh8.counts_parity": bm["counts"] == b["counts"],
                "mesh8.workers": bm["workers"], "mesh8.sharing_ok": bm["sharing_ok"],
                "mesh8.steady_retraces": bm["steady_retraces"]})
    requests, clients = SERVING_LOAD
    seq = _sequential(Miner(g, device=DEVICE), SERVING_MIX, requests)
    svc = _service(g)
    [svc.submit(qs) for qs in SERVING_MIX]
    track(svc.run_until_idle)
    before = svc.stats["retraces"]
    res = _burst(svc, SERVING_MIX, requests, clients, track)
    fp = res["feed_passes"]
    got.update(load_sharing_ok=fp["fused"] < fp["independent"],
               load_retraces=svc.stats["retraces"] - before)
    print(f"[serve] email-eu-core x0.25 gate ({card}): {got}", flush=True)
    print(f"[serve] email-eu-core x0.25 burst of {requests} requests from {clients} clients "
          f"({card}): {_load_text(res, seq)}; no speed is claimed", flush=True)
    if got != SERVING:
        raise SystemExit(f"[serve] MISMATCH serving keys {got} != {SERVING}")


def phase_serve(graphs: dict, card: str) -> dict:
    """repro_torch.serving on the card: mico's requests through one service,
    SERVE_ROUNDS rounds of submit-then-one-tick (MAIN_PATH's counts, the
    weighted triangle sum bit for bit, fused < independent feed passes every
    tick, nothing built after the first); a burst of count requests against
    a sequential warmed session; baseline.json's serving keys on
    email-eu-core 0.25. Returns the launches per kernel of the service's
    calls alone (the sequential sessions beside them are not counted)."""
    from repro_torch import Miner
    want = {q: w for n, _, qs in MAIN_PATH if n == "mico" for q, w in qs}
    wsum = dict(((q, op), v) for q, op, v in WEIGHTED[0][2])["triangle", "sum"]
    g = weighted(graphs["mico", 1.0])
    track = _PathLaunches()
    svc = _service(g)
    expected = [[want[q] for q in qs] for qs in SERVE_REQUESTS] + [[wsum]]
    for r in range(SERVE_ROUNDS):
        before = svc.stats["retraces"]
        handles = [svc.submit(qs) for qs in SERVE_REQUESTS] + \
            [svc.submit("triangle", aggregate="sum")]
        tick, dt = _timed(lambda: track(svc.tick))
        got = _served(handles, f"mico round {r}")
        built = svc.stats["retraces"] - before
        fp = tick["feed_passes"]
        print(f"[serve] mico x1.0 round {r}: {tick['requests']} requests in one tick "
              f"{dt:.3f}s ({card}); feed passes {fp['independent']} independent -> "
              f"{fp['fused']} fused; {built} executables built; results {got}", flush=True)
        if got != expected or not fp["fused"] < fp["independent"] or (r and built):
            raise SystemExit(f"[serve] MISMATCH mico round {r}: {got} != {expected}, "
                             f"feed passes {fp}, {built} built")
    union = list(dict.fromkeys(q for qs in SERVE_REQUESTS for q in qs))
    seq_miner = Miner(g, device=DEVICE)
    requests, clients = SERVE_LOAD
    seq = _sequential(seq_miner, SERVE_REQUESTS, requests)
    counts, union_dt = _timed(lambda: seq_miner.count_many(union))
    wsum_seq, agg_dt = _timed(lambda: seq_miner.aggregate("triangle", "sum"))
    print(f"[serve] mico x1.0 warmed session: count_many of the {len(union)}-query union "
          f"{union_dt:.3f}s + the weighted triangle sum {agg_dt:.3f}s, against the last "
          f"tick's {dt:.3f}s ({card})", flush=True)
    if counts != [want[q] for q in union] or wsum_seq != wsum:
        raise SystemExit(f"[serve] MISMATCH mico warmed session: {counts}, {wsum_seq!r}")
    before = svc.stats["retraces"]
    res = _burst(svc, SERVE_REQUESTS, requests, clients, track)
    print(f"[serve] mico x1.0 burst of {requests} count requests from {clients} clients "
          f"({card}): {_load_text(res, seq)}; feed passes {res['feed_passes']}, "
          f"{svc.stats['retraces'] - before} built; no speed is claimed", flush=True)
    _serving_gate(graphs["email-eu-core", 0.25], card, track)
    st = svc.stats
    if st["service_failed"] or st["service_timeouts"] or st["service_rejected"] \
            or svc.stats["retraces"] != before:
        raise SystemExit(f"[serve] service counters: {st}")
    print(f"[serve] launches of the service's calls {track.total}", flush=True)
    for k, n in track.total.items():
        if n <= 0:
            raise SystemExit(f"[serve] {k} was never launched on the serve path")
    return track.total


def _isa_stream(rng, cap: int, fill: float, span: int, dyadic: bool):
    """int(cap * fill) sorted distinct keys below ``span`` from numpy's
    ``rng``, and values beside them as ``values_like``'s: dyadic ({1/4, ..,
    1}) or in [0.5, 2)."""
    import numpy as np
    keys = np.sort(rng.choice(span, int(cap * fill), replace=False)).astype(np.int32)
    if dyadic:
        return keys, rng.integers(1, 5, len(keys)).astype(np.float32) * 0.25
    return keys, (rng.random(len(keys)) * 1.5 + 0.5).astype(np.float32)


def _same_stream(label: str, got, want) -> None:
    if not (torch.equal(got.keys.cpu(), want.keys) and int(got.length) == int(want.length)):
        raise SystemExit(f"[isa] MISMATCH {label}: length {int(got.length)} against "
                         f"{int(want.length)}")


def phase_isa(graphs: dict, card: str) -> dict:
    """The stream ISA (core/isa.py, core/nested.py) on CUDA streams against
    the same ops on CPU copies (the plain versions): keys and lengths bit
    for bit, counts equal, S_VINTER bit for bit on dyadic values and within
    rtol 1e-6 on values in [0.5, 2), S_FETCH past the end SENTINEL; then
    S_NESTINTER over mico's highest-degree vertex both ways, against the CPU
    path and the set-semantics sum. Returns the launches per kernel."""
    import numpy as np

    from repro_torch.core import isa, make_stream, s_nestinter, to_host
    from repro_torch.graph.csr import neighbors_stream, to_numpy
    rng = np.random.default_rng(21)
    zero_launches()
    t0 = time.perf_counter()
    checked = 0
    for i, (cap_a, cap_b, fill) in enumerate(ISA_CASES):
        span, dyadic = 4 * max(cap_a, cap_b), i % 2 == 0
        (ka, va), (kb, vb) = (_isa_stream(rng, c, fill, span, dyadic) for c in (cap_a, cap_b))
        host = make_stream(ka, va, cap_a, device="cpu"), make_stream(kb, vb, cap_b, device="cpu")
        card_ = make_stream(ka, va, cap_a, device=DEVICE), make_stream(kb, vb, cap_b, device=DEVICE)
        for bound in (None, int(rng.integers(0, span)), 0, SENTINEL):
            label = f"caps ({cap_a}, {cap_b}) fill {fill} bound {bound}"
            for op in (isa.s_inter, isa.s_sub):
                _same_stream(f"{op.__name__} {label}", op(*card_, bound), op(*host, bound))
            for op in (isa.s_inter_c, isa.s_sub_c):
                got, want = op(*card_, bound), op(*host, bound)
                if got.device.type != DEVICE or int(got) != int(want):
                    raise SystemExit(f"[isa] MISMATCH {op.__name__} {label}: {int(got)} "
                                     f"against {int(want)}")
            checked += 6
        if int(isa.s_union_count(*card_)) != int(isa.s_union_count(*host)):
            raise SystemExit(f"[isa] MISMATCH s_union_count caps ({cap_a}, {cap_b})")
        for op in isa.VINTER_OPS:
            got, want = isa.s_vinter(*card_, op).cpu(), isa.s_vinter(*host, op)
            ok = torch.equal(got, want) if dyadic else torch.allclose(got, want, rtol=1e-6,
                                                                      atol=0)
            if not ok:
                raise SystemExit(f"[isa] MISMATCH s_vinter {op} caps ({cap_a}, {cap_b}) "
                                 f"({'dyadic' if dyadic else 'in [0.5, 2)'}): {got.item()!r} "
                                 f"against {want.item()!r}")
        for off in (0, len(ka) - 1, len(ka), cap_a - 1, cap_a, 10 * cap_a):
            got, want = int(isa.s_fetch(card_[0], off)), int(isa.s_fetch(host[0], off))
            if got != want or (off >= len(ka) and got != SENTINEL):
                raise SystemExit(f"[isa] MISMATCH s_fetch {off} caps ({cap_a}, {cap_b})")
        checked += 4 + 6
    torch.cuda.synchronize()
    print(f"[isa] {len(ISA_CASES)} stream pairs, caps 128-4096, bounds None / random / 0 / "
          f"SENTINEL: {checked} ops on the card equal to the CPU path, "
          f"{time.perf_counter() - t0:.3f}s ({card})", flush=True)
    mico = graphs["mico", 1.0]
    csr = to_numpy(mico)
    hub = int(np.argmax(csr["degrees"]))
    g_card = mico.to(DEVICE)
    s_card, s_host = neighbors_stream(g_card, hub), neighbors_stream(mico, hub)
    _same_stream("neighbors_stream", s_card, s_host)
    nv = to_host(s_host)
    rows = {int(u): csr["indices"][csr["indptr"][u]:csr["indptr"][u + 1]] for u in nv}
    for by_key in (False, True):
        got, dt = _timed(lambda: s_nestinter(g_card, s_card, bound_by_key=by_key))
        host = int(s_nestinter(mico, s_host, bound_by_key=by_key))
        sets = sum(int(np.count_nonzero(np.intersect1d(nv, rows[u]) < (u if by_key else SENTINEL)))
                   for u in rows)
        print(f"[isa] mico x1.0 s_nestinter over N({hub}) (degree {len(nv)}, cap "
              f"{s_card.capacity}), bound_by_key {by_key}: {int(got)} in {dt * 1e3:.3f} ms "
              f"({card}); CPU path {host}, set semantics {sets}", flush=True)
        if got.device.type != DEVICE or not int(got) == host == sets:
            raise SystemExit(f"[isa] MISMATCH s_nestinter bound_by_key {by_key}")
    W = wrappers()
    launches = {k: W[k].launches for k in ISA_KERNELS}
    print(f"[isa] launches {launches}", flush=True)
    for k, n in launches.items():
        if n <= 0:
            raise SystemExit(f"[isa] {k} was never launched on the isa path")
    return launches


def phase_bitmap(graphs: dict) -> dict:
    """keys_to_bitmap + xbitmap_count on mico's hub half-edges, equal to the
    sorted-row count; then the crossover sweep, timed."""
    import numpy as np

    from repro_torch.graph.csr import padded_rows
    from repro_torch.kernels import ops
    from repro_torch.mining.engine import _pow2cap, half_edges
    bm = wrappers()["bitmap_and_count"]
    g = graphs["mico", 1.0]
    edges = half_edges(g)
    deg = g.degrees.cpu().numpy()
    # the 2048 half-edges whose smaller end has the highest degree: the
    # dense rows the bitmap path is for
    sel = edges[np.argsort(-np.minimum(deg[edges[:, 0]], deg[edges[:, 1]]),
                           kind="stable")[:2048]]
    gd = g.to(DEVICE)
    cap = _pow2cap(int(deg[sel].max()))
    ra, rb = (padded_rows(gd, torch.from_numpy(sel[:, i].astype(np.int32)).to(DEVICE), cap)[0]
              for i in (0, 1))
    zero_launches()
    got, dt = _timed(lambda: ops.xbitmap_count(ops.keys_to_bitmap(ra, g.num_vertices),
                                               ops.keys_to_bitmap(rb, g.num_vertices)))
    launches = bm.launches
    want = ops.xinter_count(ra, rb)
    print(f"[bitmap] mico x1.0 {len(sel)} hub half-edges, cap {cap}, V {g.num_vertices}: "
          f"bitmap count {int(got.sum())} in {dt * 1e3:.3f} ms (with both conversions), "
          f"sorted-row count {int(want.sum())}; {launches} bitmap launch", flush=True)
    if launches <= 0 or not torch.equal(got, want):
        raise SystemExit("[bitmap] MISMATCH xbitmap_count != xinter_count on mico rows")
    rows, width, hi, fractions = CROSSOVER
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    for frac in fractions:
        n = min(width, max(1, int(hi * frac)))
        keys = [torch.sort(torch.rand((rows, hi), generator=gen, device=DEVICE)
                           .argsort(dim=1)[:, :n], dim=1).values.to(torch.int32)
                for _ in range(2)]
        a, b = (torch.nn.functional.pad(k, (0, width - n), value=SENTINEL).contiguous()
                for k in keys)
        merge_ms = cuda_ms(lambda: ops.xinter_count(a, b))
        conv_ms = cuda_ms(lambda: ops.keys_to_bitmap(a, hi))
        wa, wb = ops.keys_to_bitmap(a, hi), ops.keys_to_bitmap(b, hi)
        bitmap_ms = cuda_ms(lambda: ops.xbitmap_count(wa, wb))
        if not torch.equal(ops.xbitmap_count(wa, wb), ops.xinter_count(a, b)):
            raise SystemExit(f"[bitmap] MISMATCH crossover at {frac}")
        print(f"[bitmap] crossover {rows} rows x {n} keys of {hi}: merge (intersect_count) "
              f"{merge_ms:.4f} ms, bitmap kernel {bitmap_ms:.4f} ms, keys_to_bitmap "
              f"{conv_ms:.4f} ms a side -> {'bitmap' if bitmap_ms < merge_ms else 'merge'}"
              f" (kernel alone), {'bitmap' if bitmap_ms + 2 * conv_ms < merge_ms else 'merge'}"
              f" (with both conversions)", flush=True)
    return {"bitmap_and_count": launches}


# kernel symbol -> the wrapper whose launches it is, for this tree's kernels
# and for a parent's (chip_smoke.py --src): a template's first arguments say
# which wrapper instantiated it
KERNEL_OWNERS = (
    (r"level_kernel<[^,]*MarkLane", "intersect_mark"),
    (r"level_kernel<[^,]*MultiLane", "intersect_multi"),
    (r"level_kernel<[^,]*AggLane", "intersect_multi_agg"),
    (r"count_kernel<true, (true|false),", "intersect_mark"),
    (r"count_kernel<", "intersect_count"),
    # this tree's expand_kernel<kPack, kWarp, ...> and the parent's
    # one-block-a-row expand_kernel(...)
    (r"expand_kernel[<(]", "intersect_expand"),
    (r"expand_items_kernel", "expand_items"),
    # S_VINTER's two kernels serve both forms: <true> is the grid's; the
    # parent's untemplated vinter_kernel is the paired form's
    (r"vinter_(short_)?kernel<true>", "vinter_grid"),
    (r"vinter_(short_)?kernel", "vinter"),
    (r"compact_rows_kernel", "compact_rows"),
    (r"bitmap_and_count_kernel", "bitmap_and_count"),
)


def kernel_owner(symbol: str) -> str | None:
    import re
    for pattern, name in KERNEL_OWNERS:
        if re.search(pattern, symbol):
            return name
    return None


def _profile(label: str, run) -> None:
    """A warm untraced run of ``run()``, then one under torch.profiler;
    device busy = summed device self time, and each kernel wrapper's share
    (its symbols' device time summed over the run's traced launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()                                       # executables built
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    owned: dict = {}
    for e in dev:
        name = kernel_owner(e.key)
        if name is not None:
            ms, n = owned.get(name, (0.0, 0))
            owned[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
    print(f"[profile] {label}: {wall:.1f} ms wall untraced, device busy {busy:.1f} ms "
          f"= {100 * busy / wall:.1f}% of it; top: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms "
                      f"x{e.count}" for e in top), flush=True)
    print(f"[profile] {label}: kernels' own device time: "
          + "; ".join(f"{name} {ms:.3f} ms x{n} ({ms / n:.4f} ms a launch)"
                      for name, (ms, n) in sorted(owned.items())), flush=True)


def phase_profile(graphs: dict) -> None:
    """Where mico's queries spend the card's time, counted and weighted; then
    mico's 4-clique on the host-compaction path (compact_rows) and
    email-core's spmm (vinter)."""
    from repro_torch import Miner
    from repro_torch.sparse import from_dense, spmsp_matmul
    miner = Miner(graphs["mico", 1.0], device=DEVICE)
    for query in PROFILED:
        _profile(f"mico x1.0 {query}", lambda q=query: miner.count(q))
    wminer = Miner(weighted(graphs["mico", 1.0]), device=DEVICE)
    for query, op in PROFILED_WEIGHTED:
        _profile(f"mico x1.0 {query} {op} (weighted)",
                 lambda q=query, o=op: wminer.aggregate(q, o))
    host = Miner(graphs["mico", 1.0], device=DEVICE, device_compact=False)
    _profile("mico x1.0 4-clique (host path)", lambda: host.count("4-clique"))
    a_d, b_d = dense_matrix(1005, 0.025, 1), dense_matrix(1005, 0.025, 2)
    a, b = from_dense(a_d), from_dense(b_d, "csc")
    _profile("spmm email-core", lambda: spmsp_matmul(a, b, device=DEVICE))


# The LM decode path (models/, configs/, launch/serve.py --arch): the card
# against the CPU. Every config's weights come from the port's init with a
# CPU generator of seed 0, drawn once on the CPU and copied to the card.
LM_STEPS, LM_BATCH = 8, 2
LM_FULL = "qwen3-0.6b"
LM_GREEDY = (4, 32, 128)         # batch, tokens, max_len of the full-width bf16 run
LM_LAUNCHER = (("--arch", "qwen3-0.6b"), ("--arch", "rwkv6-3b", "--batch", "2", "--tokens", "8"))

# The LM training path (models/ Model.loss, train/, launch/train.py, the
# training examples): weights from a CPU generator of seed 0, as in lm.
TRAIN_STEPS = (100, 101)         # two steps on one batch, past the schedule's warmup
TRAIN_SMOKE = (2, 16)            # batch, seq of the smoke configs' steps
TRAIN_F32 = (2, 32)              # batch, seq of qwen3-0.6b float32, card against CPU
TRAIN_BF16 = ("--batch", "8", "--seq", "512", "--steps", "20")   # launch.train --full
TRAIN_8BIT_STEPS = 5             # steps at 8 x 512 with state_bits=8
TRAIN_LONG = (4, 2048)           # one step: the chunked loss's peak memory
TRAIN_CRASH = ("--arch", "qwen3-0.6b", "--steps", "10", "--batch", "2", "--seq", "16",
               "--ckpt-every", "4")

# The JAX examples' lines on a CPU (python examples/quickstart.py and
# examples/mine_patterns.py, JAX_PLATFORMS=cpu), timings blanked as
# example_lines() blanks them (with the padding before them, whose width a
# timing sets) and quickstart's "hottest spans" line (three span names in the
# order of their timings) left out. The port's example counterparts must
# print these lines on the card.
TIMING = r" *\d+\.\d+m?s\b"
EXAMPLE_LINES = {
    "quickstart": [
        "S_INTER    : [3 5 9]", "S_INTER R3 : [3 5]", "S_SUB      : [1 7]",
        "S_VINTER   : 310.0", "S_FETCH EOS: 2147483647", "S_NESTINTER(N(0)) = 2",
        "triangles          : 322", "triangles (nested) : 322", "3-chains (induced) : 38193",
        "tailed triangles   : 13027", "4-cliques          : 0",
        "4-motifs (fused)   : {'4-clique': 0, 'diamond': 167, '4-cycle': 3148, 'paw': 12359, "
        "'4-path': 453458, '4-star': 169714}",
        "triangle list      : (322, 3)", "retraces on repeat : 0",
        "weighted triangles : 79.765625", "heaviest triangle  : 1.0",
        "weighted (batched) : [79.765625, 0.0]", "retraces on repeat : 0",
        "traced query       : <t>, 9 spans, 2 dispatches",
        "service tick       : 2 requests merged, feed passes 2 -> 1",
        "request results    : [322, 12359] [322, 3148]", "cached repeat      : 322 (hits=1)"],
    "mine_patterns": [
        "[mine] email-eu-core twin: {'V': 1000, 'E': 19316, 'avg_deg': 38.632, 'max_deg': 239}",
        "[mine] triangle     =          29868  engine <t> | scalar <t>",
        "[mine] 3-chain(ind) =        1014529  engine <t> | scalar <t>",
        "[mine] tailed-tri   =        8121590  engine <t> | scalar <t>",
        "[mine] 3-motif      = {'triangle': 29868, 'chain': 1014529}  engine <t> | scalar <t>",
        "[mine] 4-clique     =          15853  engine <t> | scalar <t>",
        "[mine] 5-clique     =           5788  engine <t> | scalar <t>",
        "[mine] GRAMER-style exhaustive triangle = 29868 ( <t> — the method the paper shows "
        "losing)",
        "[mine] FSM (MNI support>=400): 0 frequent patterns ( <t>)",
        "[mine] sFSM (GRAMER count-support): 284 patterns — violates downward closure (§VI-B)"],
}
# with more than one card the quickstart adds its mesh line
EXAMPLE_MESH_LINE = "triangles (mesh)   : 322"


class _Routes:
    """Records each MoE router call of the port (``models.moe._router``):
    the experts chosen (T, k) and each token's top-k margin (the k-th less the
    (k+1)-th router probability), while active."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe._router
        self.idx, self.margins = [], []

    def __enter__(self):
        def router(params, x, cfg):
            gates, idx, aux = self.orig(params, x, cfg)
            p = torch.softmax(x.float() @ params["router"].float(), dim=-1)
            p = p.sort(dim=-1, descending=True).values
            self.idx.append(idx.cpu())
            self.margins.append((p[:, cfg.top_k - 1] - p[:, cfg.top_k]).cpu())
            return gates, idx, aux
        self.moe._router = router
        return self

    def __exit__(self, *exc):
        self.moe._router = self.orig


def _lm_decode(model, steps: int, batch: int, teacher=None):
    """``steps`` greedy decode steps of ``batch`` streams from token 0 (or
    teacher-forced by ``teacher`` (batch, steps + 1)), seamless against its
    encoded zero frames: (float32 logits (batch, steps, V) on the CPU,
    tokens (batch, steps + 1), the MoE routes)."""
    cfg = model.cfg
    caches, _ = model.init_cache(batch, 16)
    if cfg.first_dense:
        caches["dense"] = model.init_dense_cache(batch, 16)[0]
    enc = ()
    with torch.no_grad(), _Routes() as routes:
        if cfg.encoder_layers:
            enc = model._encode({"frames": torch.zeros(batch, 16, cfg.d_model,
                                                       device=model.device)})
        tok = torch.zeros((batch, 1), dtype=torch.long, device=model.device)
        logits, toks = [], [tok]
        for pos in range(steps):
            if teacher is not None:
                tok = teacher[:, pos:pos + 1].to(model.device)
            lg, caches = model.decode_step(tok, pos, caches, *enc)
            logits.append(lg.float().cpu())
            tok = lg[:, -1].argmax(-1, keepdim=True)
            toks.append(tok)
    return torch.cat(logits, dim=1), torch.cat(toks, dim=1).cpu(), routes


def _routed_alike(card, host, steps: int, batch: int, label: str):
    """(batch, steps) mask of the decode positions whose every MoE route so
    far is the CPU's: a token routed elsewhere, and its row from that step on,
    is masked out. Each such token must be a near tie of the CPU's router (its
    top-k margin under 1e-2), where two roundings may order two experts either
    way; else the phase fails."""
    alike = torch.ones((batch, steps), dtype=torch.bool)
    per_step = len(host.idx) // steps if host.idx else 0
    for c, (a, b) in enumerate(zip(card.idx, host.idx)):
        for r in torch.nonzero((a.sort(1).values != b.sort(1).values).any(1)).flatten():
            if host.margins[c][r] >= 1e-2:
                raise SystemExit(f"[lm] MISMATCH {label}: router call {c} row {int(r)} routed "
                                 f"elsewhere at margin {float(host.margins[c][r])}")
            alike[int(r), c // per_step:] = False
    return alike


def _lm_pair(arch: str, spec, dtype, card_name: str, teacher=None) -> dict:
    """The arch's smoke config in ``dtype`` on the card and on the CPU, same
    weights: LM_STEPS decode steps at batch LM_BATCH each. float32: greedy on
    both, equal tokens, logits within rtol 1e-4 and atol 1e-4·max|logit|;
    bfloat16: teacher-forced by the float32 CPU tokens, max|Δ| ≤ 2e-2·max|logit|
    at the positions routed alike."""
    import dataclasses

    from repro_torch.models import Model
    cfg = dataclasses.replace(spec.smoke_config, dtype=dtype)
    host = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = Model(cfg, device=DEVICE, generator=torch.Generator().manual_seed(0))
    want, want_toks, host_routes = _lm_decode(host, LM_STEPS, LM_BATCH, teacher)
    got, got_toks, card_routes = _lm_decode(card, LM_STEPS, LM_BATCH, teacher)
    scale = float(want.abs().max())
    alike = _routed_alike(card_routes, host_routes, LM_STEPS, LM_BATCH, f"{arch} {dtype}")
    err = float((got - want).abs()[alike].max())
    if dtype == torch.float32:
        ok = (torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale) and bool(alike.all())
              and torch.equal(got_toks, want_toks))
    else:
        ok = err <= 2e-2 * scale and float(alike.float().mean()) >= 0.5
    print(f"[lm] {arch} smoke {str(dtype)[6:]}: {LM_STEPS} steps x {LM_BATCH}, max|dlogit| "
          f"{err:.3g} of max|logit| {scale:.3g} ({err / scale:.2e}); positions routed alike "
          f"{int(alike.sum())}/{alike.numel()}; tokens "
          f"{'equal' if torch.equal(got_toks, want_toks) else 'teacher-forced'} "
          f"({card_name})", flush=True)
    if not ok:
        raise SystemExit(f"[lm] MISMATCH {arch} {dtype}: card against CPU, max err {err}")
    return {"tokens": want_toks, "rel_err": err / scale}


def _lm_full(spec, card_name: str) -> None:
    """qwen3-0.6b at full width: float32 on the card against the CPU,
    teacher-forced by the CPU's greedy tokens, then bfloat16 on the card
    through ``greedy_decode``, timed."""
    import dataclasses

    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models import Model
    from repro_torch.models.transformer import param_count
    cfg32 = dataclasses.replace(spec.config, dtype=torch.float32)
    t0 = time.perf_counter()
    host = Model(cfg32, device="cpu", generator=torch.Generator().manual_seed(0))
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = Model(cfg32, device=DEVICE, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    print(f"[lm] {LM_FULL} full width: {param_count(card) / 1e9:.3f} B parameters, "
          f"{cfg32.num_layers} layers, d {cfg32.d_model}, vocab {cfg32.vocab_size}; init "
          f"{t_init:.1f}s on the CPU, {t_card:.1f}s drawn and copied to the card", flush=True)
    want, want_toks, _ = _lm_decode(host, LM_STEPS, LM_BATCH)
    got, _, _ = _lm_decode(card, LM_STEPS, LM_BATCH, teacher=want_toks)
    scale = float(want.abs().max())
    atol = 1e-4 * scale
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * atol
    argmax_ok = torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    err = float((got - want).abs().max())
    print(f"[lm] {LM_FULL} float32, {LM_STEPS} steps x {LM_BATCH} teacher-forced by the CPU's "
          f"greedy tokens: max|dlogit| {err:.3g} of max|logit| {scale:.3g}; argmax equal at "
          f"{int(clear.sum())}/{clear.numel()} positions with a top-2 margin over "
          f"{2 * atol:.3g}: {argmax_ok} ({card_name})", flush=True)
    if not (torch.allclose(got, want, rtol=1e-4, atol=atol) and argmax_ok):
        raise SystemExit(f"[lm] MISMATCH {LM_FULL} float32: max err {err}")
    del host
    card.cfg = spec.config       # as published: the same float32 weights, bfloat16 activations
    B, tokens, max_len = LM_GREEDY
    torch.cuda.reset_peak_memory_stats()
    runs = [greedy_decode(card, B, tokens, max_len) for _ in range(2)]
    seqs, dt = runs[-1]
    if not (torch.equal(runs[0][0], seqs) and seqs.shape == (B, tokens + 1)
            and int(seqs.max()) < spec.config.vocab_size):
        raise SystemExit(f"[lm] {LM_FULL} bfloat16 greedy decode: tokens differ between runs")
    print(f"[lm] {LM_FULL} bfloat16 greedy_decode batch {B}, {tokens} tokens, max_len "
          f"{max_len}: first run {runs[0][1]:.3f}s, second {dt:.3f}s = {dt / tokens * 1e3:.2f} "
          f"ms a decode step, {B * tokens / dt:.1f} tok/s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card_name})", flush=True)


def phase_lm(card: str, src: Path) -> None:
    """The LM decode path on the card against the CPU (TF32 off), then the
    launcher's --arch path in subprocesses."""
    import os

    from repro_torch.configs import ARCH_NAMES, get_arch
    env = {**os.environ, "PYTHONPATH": str(src.resolve())}
    launchers = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *a],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env=env) for a in LM_LAUNCHER]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in ARCH_NAMES:
            spec = get_arch(arch)
            f32 = _lm_pair(arch, spec, torch.float32, card)
            _lm_pair(arch, spec, torch.bfloat16, card, teacher=f32["tokens"])
        _lm_full(get_arch(LM_FULL), card)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        for p in launchers:
            if p.poll() is None:
                p.wait(timeout=300)
    for args, p in zip(LM_LAUNCHER, launchers):
        out, err = p.communicate()
        line = [ln for ln in out.splitlines() if "tok/s" in ln]
        print(f"[lm] python -m repro_torch.launch.serve {' '.join(args)}: exit {p.returncode}; "
              f"{line[0] if line else 'no tok/s line'} ({card})", flush=True)
        if p.returncode != 0 or not line:
            raise SystemExit(f"[lm] launcher {args} failed:\n{err[-2000:]}")


def example_lines(text: str) -> list:
    import re
    return [re.sub(TIMING, " <t>", ln) for ln in text.splitlines()
            if ln.strip() and not ln.startswith("hottest spans")]


def phase_examples(card: str) -> None:
    """examples/quickstart_torch.py and mine_patterns_torch.py on the card,
    side by side in subprocesses: each exits 0 and prints EXAMPLE_LINES."""
    procs = {name: subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{name}_torch.py")],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in EXAMPLE_LINES}
    t0 = time.perf_counter()
    for name, p in procs.items():
        out, err = p.communicate(timeout=600)
        got, want = example_lines(out), EXAMPLE_LINES[name]
        if name == "quickstart" and torch.cuda.device_count() > 1:
            want = want + [EXAMPLE_MESH_LINE]
        print(f"[examples] {name}_torch.py: exit {p.returncode}, {len(got)} lines, "
              f"{sum(a == b for a, b in zip(got, want))} equal to the JAX example's, "
              f"{time.perf_counter() - t0:.1f}s ({card})", flush=True)
        if p.returncode != 0 or got != want:
            for a, b in zip(got + [""] * len(want), want + [""] * len(got)):
                if a != b:
                    print(f"[examples]   got {a!r}\n[examples]  want {b!r}", flush=True)
            raise SystemExit(f"[examples] {name}_torch.py differs from the JAX example:\n"
                             f"{err[-2000:]}")


def _train_pair(arch: str, spec, card_name: str) -> None:
    """The arch's smoke config in float32 on the card and on the CPU, same
    weights: two train steps (TRAIN_STEPS) on one batch (the launcher's zero
    extras), loss within rtol 1e-4 and gnorm within rtol 1e-3 of the CPU's at
    each step, the second loss at most the first + 0.1; then bfloat16 on the
    card, two steps, for the record (finite, the same + 0.1 criterion)."""
    import dataclasses

    from repro_torch.launch.train import zero_extras
    from repro_torch.models import Model
    from repro_torch.train import OptConfig, SyntheticLMData, adamw_init, make_train_step
    B, S = TRAIN_SMOKE
    runs = {}
    for label, dtype, device in (("cpu", torch.float32, "cpu"), ("card", torch.float32, DEVICE),
                                 ("bf16", torch.bfloat16, DEVICE)):
        cfg = dataclasses.replace(spec.smoke_config, dtype=dtype)
        model = Model(cfg, device=device, generator=torch.Generator().manual_seed(0))
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 SyntheticLMData(cfg.vocab_size, S, B).batch_at(0).items()}
        batch.update(zero_extras(spec, cfg, B, S, device))
        opt_cfg = OptConfig(lr=3e-3)
        opt, step_fn = adamw_init(model.tree(), opt_cfg), make_train_step(model, opt_cfg)
        runs[label] = []
        for step in TRAIN_STEPS:
            out = step_fn(opt, batch, step)
            step_fn.apply(opt, out)
            runs[label].append({k: float(v) for k, v in out.items()})
    (l0, l1), (g0, g1) = ([r[k] for r in runs["card"]] for k in ("loss", "gnorm"))
    dl = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(runs["card"], runs["cpu"]))
    dg = max(abs(a["gnorm"] - b["gnorm"]) / b["gnorm"] for a, b in zip(runs["card"], runs["cpu"]))
    b0, b1 = (r["loss"] for r in runs["bf16"])
    print(f"[train] {arch} smoke float32, steps {TRAIN_STEPS} at {B} x {S}: loss {l0:.6f} -> "
          f"{l1:.6f}, gnorm {g0:.4f}, {g1:.4f}; card against CPU: loss rel {dl:.2e}, gnorm rel "
          f"{dg:.2e}; bfloat16 loss {b0:.4f} -> {b1:.4f} ({card_name})", flush=True)
    ok = (dl <= 1e-4 and dg <= 1e-3 and l1 <= l0 + 0.1 and b1 <= b0 + 0.1
          and all(math.isfinite(r[k]) for v in runs.values() for r in v for k in r))
    if not ok:
        raise SystemExit(f"[train] MISMATCH {arch}: {runs}")


def _train_full_f32(spec, card_name: str) -> None:
    """qwen3-0.6b at full width in float32, the card against the CPU, step by
    step: two steps (TRAIN_STEPS) on one TRAIN_F32 batch, loss within rtol
    1e-5 and gnorm within rtol 1e-4 at each step; the first step's gradients
    leaf by leaf (relative L2), the three farthest printed."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.train import OptConfig, SyntheticLMData, adamw_init, make_train_step
    B, S = TRAIN_F32
    cfg = dataclasses.replace(spec.config, dtype=torch.float32)
    opt_cfg = OptConfig(lr=3e-3)
    t0 = time.perf_counter()
    models, opts, fns, batches, runs = {}, {}, {}, {}, {}
    for device in ("cpu", DEVICE):
        models[device] = Model(cfg, device=device, generator=torch.Generator().manual_seed(0))
        opts[device] = adamw_init(models[device].tree(), opt_cfg)
        fns[device] = make_train_step(models[device], opt_cfg)
        batches[device] = {k: torch.from_numpy(v).to(device) for k, v in
                           SyntheticLMData(cfg.vocab_size, S, B).batch_at(0).items()}
        runs[device] = []
    worst = []
    for i, step in enumerate(TRAIN_STEPS):
        outs = {d: fns[d](opts[d], batches[d], step) for d in runs}
        if i == 0:
            for (name, a), (_, b) in zip(models["cpu"].named_parameters(),
                                         models[DEVICE].named_parameters()):
                ref = a.grad.double()
                rel = float((b.grad.cpu().double() - ref).norm() / ref.norm().clamp(min=1e-30))
                worst.append((rel, name))
        for d in runs:
            fns[d].apply(opts[d], outs[d])
            runs[d].append({k: float(v) for k, v in outs[d].items()})
    card, host = runs[DEVICE], runs["cpu"]
    dl = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(card, host))
    dg = [abs(a["gnorm"] - b["gnorm"]) / b["gnorm"] for a, b in zip(card, host)]
    worst = sorted(worst, reverse=True)[:3]
    print(f"[train] {LM_FULL} full width float32, steps {TRAIN_STEPS} at {B} x {S}: loss "
          f"{host[0]['loss']:.6f} -> {host[1]['loss']:.6f} (CPU), {card[0]['loss']:.6f} -> "
          f"{card[1]['loss']:.6f} (card); loss rel {dl:.2e}, gnorm rel {dg[0]:.2e}, {dg[1]:.2e}; "
          f"first step's grads, farthest leaves (relative L2): "
          f"{', '.join(f'{n} {r:.1e}' for r, n in worst)}; both sides "
          f"{time.perf_counter() - t0:.1f}s ({card_name})", flush=True)
    if not (dl <= 1e-5 and max(dg) <= 1e-4):
        raise SystemExit(f"[train] MISMATCH {LM_FULL} float32: {runs}")


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops dispatched while active (backward ones included)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _tree_bytes(tree) -> int:
    from repro_torch.train.optimizer import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _train_full_bf16(spec, card_name: str) -> None:
    """qwen3-0.6b as published (bfloat16 activations, float32 params)
    through ``launch.train --full``: TRAIN_BF16, the loss falling, ms a step
    (median of the steps after the first), tokens a second, peak memory; one
    step's aten ops and device busy time; TRAIN_8BIT_STEPS steps with 8-bit
    state; one step at TRAIN_LONG whose peak less params, grads and state
    stays below one whole (B, S, V) float32 logits tensor."""
    import gc
    import statistics

    from repro_torch.launch import train as launch_train
    from repro_torch.train import OptConfig, SyntheticLMData, adamw_init, make_train_step
    cfg = spec.config
    torch.cuda.reset_peak_memory_stats()
    run = launch_train.main(["--arch", LM_FULL, "--full", *TRAIN_BF16, "--device", DEVICE])
    model, losses = run.pop("model"), run["losses"]
    B, S = int(TRAIN_BF16[1]), int(TRAIN_BF16[3])
    ms = statistics.median(run["step_seconds"][1:]) * 1e3
    TRAIN_MS[(B, S)] = ms
    peak = torch.cuda.max_memory_allocated()
    params = _tree_bytes(model.tree())
    state = _tree_bytes(run.pop("opt_state"))
    print(f"[train] {LM_FULL} full width bfloat16, launch.train --full {' '.join(TRAIN_BF16)}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (min {min(losses):.4f}), {len(losses)} "
          f"steps accepted; {ms:.2f} ms a step (median of steps 1-{len(losses) - 1}; step 0 "
          f"{run['step_seconds'][0] * 1e3:.1f} ms), {B * S / ms * 1e3:.0f} tok/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB (params {params / 2**30:.2f}, grads "
          f"{params / 2**30:.2f}, 32-bit state {state / 2**30:.2f} GiB) ({card_name})", flush=True)
    if not (len(losses) == int(TRAIN_BF16[5]) and losses[-1] < losses[0]
            and all(math.isfinite(x) for x in losses)):
        raise SystemExit(f"[train] {LM_FULL} bfloat16: the loss did not fall: {losses}")
    del run
    gc.collect()
    torch.cuda.empty_cache()

    def steps(bits: int, B: int, S: int, n: int, first: int = 100):
        """n steps of a fresh ``bits`` state at (B, S) from step ``first``:
        (losses, host seconds a step ended by a synchronize, peak bytes, state
        bytes)."""
        opt_cfg = OptConfig(lr=3e-4, state_bits=bits)
        data = SyntheticLMData(cfg.vocab_size, S, B, seed=1)
        torch.cuda.reset_peak_memory_stats()
        opt, step_fn = adamw_init(model.tree(), opt_cfg), make_train_step(model, opt_cfg)
        out, secs = [], []
        for step in range(first, first + n):
            batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch_at(step).items()}
            m, dt = _timed(lambda: _apply_step(step_fn, opt, batch, step))
            out.append(m)
            secs.append(dt)
        peak, nbytes = torch.cuda.max_memory_allocated(), _tree_bytes(opt)
        del opt, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        return out, secs, peak, nbytes

    # one step's aten ops, and its device busy time against its wall
    opt_cfg = OptConfig(lr=3e-4)
    opt, step_fn = adamw_init(model.tree(), opt_cfg), make_train_step(model, opt_cfg)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             SyntheticLMData(cfg.vocab_size, S, B).batch_at(0).items()}
    _apply_step(step_fn, opt, batch, 100)
    with _OpCount() as ops:
        _apply_step(step_fn, opt, batch, 101)
    wall, busy, traced, _ = _busy(lambda: _apply_step(step_fn, opt, batch, 102))
    print(f"[train] {LM_FULL} bfloat16 step at {B} x {S}: {ops.n} aten ops dispatched (forward, "
          f"backward with the units' recompute, AdamW); wall {wall:.2f} ms untraced, device busy "
          f"{busy:.2f} ms of {traced:.2f} ms traced ({busy / traced:.1%}); "
          f"{wall / ops.n * 1e3:.1f} us of wall an op ({card_name})", flush=True)
    del opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    q, secs, peak8, state8 = steps(8, B, S, TRAIN_8BIT_STEPS)
    ms8 = statistics.median(secs[1:]) * 1e3
    print(f"[train] {LM_FULL} bfloat16, state_bits=8, {TRAIN_8BIT_STEPS} steps at {B} x {S}: "
          f"loss {q[0]['loss']:.4f} -> {q[-1]['loss']:.4f}; {ms8:.2f} ms a step, "
          f"{B * S / ms8 * 1e3:.0f} tok/s; max_memory_allocated {peak8 / 2**30:.2f} GiB, 8-bit "
          f"state {state8 / 2**30:.2f} GiB ({card_name})", flush=True)
    LB, LS = TRAIN_LONG
    q, secs, peak_long, state_long = steps(32, LB, LS, 1)
    logits = LB * LS * cfg.vocab_size * 4
    rest = peak_long - 2 * params - state_long
    print(f"[train] {LM_FULL} bfloat16, one step at {LB} x {LS} (loss_chunk {cfg.loss_chunk}): "
          f"loss {q[0]['loss']:.4f}, {secs[0] * 1e3:.1f} ms; max_memory_allocated "
          f"{peak_long / 2**30:.2f} GiB, less params, grads and state {rest / 2**30:.2f} GiB "
          f"against {logits / 2**30:.2f} GiB for one whole ({LB}, {LS}, {cfg.vocab_size}) float32 "
          f"logits tensor ({card_name})", flush=True)
    if not (rest < logits and all(math.isfinite(m["loss"]) for m in q)):
        raise SystemExit(f"[train] {LM_FULL} at {TRAIN_LONG}: peak less params, grads and state "
                         f"{rest} bytes, not below {logits}")


def _apply_step(step_fn, opt, batch, step) -> dict:
    out = step_fn(opt, batch, step)
    m = {k: float(v) for k, v in out.items()}
    step_fn.apply(opt, out)
    return m


STEP_LINE = r"\[train\] step (\d+) loss=(\S+) gnorm=(\S+) lr=\S+"


def _crash_restart(procs: dict, card_name: str) -> None:
    """The crash run exits 17, the restart prints "restored step" and then
    the uninterrupted run's loss and gnorm (to the printed digits: the card's
    embedding backward adds with atomics, so the two runs may differ in the
    last bits); the final checkpoints' largest difference is printed."""
    import re

    import numpy as np
    out, err = {}, {}
    for k in ("crash", "whole"):
        out[k], err[k] = procs[k].communicate(timeout=600)
    rc = {k: procs[k].returncode for k in ("crash", "whole")}
    if rc["crash"] != 17 or rc["whole"] != 0:
        raise SystemExit(f"[train] crash run exit {rc['crash']} (want 17), uninterrupted "
                         f"{rc['whole']}:\n{err['crash'][-2000:]}{err['whole'][-2000:]}")
    t0 = time.perf_counter()
    res = subprocess.run(procs["resume"], capture_output=True, text=True, timeout=600,
                         env=procs["env"])
    resumed = {int(s): (float(a), float(b)) for s, a, b in re.findall(STEP_LINE, res.stdout)}
    whole = {int(s): (float(a), float(b)) for s, a, b in re.findall(STEP_LINE, out["whole"])}
    restored = [ln.split(" from ")[0] for ln in res.stdout.splitlines()
                if "restored step" in ln]
    diff = max((max(abs(a - c), abs(b - d)) for s, (a, b) in resumed.items()
                for c, d in [whole[s]]), default=float("inf"))
    with np.load(procs["ck"] + "/step_9/arrays.npz") as x, \
            np.load(procs["ck2"] + "/step_9/arrays.npz") as y:
        dp = max(float(np.abs(x[k].astype(np.float64) - y[k]).max()) for k in x.files)
    print(f"[train] crash and restart on the card (smoke, 10 steps at 2 x 16, checkpoints every "
          f"4): crash exit 17; restart exit {res.returncode}, {restored[0] if restored else '-'}; "
          f"steps {sorted(resumed)} against the uninterrupted run: max |dloss|, |dgnorm| "
          f"{diff:.1e} (printed to 4 and 3 digits); final checkpoints max |d| {dp:.2e}; "
          f"{time.perf_counter() - t0:.1f}s ({card_name})", flush=True)
    if not (res.returncode == 0 and restored and sorted(resumed) == list(range(4, 10))
            and diff <= 1e-3):
        raise SystemExit(f"[train] restart differs:\n{res.stdout[-2000:]}{res.stderr[-2000:]}")


def _example_100m(proc, t0: float, card_name: str) -> None:
    """examples/train_100m_torch.py on the card: exit 0, its lines, and the
    final loss below ln V - 1 ("LEARNED structure")."""
    out, err = proc.communicate(timeout=900)
    for ln in out.splitlines():
        print(f"[train]   {ln}", flush=True)
    print(f"[train] examples/train_100m_torch.py: exit {proc.returncode}, "
          f"{time.perf_counter() - t0:.1f}s from the phase's start ({card_name})", flush=True)
    if proc.returncode != 0 or "LEARNED structure" not in out:
        raise SystemExit(f"[train] train_100m_torch.py did not learn:\n{err[-2000:]}")


def phase_train(card: str, src: Path) -> None:
    """LM training on the card: the smoke configs and qwen3-0.6b float32
    against the CPU (TF32 off), qwen3-0.6b bfloat16 through launch.train
    --full, crash and restart in subprocesses, and the 100M example."""
    import os
    import tempfile

    from repro_torch.configs import ARCH_NAMES, get_arch
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(src.resolve())}
    tmp = tempfile.TemporaryDirectory()
    ck, ck2 = os.path.join(tmp.name, "ck"), os.path.join(tmp.name, "ck2")
    train = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CRASH, "--device", DEVICE]
    procs = {
        "crash": subprocess.Popen(train + ["--ckpt", ck, "--inject-failure", "5"], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "whole": subprocess.Popen(train + ["--ckpt", ck2], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True),
        "resume": train + ["--ckpt", ck], "env": env, "ck": ck, "ck2": ck2}
    example = subprocess.Popen([sys.executable, str(ROOT / "examples" / "train_100m_torch.py")],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in ARCH_NAMES:
            _train_pair(arch, get_arch(arch), card)
        _train_full_f32(get_arch(LM_FULL), card)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        _crash_restart(procs, card)
        _example_100m(example, t0, card)
        _train_full_bf16(get_arch(LM_FULL), card)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        for p in (procs["crash"], procs["whole"], example):
            if p.poll() is None:
                p.kill()
        tmp.cleanup()


# The LM partition rules, the sharded train step, the dry run and the
# roofline (distributed/sharding.py, compression.py, launch/mesh.py,
# launch/dryrun.py, roofline/), each check in a subprocess of its own so that
# a fake or NCCL default process group never meets the other phases.
TRAIN_MS: dict = {}              # the train phase's ms a step, by (batch, seq)
DIST_ARCHS = ("qwen3-0.6b", "deepseek-v2-lite-16b")
DIST_STEPS = 3
DIST_ROOF = (8, 512)             # batch, seq of the roofline's qwen3-0.6b bfloat16 step

DIST_DRYRUN = r"""
import json, sys, tempfile, time
import torch
from repro_torch.launch.dryrun import run_cell
from repro_torch.roofline.analysis import H100
t0 = time.perf_counter()
with tempfile.TemporaryDirectory() as d:
    r = run_cell("qwen3-0.6b", "train_4k", False, d, device="cuda")
print(json.dumps({"record": r, "seconds": time.perf_counter() - t0,
                  "hbm": H100.hbm_bytes,
                  "total_memory": torch.cuda.get_device_properties(0).total_memory}))
"""

DIST_CARD = r"""
import dataclasses, json, socket, sys, time
import torch
import torch.distributed as dist
from repro_torch.configs import get_arch
from repro_torch.distributed.compression import compressed_mean
from repro_torch.launch.mesh import device_mesh
from repro_torch.models.transformer import Model
from repro_torch.roofline.analysis import H100, CostCounter, model_flops_6nd, roofline_report
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.train_step import ShardedTrainStep, TrainStep

archs, steps, (RB, RS) = json.loads(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
with socket.socket() as s:                       # a free local port for the rendezvous
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
mesh = device_mesh((1, 1), ("data", "model"), "cuda")
out = {"steps": {}}
for arch in archs:
    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.smoke_config, dtype=torch.float32)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=0)
    runs = []
    for sharded in (False, True):
        model = Model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        oc = OptConfig(lr=3e-3)
        if sharded:
            step = ShardedTrainStep(model, mesh, opt_cfg=oc, total_steps=steps)
            opt = step.init_state()
        else:
            step, opt = TrainStep(model, oc, steps), adamw_init(model.tree(), oc)
        got = []
        for i in range(steps):
            b = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(i).items()}
            m = step(opt, b, i)
            got.append([float(m["loss"]), float(m["gnorm"])])
            step.apply(opt, m)
        runs.append(got)
    out["steps"][arch] = runs
# compressed_mean on the card's world against the same call on a CPU gloo group
x = torch.randn(4096, generator=torch.Generator().manual_seed(3))
e = torch.randn(4096, generator=torch.Generator().manual_seed(4)) * 1e-3
gloo = dist.new_group(backend="gloo")
card = [t.cpu() for t in compressed_mean(x.cuda(), None, e.cuda())]
host = compressed_mean(x, gloo, e)
out["compressed"] = [bool(torch.equal(a, b)) for a, b in zip(card, host)]
dist.destroy_process_group()
# the roofline of one qwen3-0.6b bfloat16 step on one card (no process group)
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
spec = get_arch("qwen3-0.6b")
model = Model(spec.config, device="cuda", generator=torch.Generator().manual_seed(0))
oc = OptConfig(lr=3e-4)
step, opt = TrainStep(model, oc), adamw_init(model.tree(), oc)
b = {k: torch.from_numpy(v).cuda()
     for k, v in SyntheticLMData(spec.config.vocab_size, RS, RB).batch_at(0).items()}
step.apply(opt, step(opt, b, 100))
torch.cuda.synchronize()
with CostCounter() as c:
    step.apply(opt, step(opt, b, 101))
    torch.cuda.synchronize()
n = sum(p.numel() for p in model.parameters())
roof = roofline_report(c.flops, c.bytes, {}, 1, H100, model_flops=model_flops_6nd(n, RB * RS))
out["roofline"] = {"flops": c.flops, "bytes": c.bytes, "ops": c.ops, "params": n, **roof}
print(json.dumps(out))
"""


# compress_pods on a one-rank ('pod', 'data', 'model') = (1, 1, 1) mesh: the
# same DIST_STEPS float32 steps of qwen3-0.6b's smoke config on the card
# (NCCL) and on the CPU (gloo), each in a world of its own
DIST_PODS = r"""
import dataclasses, json, socket, sys
import torch
import torch.distributed as dist
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import device_mesh
from repro_torch.models.transformer import Model
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.train_step import jit_train_step

device, steps = sys.argv[1], int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
with socket.socket() as s:                       # a free local port for the rendezvous
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
if device == "cuda":
    torch.cuda.set_device(0)
dist.init_process_group("nccl" if device == "cuda" else "gloo",
                        init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
mesh = device_mesh((1, 1, 1), ("pod", "data", "model"), device)
cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke_config, dtype=torch.float32)
model = Model(cfg, device=device, generator=torch.Generator().manual_seed(0))
data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=0)
oc = OptConfig(lr=3e-3)
step, _ = jit_train_step(model, mesh, opt_cfg=oc, total_steps=steps, compress_pods=True)
opt = adamw_init(model.tree(), oc)
got = []
for i in range(steps):
    m = step(opt, {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(i).items()}, i)
    got.append([float(m["loss"]), float(m["gnorm"])])
    step.apply(opt, m)
print(json.dumps({"steps": got, "compressed": step.pod_group is not None}))
dist.destroy_process_group()
"""


def _dist_run(script: str, args: list, env: dict):
    return subprocess.Popen([sys.executable, "-c", script, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _dist_result(proc, label: str, timeout: int = 600) -> dict:
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise SystemExit(f"[dist] {label}: exit {proc.returncode}\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def phase_dist(card: str, src: Path) -> None:
    """(a) launch.dryrun's qwen3-0.6b train_4k cell on the single-pod mesh
    (a fake world of 256 ranks, fake cuda tensors, full width): status ok, an
    all-reduce among its collectives, the JAX layout's argument bytes equal to
    the port's own per-unit shard bytes, HW.hbm_bytes within the card's
    memory; (b) the sharded step on a real one-card NCCL world ((1, 1) mesh,
    TF32 off): DIST_STEPS steps of each DIST_ARCHS smoke config in float32,
    loss and gnorm within rtol 1e-5 of the one-device TrainStep on the card;
    (c) compressed_mean on that world bit for bit equal to the same call on
    CPU tensors over a gloo group; (d) the roofline of one qwen3-0.6b
    bfloat16 DIST_ROOF step on the card (CostCounter's counted FLOPs and
    bytes, no collectives), printed beside the train phase's measured ms a
    step and the MFU (6·N·tokens / (step s x peak)), not gated; (e)
    compress_pods=True on a one-card NCCL ('pod', 'data', 'model') = (1, 1, 1)
    mesh: DIST_STEPS float32 steps of qwen3-0.6b's smoke config, loss and
    gnorm within rtol 1e-5 of the same steps on the CPU over gloo."""
    import os
    env = {**os.environ, "PYTHONPATH": str(src.resolve())}
    t0 = time.perf_counter()
    dry = _dist_run(DIST_DRYRUN, [], env)
    crd = _dist_run(DIST_CARD, [json.dumps(DIST_ARCHS), str(DIST_STEPS), json.dumps(DIST_ROOF)],
                    env)
    pods = {dev: _dist_run(DIST_PODS, [dev, str(DIST_STEPS)], env) for dev in ("cuda", "cpu")}
    try:
        res = _dist_result(crd, "the card's world")
        d = _dist_result(dry, "dry run")
        pod = {dev: _dist_result(p, f"compress_pods on {dev}") for dev, p in pods.items()}
    finally:
        for p in (dry, crd, *pods.values()):
            if p.poll() is None:
                p.kill()
    for arch, (one, sharded) in res["steps"].items():
        dl = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(sharded, one))
        dg = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(sharded, one))
        print(f"[dist] (b) {arch} smoke float32, {DIST_STEPS} steps at 4 x 16 on a one-card NCCL "
              f"(1, 1) mesh: ShardedTrainStep against TrainStep, loss rel {dl:.2e}, gnorm rel "
              f"{dg:.2e}; losses {[round(a[0], 6) for a in sharded]} ({card})", flush=True)
        if not (dl <= 1e-5 and dg <= 1e-5):
            raise SystemExit(f"[dist] {arch}: the sharded step differs from TrainStep: {res}")
    print(f"[dist] (c) compressed_mean on the card's world against a CPU gloo group: mean, "
          f"residual bit for bit {res['compressed']} ({card})", flush=True)
    if res["compressed"] != [True, True]:
        raise SystemExit("[dist] compressed_mean on the card differs from its CPU value")
    card_s, cpu_s = pod["cuda"]["steps"], pod["cpu"]["steps"]
    dl = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(card_s, cpu_s))
    dg = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(card_s, cpu_s))
    print(f"[dist] (e) compress_pods=True, qwen3-0.6b smoke float32, {DIST_STEPS} steps at 4 x "
          f"16 on a one-card NCCL ('pod', 'data', 'model') = (1, 1, 1) mesh against the same "
          f"steps on the CPU (gloo): loss rel {dl:.2e}, gnorm rel {dg:.2e}; losses "
          f"{[round(a[0], 6) for a in card_s]}, gnorms {[round(a[1], 6) for a in card_s]} "
          f"({card})", flush=True)
    if not (pod["cuda"]["compressed"] and pod["cpu"]["compressed"] and len(card_s) == DIST_STEPS
            and dl <= 1e-5 and dg <= 1e-5):
        raise SystemExit(f"[dist] compress_pods on the card differs from the CPU: {pod}")
    r = d["record"]
    if r["status"] != "ok":
        raise SystemExit(f"[dist] dry run of qwen3-0.6b train_4k: {r.get('error')}")
    m = r["scan_measure"]
    mem, coll = m["memory"], m["collectives"]
    print(f"[dist] (a) launch.dryrun qwen3-0.6b train_4k single pod ({r['chips']} fake ranks, "
          f"fake cuda tensors): {m['ops']} local aten ops traced in {m['compile_s']:.1f} s "
          f"({d['seconds']:.1f} s with start-up); per device: {m['cost']['flops']:.4e} FLOP, "
          f"{m['cost']['bytes']:.4e} bytes unfused, collectives {coll}; argument "
          f"{mem['argument_bytes']} bytes (per-unit {mem['argument_bytes_port']}), temp "
          f"{mem['temp_bytes'] / 1e9:.2f} GB, peak {mem['peak_bytes'] / 1e9:.2f} GB, fits "
          f"{r['fits_hbm']}; dominant {r['roofline']['dominant']} (H100 data sheet constants: "
          f"estimates, not measurements); HW.hbm_bytes {d['hbm']:.0f} against the card's "
          f"{d['total_memory']} ({card})", flush=True)
    if not ("all-reduce" in coll and mem["argument_bytes"] == mem["argument_bytes_port"]
            and d["hbm"] <= d["total_memory"]):
        raise SystemExit(f"[dist] dry-run record fails its checks: {r}")
    rf = res["roofline"]
    B, S = DIST_ROOF
    ms = TRAIN_MS.get((B, S))
    mfu = (f"{rf['model_flops'] / (ms / 1e3 * HW_BF16_FLOPS):.2%}" if ms else
           "not measured (the train phase did not run)")
    print(f"[dist] (d) roofline of one {LM_FULL} bfloat16 {B} x {S} step on one card: "
          f"{rf['ops']} aten ops, {rf['flops']:.4e} FLOP, {rf['bytes']:.4e} bytes unfused; "
          f"compute {rf['compute_s'] * 1e3:.2f} ms, memory {rf['memory_s'] * 1e3:.2f} ms, bound "
          f"{rf['bound_step_s'] * 1e3:.2f} ms ({rf['dominant']}); the train phase's step "
          f"{f'{ms:.2f} ms' if ms else 'not measured'}; MFU (6·N·tokens {rf['model_flops']:.4e} "
          f"over step x {HW_BF16_FLOPS:.4g}) {mfu} ({card})", flush=True)
    print(f"[dist] {time.perf_counter() - t0:.1f}s", flush=True)


HW_BF16_FLOPS = 989.4e12         # H100 SXM bf16 dense, NVIDIA data sheet (roofline.HW)

PHASES = ("card", "build", "parity", "csr", "main", "weighted", "sparse", "forest",
          "reference", "host", "emit", "fsm", "telemetry", "shard", "serve", "isa", "bitmap",
          "lm", "examples", "train", "dist", "profile")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory that holds repro_torch (default: src/ beside "
                         "this file); another checkout's, to measure it with this script")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES) + "; the "
                         "result lines are printed only when every phase ran")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES) or ("weighted" in phases and "main" not in phases):
        ap.error(f"--phases {args.phases}: pick from {PHASES} (weighted needs main)")
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not (args.src / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch under {args.src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    t0 = time.perf_counter()
    run = set(phases)
    report = {name: {"max_abs_err": 0} for name in KERNELS}
    launches, graphs, counts = {}, {}, {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        print(f"[phase] {name}: {time.perf_counter() - t:.1f}s", flush=True)
        return out
    card = timed("card", phase_card) if "card" in run else card_name()
    if "build" in run:
        timed("build", phase_build)
    if "parity" in run:
        report = timed("parity", phase_parity)
    if "csr" in run:
        timed("csr", phase_csr, report)
    if run & {"main", "forest", "reference", "host", "emit", "fsm", "telemetry", "shard",
              "serve", "isa", "bitmap", "profile"}:
        graphs = timed("graphs", build_graphs)
    if "main" in run:
        counts, launches = timed("main", phase_main_path, graphs)
    if "weighted" in run:
        launches.update(timed("weighted", phase_weighted, graphs, counts))
    if "sparse" in run:
        launches.update(timed("sparse", phase_sparse))
    if "forest" in run:
        timed("forest", phase_forest, graphs)
    if "reference" in run:
        timed("reference", phase_reference, graphs, card, args.src)
    if "host" in run:
        launches.update(timed("host", phase_host, graphs))
    emit_launches = {}
    if "emit" in run:
        emit_launches = timed("emit", phase_emit, graphs, card)
    if "fsm" in run:
        timed("fsm", phase_fsm, graphs, card)
    if "telemetry" in run:
        timed("telemetry", phase_telemetry, graphs, card)
    shard_launches = {}
    if "shard" in run:
        shard_launches = timed("shard", phase_shard, graphs, card)
    serve_launches, isa_launches = {}, {}
    if "serve" in run:
        serve_launches = timed("serve", phase_serve, graphs, card)
    if "isa" in run:
        isa_launches = timed("isa", phase_isa, graphs, card)
    if "bitmap" in run:
        launches.update(timed("bitmap", phase_bitmap, graphs))
    if "lm" in run:
        timed("lm", phase_lm, card, args.src)
    if "examples" in run:
        timed("examples", phase_examples, card)
    if "train" in run:
        timed("train", phase_train, card, args.src)
    if "dist" in run:
        timed("dist", phase_dist, card, args.src)
    if "profile" in run:
        timed("profile", phase_profile, graphs)
    print(f"[done] {time.perf_counter() - t0:.1f}s", flush=True)
    if run != set(PHASES):
        print(json.dumps({"phases": phases, "times": report}), flush=True)
        return 0
    # vinter's launches are both forms' (the grid form's also as
    # grid_launches); its grid_* keys time the grid form
    report["vinter"]["grid_launches"] = launches["vinter_grid"]
    rows = [{"name": name, **KERNELS[name], "launches": launches[name],
             "emit_launches": emit_launches.get(name, 0),
             "shard_launches": shard_launches.get(name, 0),
             "serve_launches": serve_launches.get(name, 0),
             "isa_launches": isa_launches.get(name, 0), "parity": True, **report[name]}
            for name in KERNELS]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
