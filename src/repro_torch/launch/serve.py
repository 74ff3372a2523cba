"""Serving launcher: batched greedy decoding against the KV/state caches
(``repro_torch.models``), or a concurrent graph-mining service
(``repro_torch.serving``).

  python -m repro_torch.launch.serve --arch rwkv6-3b --tokens 32
  python -m repro_torch.launch.serve --arch qwen3-0.6b --device cpu
  python -m repro_torch.launch.serve --mine email-eu-core --rounds 4
  python -m repro_torch.launch.serve --mine email-eu-core --scale 0.25 \\
      --device cpu --rounds 2
  python -m repro_torch.launch.serve --mine email-eu-core \\
      --qps 50 --clients 4 --timeout-ms 2000
  python -m repro_torch.launch.serve --mine email-eu-core --scale 0.25 \\
      --device cpu --shards 8

The counterpart of ``repro.launch.serve``. Without ``--mine`` it decodes:
the architecture's smoke config (``--arch``, one of ``configs.ARCH_NAMES``)
with random weights from a seeded generator, ``--batch`` streams of
``--tokens`` greedy tokens from token 0 against caches of ``--max-len``
(seamless first encodes 16 zero frames), and prints the tokens a second
and the first stream's tokens. ``--mine`` is a thin launcher over
``serving.MiningService``: the app mix (T/TC/TT/4C + the 4-motif batch) is
submitted as CONCURRENT requests and each round's tick merges them into
shared forest schedules across requests (fused feed passes < sum of the
requests' independent schedules). Round mode is deterministic —
steady-state rounds must be bit-identical with 0 retraces; ``--qps``
switches to the threaded load generator and reports p50/p99/qps.
``--shards N`` adds a mesh-sharded worker class serving the heavy motif
batch, mixed with the unsharded default class in one pool.

The model and the sessions run on the CUDA device unless ``--device cpu``;
the session flags are ``launch.cli``'s, read by ``MinerConfig.from_args``.
Observability (``repro_torch.obs``): ``--session-stats`` appends the
service's Prometheus-style metrics snapshot; ``--trace out.json``
span-traces the service's ticks and writes the Chrome-trace/Perfetto JSON
on exit.
"""
from __future__ import annotations

import argparse
import time

import torch

from .cli import add_graph_args, add_service_args, add_session_args


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def greedy_decode(model, batch: int, tokens: int, max_len: int, enc=None):
    """``tokens`` greedy decode steps of ``batch`` streams from token 0, on
    caches of ``max_len`` (``enc``: the encoder's (states, positions), for an
    encoder-decoder). Returns ((batch, tokens + 1) int64 tokens on the
    model's device, seconds of the loop, ended by a synchronize on a card)."""
    caches, _ = model.init_cache(batch, max_len)
    if model.cfg.first_dense:
        caches["dense"] = model.init_dense_cache(batch, max_len)[0]
    tok = torch.zeros((batch, 1), dtype=torch.long, device=model.device)
    out = [tok]
    _sync(model.device)
    t0 = time.perf_counter()
    for i in range(tokens):
        logits, caches = model.decode_step(tok, i, caches, *(enc or ()))
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    _sync(model.device)
    return torch.cat(out, dim=1), time.perf_counter() - t0


def serve_lm(args) -> None:
    """Greedy decoding of ``args.arch``'s smoke config, as the JAX launcher
    decodes it: random weights from seed 0, ``args.batch`` x ``args.tokens``
    tokens, caches of ``args.max_len``; seamless decodes against the encoder
    states of 16 zero frames."""
    from repro_torch.configs import ARCH_NAMES, get_arch

    if args.arch not in ARCH_NAMES:
        raise SystemExit(f"[serve] --arch must be one of {ARCH_NAMES}")
    spec = get_arch(args.arch)
    cfg = spec.smoke_config
    model = spec.model(smoke=True, device=args.device,
                       generator=torch.Generator().manual_seed(0))
    enc = None
    if cfg.encoder_layers:
        frames = torch.zeros((args.batch, 16, cfg.d_model), device=model.device)
        with torch.no_grad():
            enc = model._encode({"frames": frames})
    seqs, dt = greedy_decode(model, args.batch, args.tokens, args.max_len, enc)
    print(f"[serve] {args.arch}: {args.batch}x{args.tokens} tokens in "
          f"{dt:.2f}s = {args.batch * args.tokens / dt:.1f} tok/s")
    print("[serve] sample:", seqs[0, :16].tolist())


def serve_mining(args) -> None:
    """Serve the app mix through one ``MiningService``.

    Round mode (default): each round submits the mix as concurrent
    requests and ticks once — counts must repeat bit-identically and
    steady-state rounds must retrace nothing. ``--qps`` mode drives the
    threaded ``LoadGenerator`` instead."""
    from repro_torch.graph import get_dataset
    from repro_torch.graph.datasets import dataset_stats
    from repro_torch.mining import FOUR_MOTIF_SHAPES, MinerConfig
    from repro_torch.obs import Telemetry
    from repro_torch.serving import LoadGenerator, MiningService, WorkerSpec

    if args.rounds < 1:
        raise SystemExit("[serve] --rounds must be >= 1")
    g = get_dataset(args.mine, scale=args.scale)
    print(f"[serve] mining {args.mine} x{args.scale} on {args.device}: {dataset_stats(g)}")
    telemetry = Telemetry(enabled=bool(args.trace))
    # worker pool: an unsharded default class; --shards N adds a
    # mesh-sharded class that serves the heavy motif batch
    specs = [WorkerSpec("default", MinerConfig.from_args(args, mesh=None))]
    bulk = "default"
    if args.shards > 1:
        specs.append(WorkerSpec("bulk", MinerConfig.from_args(args)))
        bulk = "bulk"
    svc = MiningService(
        g, workers=tuple(specs), telemetry=telemetry, cache_results=False,
        timeout_s=(args.timeout_ms / 1e3) if args.timeout_ms else None)
    for spec in specs:
        w = svc.pool.worker(spec.traffic_class)
        if w.mesh is not None:
            print(f"[serve] worker {spec.traffic_class!r}: mesh "
                  f"{dict(w.mesh.shape)}")
    # the request mix: four single-pattern requests + the 4-motif batch,
    # heterogeneous on purpose — the tick merges them across requests
    motif_names = list(FOUR_MOTIF_SHAPES)
    requests = [("triangle",), ("three-chain",), ("tailed-triangle",),
                ("4-clique",), tuple(motif_names)]
    classes = ["default"] * 4 + [bulk]
    labels = ["T", "TC", "TT", "4C"] + motif_names
    queries_per_round = len(requests)

    if args.qps:
        lg = LoadGenerator(
            svc, list(zip(requests, classes)), requests=args.requests,
            clients=args.clients, qps=args.qps,
            timeout_s=(args.timeout_ms / 1e3) if args.timeout_ms else None)
        res = lg.run()
        fp = res["feed_passes"]
        print(f"[serve] load: {res['completed']}/{res['requests']} done "
              f"({res['rejected']} rejected, {res['timeouts']} timed out) "
              f"in {res['wall_s']:.2f}s = {res['qps']:.1f} queries/s")
        if res["completed"]:
            print(f"[serve] latency: p50 {res['p50_s'] * 1e3:.1f}ms, "
                  f"p99 {res['p99_s'] * 1e3:.1f}ms")
        print(f"[serve] sharing: {fp['fused']} fused feed passes vs "
              f"{fp['independent']} independent (cross-request batching)")
    else:
        first = None
        warm_retraces = steady = 0.0
        fp_round = None
        for r in range(args.rounds):
            before = svc.stats["retraces"]
            t0 = time.perf_counter()
            handles = [svc.submit(qs, traffic_class=tc)
                       for qs, tc in zip(requests, classes)]
            tick = svc.tick()
            flat = [v for h in handles for v in h.result(0)]
            res = dict(zip(labels, flat))
            dt = time.perf_counter() - t0
            retraces = svc.stats["retraces"] - before
            fp_round = tick["feed_passes"]
            if first is None:
                first, warm_retraces = res, retraces
            else:
                if res != first:
                    raise SystemExit(f"[serve] round {r} counts {res} != round 0's {first}")
                if retraces:
                    raise SystemExit(f"[serve] steady-state round {r} rebuilt "
                                     f"{retraces} executables")
                steady += dt
            print(f"[serve] round {r}: {dt:.3f}s, "
                  f"{tick['requests']} requests merged, {retraces} retraces"
                  + ("  (warm-up: schedules + builds)" if r == 0 else ""))
        if not fp_round["fused"] < fp_round["independent"]:
            raise SystemExit(f"[serve] no cross-request sharing: {fp_round}")
        print(f"[serve] sharing: {fp_round['fused']} fused feed passes vs "
              f"{fp_round['independent']} independent per tick "
              f"(cross-request batching)")
        if args.rounds > 1:
            per = steady / (args.rounds - 1)
            print(f"[serve] steady state: {per:.3f}s/round = "
                  f"{queries_per_round / max(per, 1e-9):.1f} queries/s, "
                  f"0 retraces (resident sessions + executable caches; "
                  f"warm-up built {warm_retraces})")
        print(f"[serve] counts sample: T={first['T']} 4C={first['4C']}")
    st = svc.stats
    print(f"[serve] service: {st['service_requests']} requests "
          f"({st['service_queries']} queries) over {st['service_ticks']} "
          f"ticks, workers {sorted(st['workers'])}, "
          f"{st['retraces']} executables built in all")
    if args.trace:
        path = svc.write_trace(args.trace)
        print(f"[serve] trace: "
              f"{sum(1 for _ in telemetry.tracer.spans())} spans -> {path}")
    if args.session_stats:
        print("[serve] metrics:")
        print(svc.prometheus_text(), end="")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="LLM decoding: the architecture whose smoke config decodes")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    add_graph_args(ap, dataset_flag="--mine", default="",
                   help="serve the mining app mix through a MiningService "
                        "on this dataset instead of LLM decoding")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model or of the worker sessions (cuda, "
                         "or cpu for plain torch)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="with --mine: deterministic serving rounds")
    add_session_args(ap)
    add_service_args(ap)
    args = ap.parse_args(argv)
    if args.mine:
        serve_mining(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
