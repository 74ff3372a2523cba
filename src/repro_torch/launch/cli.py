"""Shared CLI flag builders for the launch drivers.

``mine.py``, ``serve.py`` and ``dryrun.py`` historically each declared
their own copies of the common flags; this module is the single place
those flags are defined so spellings, defaults and help text cannot
drift between entry points. Each builder adds one coherent flag group to
an ``argparse`` parser; the resulting namespace is what
``MinerConfig.from_args`` consumes (``--shards`` -> ``mesh``,
``--trace`` -> tracing-enabled ``Telemetry``, ``--chunk`` -> ``chunk``).
"""
from __future__ import annotations

import argparse

__all__ = ["add_graph_args", "add_out_args", "add_service_args",
           "add_session_args"]


def add_graph_args(ap: argparse.ArgumentParser, dataset_flag: str = "--dataset",
                   default: str = "email-eu-core", choices=None,
                   help: str | None = None) -> None:  # noqa: A002
    """Dataset selection: ``--dataset`` (or an alias like serve's
    ``--mine``, which doubles as its mode switch) + ``--scale``."""
    ap.add_argument(dataset_flag, default=default, choices=choices,
                    help=help or "dataset name (repro.graph.datasets)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="subsample the dataset to this fraction")


def add_session_args(ap: argparse.ArgumentParser) -> None:
    """Session construction + observability flags, shared by every driver
    that builds a ``Miner`` (consumed by ``MinerConfig.from_args``)."""
    ap.add_argument("--shards", type=int, default=0,
                    help="mine data-parallel over an N-way device mesh "
                         "(the first N cards; N times the CPU with "
                         "--device cpu)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="wave chunk size (default: auto-sized)")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="enable span tracing and write a Chrome-trace "
                         "(Perfetto) JSON of the run's span tree")
    ap.add_argument("--session-stats", action="store_true",
                    help="print session/service cache+retrace counters and "
                         "the Prometheus-style metrics snapshot")


def add_service_args(ap: argparse.ArgumentParser) -> None:
    """Mining-service load flags (``serve.py``): traffic shape and the
    per-request deadline for the admission/timeout path."""
    ap.add_argument("--qps", type=float, default=0.0,
                    help="run the threaded load generator at this target "
                         "qps instead of deterministic rounds (0 = rounds)")
    ap.add_argument("--clients", type=int, default=4,
                    help="load-generator client threads")
    ap.add_argument("--requests", type=int, default=48,
                    help="total load-generator requests")
    ap.add_argument("--timeout-ms", type=float, default=0.0,
                    help="per-request deadline in milliseconds "
                         "(0 = no deadline); expired requests complete "
                         "with the typed timeout rejection")


def add_out_args(ap: argparse.ArgumentParser, default_out: str) -> None:
    """Artifact output flags (``dryrun.py``-style drivers)."""
    ap.add_argument("--out", default=default_out,
                    help="artifact output directory")
    ap.add_argument("--force", action="store_true",
                    help="recompute cells whose artifact already exists")
