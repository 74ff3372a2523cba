"""Request objects + typed completion errors for the mining service.

A ``ServiceRequest`` is the handle ``MiningService.submit`` returns: the
submitting thread parks on ``result()`` (a ``threading.Event`` under the
hood) while the service's tick loop batches, executes and completes the
request. Completion is terminal and single-shot — exactly one of

* ``done``     — ``results`` holds one value per submitted query;
* ``rejected`` — admission control refused the request at submit time
  (queue full); ``result()`` raises ``RequestRejected``;
* ``timeout``  — the request's deadline passed before a tick executed it;
  ``result()`` raises ``RequestTimeout``;
* ``failed``   — execution raised; ``result()`` re-raises the cause
  wrapped in ``RequestFailed``.

Queries are resolved (``plan.resolve_query``) at submit time, so a
request always carries hashable ``Pattern``/``Motif`` objects — the same
keys the result cache and the session's plan cache use.
"""
from __future__ import annotations

import threading
import time

__all__ = ["RequestFailed", "RequestRejected", "RequestTimeout",
           "ServiceRequest"]


class RequestRejected(RuntimeError):
    """Admission control refused the request (max_in_flight reached)."""


class RequestTimeout(TimeoutError):
    """The request's deadline passed before the service executed it."""


class RequestFailed(RuntimeError):
    """Execution of the request's batch raised (cause chained)."""


class ServiceRequest:
    """One in-flight query batch. Built by ``MiningService.submit`` only.

    Thread contract: the service thread is the single writer (``_finish``);
    any number of client threads may block in ``result()``/``wait()``.
    """

    __slots__ = ("id", "queries", "traffic_class", "aggregate",
                 "submitted_at", "deadline", "state", "results", "error",
                 "latency_s", "from_cache", "_done")

    def __init__(self, rid: int, queries: tuple, traffic_class: str,
                 timeout_s: float | None = None,
                 aggregate: str | None = None):
        self.id = rid
        self.queries = queries                  # resolved, hashable
        self.traffic_class = traffic_class
        self.aggregate = aggregate              # None => count query
        self.submitted_at = time.monotonic()
        self.deadline = (None if timeout_s is None
                         else self.submitted_at + float(timeout_s))
        self.state = "pending"
        self.results: list | None = None        # one entry per query
        self.error: BaseException | None = None
        self.latency_s: float | None = None     # submit -> completion
        self.from_cache = False                 # every query cache-served
        self._done = threading.Event()

    # ------------------------------------------------------------ service
    def _finish(self, state: str, results: list | None = None,
                error: BaseException | None = None,
                from_cache: bool = False) -> None:
        """Terminal transition (service thread). Idempotence guard: a
        request completes exactly once."""
        if self.state != "pending":
            raise RuntimeError(f"request {self.id} already {self.state}")
        self.state = state
        self.results = results
        self.error = error
        self.from_cache = from_cache
        self.latency_s = time.monotonic() - self.submitted_at
        self._done.set()

    def expired(self, now: float | None = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                >= self.deadline)

    # ------------------------------------------------------------- client
    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until completed (any terminal state). True if completed."""
        return self._done.wait(timeout)

    def result(self, timeout: float | None = None) -> list:
        """Block for the per-query result list; raise the typed error for
        a rejected / timed-out / failed request."""
        if not self._done.wait(timeout):
            raise RequestTimeout(
                f"request {self.id} still pending after {timeout}s wait "
                "(is the service's tick loop running?)")
        if self.state == "done":
            return self.results
        if self.state == "rejected":
            raise RequestRejected(
                f"request {self.id} rejected: {self.error}")
        if self.state == "timeout":
            raise RequestTimeout(
                f"request {self.id} timed out before execution "
                f"(deadline {self.deadline - self.submitted_at:.3f}s "
                "after submit)")
        raise RequestFailed(
            f"request {self.id} failed: {self.error!r}") from self.error

    def __repr__(self) -> str:
        return (f"ServiceRequest(id={self.id}, state={self.state!r}, "
                f"queries={len(self.queries)}, "
                f"class={self.traffic_class!r})")
