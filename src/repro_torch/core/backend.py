"""ExecutionBackend: the seam between the control plane and run execution.

The paper's Flows service separates the *management* plane (publish, auth,
admission, status) from the *execution* fleet that actually drives state
machines.  This module carves the same seam through the reproduction:

* :class:`InlineBackend` — today's thread-per-shard
  :class:`~repro.core.shard_pool.EngineShardPool`, unchanged: every shard
  engine lives in the calling process, the deterministic ``PoolScheduler``
  VirtualClock merge keeps working, and it stays the default for every
  existing test and differential suite.
* :class:`~repro.core.process_backend.ProcessBackend` — shard groups
  hosted in spawned worker processes, each owning its engines, journal
  segments, providers, and worker threads, while the control plane stays
  in the parent and talks over a framed pipe protocol.  One hot shard can
  no longer serialize the rest behind the GIL.

:func:`make_backend` is the one constructor the service layer calls; the
backend *name* ("thread" | "process") is plain data, so a service config
can choose a topology without importing process machinery it won't use.

Contract (ARCHITECTURE invariant 13): for the same flows and inputs, both
backends produce the same terminal run states — the process boundary is
an execution detail, never a semantic one.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING

from .shard_pool import EngineShardPool

if TYPE_CHECKING:  # pragma: no cover - typing only
    from . import actions as ap
    from .clock import Clock


class ExecutionBackend(abc.ABC):
    """What the control plane needs from an execution substrate.

    The surface is the run lifecycle — submit, observe, cancel, wake,
    recover, shut down — plus the aggregate views ``FlowsService`` serves
    (``runs``, ``stats``).  Implementations are duck-compatible with
    :class:`~repro.core.shard_pool.EngineShardPool`; this ABC names the
    core so a new backend cannot silently miss a verb.
    """

    #: short name for benchmarks / logs ("thread", "process", ...)
    backend_name: str = "?"

    @abc.abstractmethod
    def start_run(self, flow, flow_input, **kwargs):
        """Submit a run; returns a Run-shaped handle (``.run_id``, ``.status``)."""

    @abc.abstractmethod
    def get_run(self, run_id: str):
        """The live handle for ``run_id`` (raises ``NotFound``)."""

    @abc.abstractmethod
    def cancel_run(self, run_id: str):
        """Request cancellation; returns the handle."""

    @abc.abstractmethod
    def wait(self, run_id: str, timeout: float | None = None) -> bool:
        """Block until the run is terminal (True) or ``timeout`` (False)."""

    @abc.abstractmethod
    def wake_run(self, run_id: str) -> bool:
        """Rehydrate/wake a parked run; True when something woke."""

    @abc.abstractmethod
    def recover(self, flows, resume: bool = True) -> list:
        """Replay durable segments; resume unfinished runs when asked."""

    @abc.abstractmethod
    def shutdown(self) -> None:
        """Stop execution machinery (threads / worker processes)."""


class InlineBackend(EngineShardPool, ExecutionBackend):
    """Thread-per-shard execution in the calling process (the default).

    Exactly :class:`~repro.core.shard_pool.EngineShardPool` — the class
    exists so "which backend is this?" has a first-class answer and so
    the seam is visible in type terms, not just duck typing.
    """

    backend_name = "thread"


def make_backend(
    name: str,
    registry: "ap.ActionRegistry",
    *,
    num_shards: int = 1,
    clock: "Clock | None" = None,
    journal=None,
    journal_path: str | None = None,
    journals=None,
    fsync: bool = False,
    journal_latency_s: float = 0.0,
    group_commit: bool = True,
    compact_every: int | None = None,
    polling=None,
    max_workers: int = 8,
    start_threads: bool | None = None,
    delta_journal: bool = True,
    snapshot_every: int = 64,
    passivate_after: float | None = None,
    map_steal_bound: int | None = None,
    admission_window: int | None = None,
    options: dict | None = None,
) -> ExecutionBackend:
    """Build the named execution backend.

    ``name="thread"`` (or ``"inline"``) returns an :class:`InlineBackend`
    accepting every pool knob.  ``name="process"`` returns a
    :class:`~repro.core.process_backend.ProcessBackend`; because worker
    processes rebuild their own registries, ``options`` must carry a
    ``registry_spec`` ("module:callable" — see process_backend), and
    inline-only knobs (live ``journal=``/``journals=`` objects, polling
    policies, passivation) are rejected rather than silently dropped.
    """
    options = dict(options or {})
    if name in ("thread", "inline"):
        return InlineBackend(
            registry,
            num_shards=num_shards,
            clock=clock,
            journal=journal,
            journal_path=journal_path,
            journals=journals,
            fsync=fsync,
            journal_latency_s=journal_latency_s,
            group_commit=group_commit,
            compact_every=compact_every,
            polling=polling,
            max_workers=max_workers,
            start_threads=start_threads,
            delta_journal=delta_journal,
            snapshot_every=snapshot_every,
            passivate_after=passivate_after,
            map_steal_bound=map_steal_bound,
            admission_window=admission_window,
        )
    if name == "process":
        unsupported = {
            "journal=": journal,
            "journals=": journals,
            "polling=": polling,
            "passivate_after=": passivate_after,
            "map_steal_bound=": map_steal_bound,
        }
        bad = [k for k, v in unsupported.items() if v is not None]
        if bad:
            raise ValueError(
                f"process backend does not support {', '.join(bad)} "
                "(live objects cannot cross the process boundary)"
            )
        registry_spec = options.pop("registry_spec", None)
        if not registry_spec:
            raise ValueError(
                "process backend needs options={'registry_spec': "
                "'module:callable'} so workers can rebuild their registries"
            )
        from .process_backend import ProcessBackend  # avoid import cycle

        return ProcessBackend(
            registry_spec,
            num_shards=num_shards,
            clock=clock,
            journal_path=journal_path,
            fsync=fsync,
            journal_latency_s=journal_latency_s,
            group_commit=group_commit,
            compact_every=compact_every,
            max_workers=max_workers,
            delta_journal=delta_journal,
            snapshot_every=snapshot_every,
            admission_window=admission_window,
            **options,
        )
    raise ValueError(f"unknown execution backend {name!r}")
