"""FlowEngine: the state-machine executor (paper §5.3).

The paper's Flows service deploys each flow to Amazon Step Functions; action
states send invocation messages to an SQS action queue, and Lambda workers
invoke/poll the action providers with an exponential-backoff schedule (first
poll after 2 s, doubling up to a 600 s cap — §5.3.2 / §6.1).  Offline, this
engine provides the same execution semantics on one machine:

* a **scheduler** (time-ordered event heap) plays the role of SQS deferred
  delivery — every dispatch, poll, retry and Wait is a scheduled event;
* a **worker pool** plays the role of Lambda — events execute on a thread
  pool in real-time mode, or inline and deterministically under a
  :class:`~repro.core.clock.VirtualClock`;
* the **journal** plays the role of ASF's managed state — every transition is
  written ahead, and :meth:`FlowEngine.recover` resumes unfinished runs after
  a crash.

The *paper-faithful* polling policy (2 s initial, x2, 600 s cap) is the
default; :class:`PollingPolicy` exposes the knobs, and ``use_callbacks=True``
enables the beyond-paper completion-callback optimization measured in
EXPERIMENTS.md §Perf.
"""

from __future__ import annotations

import copy
import secrets
import threading
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from .. import tracing as _tracing
from . import actions as ap
from . import asl
from .auth import AuthContext
from .clock import Clock, RealClock
from .errors import (
    ActionFailedException,
    ActionTimeout,
    AutomationError,
    BranchFailed,
    MapItemFailed,
    NotFound,
    StateMachineError,
    error_matches,
)
from .chaos import hash_uniform
from .journal import (
    Journal,
    JournalCrashed,
    JournalFenced,
    RunImage,
    SimulatedCrash,
    replay_segment,
    terminal_map_children,
)
from .timer_wheel import TimerHandle, TimerWheel

RUN_ACTIVE = "ACTIVE"
RUN_SUCCEEDED = "SUCCEEDED"
RUN_FAILED = "FAILED"
RUN_CANCELLED = "CANCELLED"
#: stalled runs (paper §7: e.g. expired credentials) — kept, not terminal
RUN_INACTIVE = "INACTIVE"

#: ring-buffer cap on a run's in-memory event log (web-app Events tab).
#: Long-lived runs (paper: "seconds to weeks") otherwise accumulate events
#: without bound; beyond the cap the oldest events are dropped and counted.
MAX_RUN_EVENTS = 256


def _error_details(exc: AutomationError) -> dict | None:
    """State-failure ``Details`` payload: auth errors carry their
    machine-readable ``code`` so Catch handlers can see *why* (token_expired
    vs consent_required vs scope_mismatch), not just the error family."""
    code = getattr(exc, "code", None)
    return {"code": code} if code is not None else None


@dataclass
class PollingPolicy:
    """Paper §5.3.2: initial 2 s, doubled per poll, capped at 600 s."""

    initial_seconds: float = 2.0
    multiplier: float = 2.0
    cap_seconds: float = 600.0
    #: beyond-paper: subscribe to in-process completion callbacks and fall
    #: back to (rare) guard polls.  The paper's Lambda pollers cannot do this
    #: across a network boundary; an in-process control plane can.
    use_callbacks: bool = False

    def next_interval(self, current: float) -> float:
        return min(current * self.multiplier, self.cap_seconds)


@dataclass
class MapJoin:
    """Bookkeeping for one Map state's dynamic fan-out (engine-internal).

    Lives on the *parent* run while its Map state executes.  The items list
    and the (pre-sized) results list are the only O(items) structures; live
    child :class:`Run` objects are bounded by the admission window
    (``MaxConcurrency``) — a 10k-item Map with ``MaxConcurrency=16`` never
    materializes more than 16 children at once (ARCHITECTURE invariant 8).
    All fields are guarded by the parent's ``run.lock``.
    """

    items: list
    results: list          # slot per item, filled in completion order
    #: the Map state's effective input (InputPath-narrowed) — the document
    #: ItemSelector's ``$.context`` references resolve against
    scope_doc: Any = None
    next_index: int = 0    # first unadmitted item
    live: int = 0          # admitted children not yet terminal
    done: int = 0          # terminal children (any status)
    failed: int = 0        # children that ended RUN_FAILED
    peak_live: int = 0     # high-water mark (window-bound assertions)
    window: int = 0        # effective MaxConcurrency (0 -> len(items))
    failing: bool = False  # tolerance exceeded; stop admitting, fail at join
    #: children currently placed off their hash-home shard by the
    #: least-loaded policy — bounds the pool's foreign-residency index
    #: (work stealing stops adapting once the bound is hit)
    stolen_live: int = 0


@dataclass
class Run:
    run_id: str
    flow: asl.Flow
    flow_id: str
    creator: str
    caller: AuthContext | None
    run_as: dict[str, AuthContext] = field(default_factory=dict)
    label: str = ""
    tags: list[str] = field(default_factory=list)
    monitor_by: set[str] = field(default_factory=set)
    manage_by: set[str] = field(default_factory=set)

    context: Any = None
    current_state: str | None = None
    attempt: int = 0
    status: str = RUN_ACTIVE
    error: dict | None = None
    start_time: float = 0.0
    completion_time: float | None = None
    cancel_requested: bool = False

    # live action being waited on
    action_id: str | None = None
    action_provider_url: str | None = None
    action_deadline: float | None = None
    poll_generation: int = 0  # invalidates stale scheduled polls

    # Parallel / Map fan-out support
    parent: "Run | None" = None
    branch_index: int = 0
    parent_state: str | None = None
    children: "list[Run]" = field(default_factory=list)
    #: one join per fan-out: concurrently completing children must not both
    #: consume the Parallel join (double-transition); reset by _exec_parallel
    join_claimed: bool = False
    #: live Map fan-out bookkeeping (parent side; None outside a Map state)
    map_join: MapJoin | None = None
    #: high-water mark of simultaneously-live Map children across this run's
    #: Map states — survives the join so tests/benchmarks can assert the
    #: admission-window bound (ARCHITECTURE invariant 8) after completion
    map_peak_live: int = 0
    #: the join this child was admitted under (child side) — a Retry that
    #: re-enters the Map state builds a NEW join with the same child ids, so
    #: stale children from the superseded attempt must not touch it
    of_join: MapJoin | None = None
    #: the engine this run is resident on.  For pool-started runs this is
    #: the home shard; for cross-shard Map children it is the shard the
    #: placement policy chose — completion routing and cancellation always
    #: go through it instead of assuming co-location with the parent.
    engine: "FlowEngine | None" = field(default=None, repr=False)
    #: True when the least-loaded policy placed this Map child off its
    #: hash-home shard (releases the join's ``stolen_live`` budget slot)
    foreign_placed: bool = False

    #: True while the run is journaled-but-idle in an admission lane
    #: (``defer_start=True``); cleared when the DRR pump releases it.  A
    #: failover must transplant such a run without scheduling its first
    #: transition — the admission queue still owns that.
    deferred: bool = False

    # global submission order, stamped by EngineShardPool (0 = shard-internal)
    seq: int = 0
    #: fairness/accounting domain this run is billed to (Tenant.tenant_id);
    #: None = unmetered.  Stamped at submission, inherited by fan-out
    #: children, and preserved across passivation.
    tenant_id: str | None = None

    # events log (web-app Events tab, Fig 2c) — a bounded ring buffer:
    # beyond MAX_RUN_EVENTS the oldest entries are dropped and counted
    events: "deque[dict]" = field(
        default_factory=lambda: deque(maxlen=MAX_RUN_EVENTS)
    )
    events_dropped: int = 0
    # invoked on terminal status (flow-as-action composition, watchers)
    completion_callbacks: list[Callable[["Run"], None]] = field(default_factory=list)

    # -- delta journaling (engine-internal bookkeeping) ---------------------
    #: context-patch ops applied since the last journaled transition record
    pending_patch: list[dict] = field(default_factory=list)
    #: False until a record carrying the full context has been journaled
    #: (parallel branch children have no run_created record of their own)
    context_journaled: bool = False
    #: delta records since the last full-context record (snapshot cadence)
    patch_records: int = 0

    lock: threading.RLock = field(default_factory=threading.RLock)
    done: threading.Event = field(default_factory=threading.Event)

    def log_event(self, t: float, code: str, **details: Any) -> None:
        if len(self.events) == self.events.maxlen:
            self.events_dropped += 1
        self.events.append({"time": t, "code": code, "details": details})

    def as_status(self) -> dict:
        doc = {
            "run_id": self.run_id,
            "flow_id": self.flow_id,
            "label": self.label,
            "status": self.status,
            "current_state": self.current_state,
            "creator": self.creator,
            "start_time": self.start_time,
            "completion_time": self.completion_time,
            "events_dropped": self.events_dropped,
            "details": (
                {"output": self.context}
                if self.status == RUN_SUCCEEDED
                else {"error": self.error}
                if self.error
                else {}
            ),
        }
        with self.lock:
            join = self.map_join
            if join is not None:
                # progress rollup for a run inside a Map state (web-app view)
                doc["map"] = {
                    "items": len(join.items),
                    "completed": join.done,
                    "failed": join.failed,
                    "live": join.live,
                    "max_concurrency": join.window,
                }
        return doc


# shared by every stub whose run carries no tags/ACLs — the common case,
# where per-stub empty containers would otherwise dominate the stub's
# footprint (an empty set alone is ~4x a frozenset reference)
_NO_ACL: frozenset = frozenset()
_NO_RUN_AS: dict = {}


class DormantStub:
    """Residue of a passivated run (ARCHITECTURE invariant 9).

    When a run parks in a long Wait or between far-apart action polls, the
    engine serializes it to its journal segment (a ``run_passivated``
    record) and keeps only this stub: enough to answer ``as_status()`` and
    to fire the wake-up, with no context document, no event ring and no
    locks — so a million dormant flows cost a million small stubs plus one
    coarse timer-wheel bucket entry each, not a million resident
    :class:`Run` s (measured by benchmarks/fig_dormant_scale.py).
    """

    # duck-typed against Run for the status/RBAC surfaces
    parent = None
    status = RUN_ACTIVE

    __slots__ = (
        "run_id", "flow", "flow_id", "creator", "caller", "run_as", "label",
        "state", "attempt", "mode", "wake_time", "start_time", "seq",
        "tenant_id", "tags", "monitor_by", "manage_by", "events_dropped",
        "journal_ref", "wake_handle",
    )

    def __init__(
        self,
        *,
        run_id: str,
        flow: asl.Flow,
        flow_id: str,
        creator: str,
        caller: AuthContext | None,
        run_as: dict[str, AuthContext],
        label: str,
        state: str,
        attempt: int,
        mode: str,
        wake_time: float,
        start_time: float,
        seq: int,
        tenant_id: str | None,
        tags: tuple[str, ...],
        monitor_by: frozenset[str],
        manage_by: frozenset[str],
        events_dropped: int,
        journal_ref: tuple[int, int] | None,
    ):
        self.run_id = run_id
        self.flow = flow
        self.flow_id = flow_id
        self.creator = creator
        self.caller = caller
        self.run_as = run_as
        self.label = label
        self.state = state
        self.attempt = attempt
        #: "wait" — the run parked inside a Wait state and wakes straight
        #: into the wait's transition; "action" — it parked between action
        #: polls and wakes by re-entering the state (the journaled
        #: ``request_id`` makes the re-dispatch idempotent)
        self.mode = mode
        self.wake_time = wake_time
        self.start_time = start_time
        self.seq = seq
        self.tenant_id = tenant_id
        self.tags = tags
        self.monitor_by = monitor_by
        self.manage_by = manage_by
        self.events_dropped = events_dropped
        #: (journal generation, append offset) of the run_passivated record
        #: — the page-table entry rehydration seeks to; stale (and ignored)
        #: once the journal compacts to a newer generation
        self.journal_ref = journal_ref
        self.wake_handle: TimerHandle | None = None

    @property
    def current_state(self) -> str:
        return self.state

    def as_status(self) -> dict:
        return {
            "run_id": self.run_id,
            "flow_id": self.flow_id,
            "label": self.label,
            "status": RUN_ACTIVE,
            "current_state": self.state,
            "creator": self.creator,
            "start_time": self.start_time,
            "completion_time": None,
            "events_dropped": self.events_dropped,
            "details": {},
            "dormant": True,
            "wake_time": self.wake_time,
        }


class Scheduler:
    """Time-ordered event queue shared by real and virtual modes.

    Storage is a hierarchical :class:`~repro.core.timer_wheel.TimerWheel`
    rather than a flat heap: insertion is O(1) and a million dormant
    far-future wake-ups (run passivation, long Waits) sit in coarse buckets
    instead of a million-entry comparison heap.  The wheel's pop order is
    *exactly* the old heap's — ``(due time, submission seq)`` — which is
    what keeps :meth:`~repro.core.shard_pool.PoolScheduler.drain`'s
    deterministic merge unchanged (differentially tested in
    tests/core/test_timer_wheel.py).
    """

    def __init__(self, clock: Clock):
        self.clock = clock
        self._wheel = TimerWheel(now=clock.now())
        self._cv = threading.Condition()
        self._stopped = False

    def call_at(
        self, t: float, fn: Callable[..., None], arg: Any = None
    ) -> TimerHandle:
        # ``arg`` rides on the handle (see TimerHandle.fire) so mass
        # schedulers — a million dormant wake-ups — share one callback
        # object instead of allocating a closure per entry
        with self._cv:
            handle = self._wheel.schedule(t, fn, arg)
            self._cv.notify_all()
        return handle

    def call_later(
        self, delay: float, fn: Callable[..., None], arg: Any = None
    ) -> TimerHandle:
        return self.call_at(self.clock.now() + max(0.0, delay), fn, arg)

    def submit(self, fn: Callable[[], None]) -> TimerHandle:
        return self.call_later(0.0, fn)

    def cancel(self, handle: TimerHandle) -> bool:
        """Cancel a pending event (False if already fired/cancelled)."""
        with self._cv:
            return self._wheel.cancel(handle)

    # -- virtual-time drive --------------------------------------------------
    def peek_time(self) -> float | None:
        """Due time of the earliest pending event (None when empty).

        Used by :class:`~repro.core.shard_pool.PoolScheduler` to merge many
        shard queues into one global time order.  Exact, not a bucket bound:
        the wheel cascades until the true earliest entry surfaces.
        """
        with self._cv:
            return self._wheel.next_deadline()

    def pop_next(
        self, until: float | None = None
    ) -> tuple[float, Callable[[], None]] | None:
        """Pop the earliest event due at or before ``until`` (None if none)."""
        with self._cv:
            handle = self._wheel.pop(until)
            if handle is None:
                return None
        return handle.t, handle.fire

    def drain(
        self,
        until: float | None = None,
        max_events: int = 10_000_000,
        stop: Callable[[], bool] | None = None,
    ) -> int:
        """Execute events in time order, advancing a virtual clock.

        Returns the number of events executed.  Only meaningful with a
        VirtualClock (deterministic single-threaded execution).  ``stop`` is
        checked between events so callers can drain "until run X completes"
        without executing the (unbounded) tail of poll events behind it.
        """
        n = 0
        while n < max_events:
            if stop is not None and stop():
                return n
            popped = self.pop_next(until)
            if popped is None:
                return n
            t, fn = popped
            self.clock.advance_to(t)
            fn()
            n += 1
        return n

    # -- real-time drive -------------------------------------------------------
    def run_forever(self, executor) -> None:
        while True:
            with self._cv:
                if self._stopped:
                    return
                now = self.clock.now()
                handle = self._wheel.pop(until=now)
                if handle is None:
                    deadline = self._wheel.next_deadline()
                    timeout = (
                        max(0.0, deadline - now) if deadline is not None else None
                    )
                    self.clock.wait(self._cv, timeout)
                    continue
                fn = handle.fire
            executor(fn)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def pending(self) -> int:
        with self._cv:
            return len(self._wheel)


class FlowEngine:
    """Executes flow runs against an :class:`~repro.core.actions.ActionRegistry`."""

    def __init__(
        self,
        registry: ap.ActionRegistry,
        clock: Clock | None = None,
        journal: Journal | None = None,
        polling: PollingPolicy | None = None,
        max_workers: int = 8,
        start_threads: bool | None = None,
        delta_journal: bool = True,
        snapshot_every: int = 64,
        passivate_after: float | None = None,
    ):
        self.registry = registry
        self.clock = clock or RealClock()
        self.journal = journal or Journal()
        self.polling = polling or PollingPolicy()
        #: delta-encode transition records: journal the paths a state wrote
        #: (``context_patch``) instead of the full run context, with a full
        #: ``run_snapshot`` record every ``snapshot_every`` delta records.
        #: ``delta_journal=False`` restores the full-context-per-record
        #: baseline (measured by benchmarks/fig_transition_overhead.py).
        self.delta_journal = delta_journal
        self.snapshot_every = max(1, snapshot_every)
        #: park a run out of the engine when its next wake-up is at least
        #: this many seconds away (None disables passivation).  Parked runs
        #: live in ``dormant`` as :class:`DormantStub` s; their full state is
        #: a ``run_passivated`` journal record.
        self.passivate_after = passivate_after
        self.scheduler = Scheduler(self.clock)
        self.runs: dict[str, Run] = {}
        self.dormant: dict[str, DormantStub] = {}
        #: set by EngineShardPool: the pool this engine is a shard of, and
        #: its shard index.  A bare engine (no pool) hosts every Map child
        #: itself, exactly as before cross-shard placement existed.
        self.pool = None
        self.shard_id = 0
        #: set by the process backend's worker host: called with the
        #: escaped durability-layer exception when no supervisor claims a
        #: crash (the process is the shard; the listener typically exits)
        self.crash_listener: Callable[[BaseException], None] | None = None
        #: live Map children resident on THIS engine (load gauge for the
        #: pool's least-loaded placement; guarded by ``_lock`` for writes,
        #: read dirty by the placement policy)
        self.map_hosted = 0
        #: terminal Map-child results replayed from journal segments
        #: (child_id -> (status, context, error)); a recovered parent's
        #: ``_map_admit`` pops entries instead of re-running those items.
        #: EngineShardPool.recover merges all shards' tables into one shared
        #: dict so children that ran on a foreign shard re-attach too.
        self.recovered_map_results: dict[str, tuple] = {}
        # cached bound method: every dormant wake-up shares this one
        # callback object (its run_id rides on the TimerHandle)
        self._wake_dormant_cb = self._wake_dormant
        self._lock = threading.RLock()
        self.stats = {
            "runs_started": 0,
            "runs_succeeded": 0,
            "runs_failed": 0,
            "runs_cancelled": 0,
            "actions_dispatched": 0,
            "polls": 0,
            "retries": 0,
            "map_items_admitted": 0,
            "map_items_completed": 0,
            "map_children_stolen": 0,
            "runs_passivated": 0,
            "runs_rehydrated": 0,
            "runs_reparked": 0,
        }
        # real-time execution machinery (not used under a virtual clock)
        self._threads: list[threading.Thread] = []
        if start_threads is None:
            start_threads = not self.clock.virtual
        if start_threads:
            self._start_threads(max_workers)

    # ------------------------------------------------------------------ infra
    def _start_threads(self, max_workers: int) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        t = threading.Thread(
            target=self.scheduler.run_forever,
            args=(lambda fn: self._pool.submit(self._guarded, fn),),
            daemon=True,
            name="flow-engine-dispatcher",
        )
        t.start()
        self._threads.append(t)

    def _guarded(self, fn: Callable[[], None]) -> None:
        try:
            fn()
        except (SimulatedCrash, JournalCrashed, JournalFenced) as exc:
            # the crash channel: a durability-layer failure escaped a worker
            # — report it to the shard supervisor (when one is attached) so
            # the pool can fence this shard and re-home its runs online
            self._report_crash(exc)
        except Exception:  # never kill the pool on a bug; runs fail instead
            traceback.print_exc()

    def _report_crash(self, exc: BaseException) -> None:
        pool = self.pool
        supervisor = pool.supervisor if pool is not None else None
        if supervisor is not None and supervisor.on_worker_crash(
            self.shard_id, exc
        ):
            return
        # the process backend's worker host sets this instead of a
        # supervisor: the process *is* the shard, so a durability-layer
        # crash ends the process and the parent's pid-wait takes over
        if self.crash_listener is not None:
            self.crash_listener(exc)
            return
        traceback.print_exc()

    def shutdown(self) -> None:
        self.scheduler.stop()
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)

    def drain(self, until: float | None = None) -> int:
        """Virtual-time drive: run all due events deterministically."""
        return self.scheduler.drain(until=until)

    # ------------------------------------------------------------------- runs
    def start_run(
        self,
        flow: asl.Flow,
        flow_input: dict,
        flow_id: str = "flow",
        creator: str = "anonymous",
        caller: AuthContext | None = None,
        run_as: dict[str, AuthContext] | None = None,
        label: str = "",
        tags: list[str] | None = None,
        monitor_by: list[str] | None = None,
        manage_by: list[str] | None = None,
        run_id: str | None = None,
        seq: int = 0,
        tenant_id: str | None = None,
        defer_start: bool = False,
    ) -> Run:
        # ``seq`` (global submission order) is set at construction — before
        # the run is registered or its first event scheduled — so no journal
        # record or concurrent observer ever sees the default.  The pool
        # stamps it here instead of after start_run returns (the old
        # post-assignment raced the run's first transitions).
        run = Run(
            run_id=run_id or "run-" + secrets.token_hex(8),
            flow=flow,
            flow_id=flow_id,
            creator=creator,
            caller=caller,
            run_as=dict(run_as or {}),
            label=label,
            tags=list(tags or ()),
            monitor_by=set(monitor_by or ()),
            manage_by=set(manage_by or ()),
            context=dict(flow_input),
            start_time=self.clock.now(),
            context_journaled=True,  # run_created carries the full input
            engine=self,
            seq=seq,
            tenant_id=tenant_id,
        )
        with self._lock:
            self.runs[run.run_id] = run
            self.stats["runs_started"] += 1
        self.journal.append(
            {
                "type": "run_created",
                "run_id": run.run_id,
                "flow_id": flow_id,
                "input": run.context,
                "creator": creator,
                "label": label,
                "seq": seq,
                "t": run.start_time,
                **({"tenant": tenant_id} if tenant_id is not None else {}),
            }
        )
        run.log_event(run.start_time, "FlowStarted", input=flow_input)
        _tracing.begin("flows.run", run.run_id, flow_id=flow_id)
        if defer_start:
            run.deferred = True
        else:
            self.scheduler.submit(lambda: self._enter_state(run, flow.start_at))
        return run

    def release_run(self, run: Run) -> None:
        """Admit a run created with ``defer_start=True``.

        The pool's weighted-fair admission queue (repro.core.admission)
        creates metered runs deferred — journaled and visible, but with no
        first transition scheduled — and releases them here in DRR order.
        A run cancelled while parked in the admission queue is a no-op
        (``cancel_run`` already completed it).
        """
        if run.status != RUN_ACTIVE:
            return
        run.deferred = False
        self.scheduler.submit(
            lambda: self._enter_state(run, run.flow.start_at)
        )

    def get_run(self, run_id: str) -> Run:
        """Fetch a run, rehydrating it if it is dormant.

        Callers that only need a status snapshot should use
        :meth:`run_status` / :meth:`peek_run` instead — those answer from
        the stub without paging the run back in.
        """
        with self._lock:
            run = self.runs.get(run_id)
        if run is None and run_id in self.dormant:
            run = self._rehydrate(run_id, fire=False)
        if run is None:
            raise NotFound(f"unknown run {run_id!r}")
        return run

    def peek_run(self, run_id: str) -> "Run | DormantStub":
        """The resident Run or dormant stub, without rehydration."""
        with self._lock:
            run = self.runs.get(run_id)
            if run is not None:
                return run
            stub = self.dormant.get(run_id)
            if stub is not None:
                return stub
        raise NotFound(f"unknown run {run_id!r}")

    def run_status(self, run_id: str) -> dict:
        """Status snapshot; dormant runs answer from their stub (no page-in)."""
        return self.peek_run(run_id).as_status()

    def wake_run(self, run_id: str) -> bool:
        """Rehydrate a dormant run now (external event targeting the run).

        A parked Wait becomes resident with its original deadline re-armed;
        a parked action poll re-enters its state immediately and discovers
        the action's current status.  Returns False when the run is already
        resident (or unknown) — waking is a no-op for live runs.

        True means *this call* performed the rehydration: the stub pop is
        atomic, so if the wake timer (or another caller) wins the race
        between dormancy-check and rehydration, this call observes the pop
        miss and returns False instead of claiming the other actor's work.
        """
        stub = self._pop_stub(run_id)
        if stub is None:
            return False
        self._resume_stub(stub, fire=False)
        return True

    def cancel_run(self, run_id: str) -> Run:
        run = self.get_run(run_id)
        with run.lock:
            if run.status != RUN_ACTIVE:
                return run
            run.cancel_requested = True
            action_id, url = run.action_id, run.action_provider_url
        if action_id and url:
            try:
                provider = self.registry.lookup(url)
                provider.cancel(action_id, self._caller_for(run, None))
            except AutomationError:
                pass
        self.scheduler.submit(lambda: self._check_cancel(run))
        return run

    def _check_cancel(self, run: Run) -> None:
        with run.lock:
            if run.status == RUN_ACTIVE and run.cancel_requested:
                self._complete_run(run, RUN_CANCELLED)

    def wait(self, run_id: str, timeout: float | None = None) -> Run:
        """Block until a run completes (real-time mode)."""
        run = self.get_run(run_id)
        run.done.wait(timeout)
        return run

    def run_to_completion(
        self,
        run_id: str,
        until: float | None = None,
        max_events: int = 10_000_000,
    ) -> Run:
        """Virtual-time mode: drain the scheduler until this run completes.

        ``until`` bounds virtual time — needed for runs that stall on
        external input (e.g. a pending UserSelection keeps generating poll
        events forever, exactly like the real service would).
        """
        run = self.get_run(run_id)
        self.scheduler.drain(
            until=until,
            max_events=max_events,
            stop=lambda: run.status != RUN_ACTIVE,
        )
        return run

    # ------------------------------------------------- delta journaling
    def _record_patch(self, run: Run, op: dict) -> None:
        """Queue one context-patch op for the next transition record.

        Callers hold ``run.lock`` and have already applied the op to
        ``run.context``; in full-context mode the record itself carries the
        whole context, so nothing is queued.
        """
        if self.delta_journal:
            run.pending_patch.append(op)

    def _apply_result(
        self,
        run: Run,
        writer: Callable[[dict, Any], dict],
        result_path: str | None,
        result: Any,
    ) -> None:
        """Apply a compiled ResultPath writer and queue the matching patch op.

        Callers hold ``run.lock``.  ``result_path is None`` discards the
        result (no context change, no patch).
        """
        run.context = writer(run.context, result)
        if result_path is None or not self.delta_journal:
            return
        if result_path == "$":
            # the writer may have wrapped a non-dict result
            run.pending_patch.append({"op": "replace", "value": run.context})
        else:
            run.pending_patch.append(
                {"op": "put", "path": result_path, "value": result}
            )

    def _journal_transition(
        self, run: Run, record: dict, full_context: bool = False
    ) -> int | None:
        """Append a transition record with its context payload.

        Full-context mode (``delta_journal=False``, the pre-delta baseline)
        embeds the entire run context in every record.  Delta mode embeds
        only ``context_patch`` — the ops applied since the previous record —
        and emits a full ``run_snapshot`` record every ``snapshot_every``
        delta records so replay never chases an unboundedly long patch
        chain between checkpoints.  A run whose context has never been
        journaled (a Parallel branch child, which has no ``run_created``
        record) gets a full context on its first record so replay has a
        baseline to patch.

        ``full_context=True`` forces the whole context into this record
        even in delta mode (resetting the patch chain, like a snapshot):
        passivation requires it so one seek to the returned offset
        reconstructs the paged-out run without replaying its patch chain.
        Returns the record's journal offset (see :meth:`Journal.append`).
        """
        snapshot = False
        with run.lock:
            if (
                full_context
                or not self.delta_journal
                or not run.context_journaled
            ):
                record["context"] = run.context
                run.context_journaled = True
                run.pending_patch = []
                run.patch_records = 0
            else:
                record["context_patch"] = run.pending_patch
                run.pending_patch = []
                run.patch_records += 1
                if run.patch_records >= self.snapshot_every:
                    run.patch_records = 0
                    snapshot = True
        offset = self.journal.append(record)
        if snapshot:
            self.journal.append(
                {
                    "type": "run_snapshot",
                    "run_id": run.run_id,
                    "context": run.context,
                    "t": record["t"],
                }
            )
        return offset

    # ----------------------------------------------------------- state machine
    def _enter_state(self, run: Run, state_name: str, attempt: int = 0) -> None:
        with run.lock:
            if run.status != RUN_ACTIVE:
                return
            if run.cancel_requested:
                self._complete_run(run, RUN_CANCELLED)
                return
            run.current_state = state_name
            run.attempt = attempt
            run.poll_generation += 1
        state = run.flow.states.get(state_name)
        if state is None:
            self._run_failed(run, StateMachineError(f"unknown state {state_name}"))
            return
        now = self.clock.now()
        self._journal_transition(
            run,
            {
                "type": "state_entered",
                "run_id": run.run_id,
                "state": state_name,
                "attempt": attempt,
                "t": now,
            },
        )
        run.log_event(now, "StateEntered", state=state_name, kind=state.kind)
        try:
            if state.kind == "Action":
                self._exec_action(run, state)
            elif state.kind == "Pass":
                self._exec_pass(run, state)
            elif state.kind == "Choice":
                self._exec_choice(run, state)
            elif state.kind == "Wait":
                self._exec_wait(run, state)
            elif state.kind == "Fail":
                self._state_failed(run, state, state.error, state.cause or state.name)
            elif state.kind == "Succeed":
                self._complete_run(run, RUN_SUCCEEDED)
            elif state.kind == "Parallel":
                self._exec_parallel(run, state)
            elif state.kind == "Map":
                self._exec_map(run, state)
            else:  # pragma: no cover
                raise StateMachineError(f"unhandled state kind {state.kind}")
        except (SimulatedCrash, JournalCrashed, JournalFenced):
            # durability-layer crash signals are NOT run failures: they mean
            # this whole shard is dying (or already fenced).  Swallowing
            # them into _state_failed would corrupt a run another shard now
            # owns — let them propagate to the crash channel instead.
            raise
        except AutomationError as e:
            self._state_failed(run, state, e.error_name, e.cause, _error_details(e))
        except Exception as e:
            self._state_failed(run, state, "States.Runtime", repr(e))

    # -- simple states ----------------------------------------------------------
    def _exec_pass(self, run: Run, state: asl.State) -> None:
        if state.result is not None:
            result = state.result
        elif state.parameters is not None or state.input_path:
            result = state.input_for(run.context)
        else:
            result = None
        if result is not None:
            with run.lock:
                if state.result_path:
                    self._apply_result(
                        run, state.write_result, state.result_path, result
                    )
                elif isinstance(result, dict):
                    # no ResultPath: merge into the long-lived run Context
                    run.context = {**run.context, **result}
                    self._record_patch(run, {"op": "merge", "value": result})
                else:
                    run.context = {"result": result}
                    self._record_patch(
                        run, {"op": "replace", "value": run.context}
                    )
        self._transition(run, state)

    def _exec_choice(self, run: Run, state: asl.State) -> None:
        for rule in state.choices:
            if rule.compiled()(run.context):
                self._goto(run, rule.next)
                return
        if state.default:
            self._goto(run, state.default)
            return
        raise StateMachineError(f"Choice {state.name}: no rule matched, no Default")

    def _exec_wait(self, run: Run, state: asl.State) -> None:
        seconds = state.wait_seconds(run.context)
        wake_time = self.clock.now() + seconds
        if self._passivation_eligible(run, seconds):
            self._passivate(run, state, wake_time=wake_time, mode="wait")
            return
        self.scheduler.call_at(
            wake_time, lambda: self._finish_wait(run, state)
        )

    def _finish_wait(self, run: Run, state: asl.State) -> None:
        """Complete a Wait: transition iff the run is still parked in it."""
        with run.lock:
            if run.status != RUN_ACTIVE or run.current_state != state.name:
                return
        if not self._live(run):
            return
        self._transition(run, state)

    # -- passivation (ARCHITECTURE invariant 9) -------------------------------
    def _live(self, run: Run) -> bool:
        """True iff this exact Run object is the engine's current one.

        A passivate/rehydrate cycle replaces the Run object; events still
        holding the old object (provider completion callbacks, in-flight
        polls) are ghosts and must not act — the rehydrated successor owns
        the run now.
        """
        with self._lock:
            return self.runs.get(run.run_id) is run

    def _passivation_eligible(self, run: Run, delay: float) -> bool:
        if self.passivate_after is None or delay < self.passivate_after:
            return False
        with run.lock:
            # fan-out members stay resident: joins hold direct object
            # references both ways, and completion callbacks (flow-as-action
            # composition) are closures that cannot be journaled
            return (
                run.status == RUN_ACTIVE
                and run.parent is None
                and not run.children
                and run.map_join is None
                # admission slot-release callbacks don't pin a run resident:
                # _passivate credits the slot back (a dormant run must not
                # hold admission capacity) and drops them
                and not any(
                    not getattr(cb, "admission_slot", False)
                    for cb in run.completion_callbacks
                )
                and not run.cancel_requested
            )

    def _passivate(
        self,
        run: Run,
        state: asl.State,
        wake_time: float,
        mode: str,
        provider: ap.ActionProvider | None = None,
        action_id: str | None = None,
    ) -> None:
        """Page a parked run out of the engine (journal is the backing store).

        Journals a full-context ``run_passivated`` record, swaps the run
        table entry for a :class:`DormantStub`, and schedules the wake-up.
        The stub remembers the record's (generation, offset) so rehydration
        is one seek + one decode; after a compaction the offset goes stale
        and rehydration falls back to a segment replay.
        """
        # a parked run stops consuming admission capacity: credit its slot
        # back now (the callbacks are in-memory closures and would not
        # survive the page-out anyway); wake-from-dormant is not re-admitted
        with run.lock:
            slot_cbs = [
                cb for cb in run.completion_callbacks
                if getattr(cb, "admission_slot", False)
            ]
            if slot_cbs:
                run.completion_callbacks = [
                    cb for cb in run.completion_callbacks
                    if not getattr(cb, "admission_slot", False)
                ]
        for cb in slot_cbs:
            cb(run)
        now = self.clock.now()
        offset = self._journal_transition(
            run,
            {
                "type": "run_passivated",
                "run_id": run.run_id,
                "state": state.name,
                "attempt": run.attempt,
                "mode": mode,
                "wake_time": wake_time,
                "t": now,
            },
            full_context=True,
        )
        generation = self.journal.generation
        stub = DormantStub(
            run_id=run.run_id,
            flow=run.flow,
            flow_id=run.flow_id,
            creator=run.creator,
            caller=run.caller,
            run_as=run.run_as if run.run_as else _NO_RUN_AS,
            label=run.label,
            state=state.name,
            attempt=run.attempt,
            mode=mode,
            wake_time=wake_time,
            start_time=run.start_time,
            seq=run.seq,
            tenant_id=run.tenant_id,
            # read-only views; empties collapse to shared singletons so a
            # tagless, ACL-less run (the common case) pays nothing here
            tags=tuple(run.tags) if run.tags else (),
            monitor_by=frozenset(run.monitor_by) if run.monitor_by else _NO_ACL,
            manage_by=frozenset(run.manage_by) if run.manage_by else _NO_ACL,
            # the in-memory event ring does not survive the page-out;
            # account for it so the status surface stays honest
            events_dropped=run.events_dropped + len(run.events),
            journal_ref=(generation, offset) if offset is not None else None,
        )
        with self._lock:
            # crash window: the record above is durable but the run is still
            # resident — recovery from a crash here re-parks the run from
            # its run_passivated image, which is equivalent
            self.dormant[run.run_id] = stub
            if self.runs.get(run.run_id) is run:
                del self.runs[run.run_id]
            self.stats["runs_passivated"] += 1
        # one cached bound method + the run_id as the handle's arg: no
        # per-stub closure, so a million parked runs share one callback
        stub.wake_handle = self.scheduler.call_at(
            wake_time, self._wake_dormant_cb, arg=run.run_id
        )
        if provider is not None and action_id is not None:
            # early wake when the parked action completes: the rehydrated
            # run re-enters its state and the provider's request_id dedup
            # resolves the re-dispatch to the already-finished action
            try:
                provider.subscribe(
                    action_id,
                    lambda doc, rid=run.run_id: self.scheduler.submit(
                        lambda: self.wake_run(rid)
                    ),
                )
            except (AttributeError, AutomationError):
                pass

    def _wake_dormant(self, run_id: str) -> None:
        """Timer-fired wake-up; a no-op if the run was rehydrated earlier."""
        with self._lock:
            if run_id not in self.dormant:
                return
        try:
            self._rehydrate(run_id, fire=True)
        except Exception:  # pragma: no cover - diagnostics over crash
            traceback.print_exc()

    def _load_passivated_context(self, stub: DormantStub) -> Any:
        """Read the paged-out context back from the journal.

        Fast path: one seek to the stub's recorded offset.  Fallback (the
        offset predates a compaction, or the record is unreadable): replay
        the segment — the checkpoint folded the run_passivated image in, so
        replay still reconstructs it.
        """
        ref = stub.journal_ref
        if ref is not None:
            generation, offset = ref
            if generation == self.journal.generation:
                rec = self.journal.record_at(offset)
                if (
                    rec is not None
                    and rec.get("type") == "run_passivated"
                    and rec.get("run_id") == stub.run_id
                    and "context" in rec
                ):
                    return copy.deepcopy(rec["context"])
        image = replay_segment(self.journal).runs.get(stub.run_id)
        if image is None:
            raise NotFound(
                f"no journaled image for dormant run {stub.run_id!r}"
            )
        return copy.deepcopy(image.context)

    def _pop_stub(self, run_id: str) -> DormantStub | None:
        """Atomically claim a dormant stub (None if not dormant).

        Exactly one caller — the wake timer, ``wake_run``, or ``get_run`` —
        wins the pop; everyone else sees None.  This is the linearization
        point every wake path shares, which is what makes ``wake_run``'s
        "True only if I rehydrated it" contract hold under races.
        """
        with self._lock:
            return self.dormant.pop(run_id, None)

    def _rehydrate(self, run_id: str, fire: bool) -> Run | None:
        """Page a dormant run back in and resume it.

        ``fire=True`` (the wake timer): a "wait"-mode run completes its Wait
        now.  ``fire=False`` (early access — get_run, wake_run, an external
        event): a "wait"-mode run becomes resident with its original
        deadline re-armed, preserving timing transparency.  "action"-mode
        runs always re-enter their state (idempotent via request_id dedup).
        """
        stub = self._pop_stub(run_id)
        if stub is None:
            return self.runs.get(run_id)
        return self._resume_stub(stub, fire)

    def _resume_stub(self, stub: DormantStub, fire: bool) -> Run:
        """Rebuild a Run from a claimed stub and schedule its continuation."""
        run_id = stub.run_id
        if stub.wake_handle is not None:
            self.scheduler.cancel(stub.wake_handle)
        try:
            context = self._load_passivated_context(stub)
        except AutomationError as e:
            context = None
            load_error: AutomationError | None = e
        else:
            load_error = None
        run = Run(
            run_id=stub.run_id,
            flow=stub.flow,
            flow_id=stub.flow_id,
            creator=stub.creator,
            caller=stub.caller,
            run_as=dict(stub.run_as),
            label=stub.label,
            tags=list(stub.tags),
            monitor_by=set(stub.monitor_by),
            manage_by=set(stub.manage_by),
            context=context,
            current_state=stub.state,
            attempt=stub.attempt,
            start_time=stub.start_time,
            context_journaled=True,
            engine=self,
            seq=stub.seq,
            tenant_id=stub.tenant_id,
        )
        run.events_dropped = stub.events_dropped
        with self._lock:
            self.runs[run_id] = run
            self.stats["runs_rehydrated"] += 1
        now = self.clock.now()
        run.log_event(now, "RunRehydrated", state=stub.state, mode=stub.mode)
        if load_error is not None:
            self._run_failed(run, load_error)
            return run
        state = stub.flow.states.get(stub.state)
        if state is None:
            self._run_failed(
                run, StateMachineError(f"unknown state {stub.state}")
            )
            return run
        if stub.mode == "wait":
            if fire or stub.wake_time is None or stub.wake_time <= now:
                self.scheduler.submit(lambda: self._finish_wait(run, state))
            else:
                # the stale _wake_dormant event (if not cancelled above)
                # no-ops on the missing stub; this is the live continuation
                self.scheduler.call_at(
                    stub.wake_time, lambda: self._finish_wait(run, state)
                )
        else:
            self.scheduler.submit(
                lambda: self._enter_state(run, stub.state, stub.attempt)
            )
        return run

    def dormant_stubs(self) -> "list[DormantStub]":
        with self._lock:
            return list(self.dormant.values())

    # -- Action states ----------------------------------------------------------
    def _exec_action(self, run: Run, state: asl.State) -> None:
        provider = self.registry.lookup(state.action_url)
        if getattr(provider, "scheduler", None) is None:
            # lazy-attach: lets time-based providers fire completion
            # callbacks through this engine's scheduler (callback mode)
            provider.scheduler = self.scheduler
        body = state.input_for(run.context)
        caller = self._caller_for(run, state.run_as)
        request_id = f"{run.run_id}:{state.name}:{run.attempt}"
        now = self.clock.now()
        deadline = now + state.wait_time if state.wait_time else None
        with self._lock:
            self.stats["actions_dispatched"] += 1
        # Journal *before* dispatch (write-ahead), then invoke.
        self.journal.append(
            {
                "type": "action_started",
                "run_id": run.run_id,
                "state": state.name,
                "provider_url": state.action_url,
                "request_id": request_id,
                "t": now,
            }
        )
        _tracing.begin(
            "flows.action", request_id, under=run.run_id,
            state=state.name, action_url=state.action_url,
        )
        try:
            with _tracing.inside(request_id):
                status = provider.run(
                    body,
                    caller=caller,
                    request_id=request_id,
                    monitor_by=sorted(run.monitor_by),
                    manage_by=sorted(run.manage_by),
                )
        except AutomationError as e:
            _tracing.end(request_id, status=ap.FAILED)
            self._state_failed(run, state, e.error_name, e.cause, _error_details(e))
            return
        run.log_event(
            self.clock.now(),
            "ActionStarted",
            state=state.name,
            action_id=status.action_id,
            provider=state.action_url,
        )
        with run.lock:
            run.action_id = status.action_id
            run.action_provider_url = state.action_url
            run.action_deadline = deadline
            generation = run.poll_generation
        if status.status != ap.ACTIVE:
            self._action_finished(run, state, status)
            return
        # asynchronous action: poll with exponential backoff (paper policy)
        interval = self.polling.initial_seconds
        if self.polling.use_callbacks:
            subscribed = provider.subscribe(
                status.action_id,
                lambda doc: self.scheduler.submit(
                    lambda: self._on_callback(run, state, generation, doc)
                ),
            )
            if subscribed:
                # guard poll at the cap (or the deadline) in case the
                # callback is lost; dramatically fewer polls than backoff.
                guard = min(
                    self.polling.cap_seconds,
                    (deadline - now) if deadline else self.polling.cap_seconds,
                )
                self.scheduler.call_later(
                    guard,
                    lambda: self._poll_action(
                        run, state, generation, self.polling.cap_seconds
                    ),
                )
                return
            # action completed before we subscribed: fall through to a poll
            self.scheduler.submit(
                lambda: self._poll_action(run, state, generation, interval)
            )
            return
        self.scheduler.call_later(
            interval,
            lambda: self._poll_action(run, state, generation, interval),
        )

    def _on_callback(self, run: Run, state: asl.State, generation: int, doc) -> None:
        with run.lock:
            if run.status != RUN_ACTIVE or run.poll_generation != generation:
                return
        if not self._live(run):
            return  # ghost callback: the run passivated and was replaced
        self._action_finished(run, state, doc)

    def _poll_action(
        self, run: Run, state: asl.State, generation: int, interval: float
    ) -> None:
        with run.lock:
            if run.status != RUN_ACTIVE or run.poll_generation != generation:
                return
            action_id = run.action_id
            deadline = run.action_deadline
        if action_id is None or not self._live(run):
            return
        if run.cancel_requested:
            self._check_cancel(run)
            return
        provider = self.registry.lookup(state.action_url)
        with self._lock:
            self.stats["polls"] += 1
        try:
            status = provider.status(action_id, self._caller_for(run, state.run_as))
        except AutomationError as e:
            self._state_failed(run, state, e.error_name, e.cause, _error_details(e))
            return
        now = self.clock.now()
        if status.status == ap.ACTIVE:
            if deadline is not None and now >= deadline:
                # WaitTime exceeded: advisory cancel, then treat as failure
                try:
                    provider.cancel(action_id, self._caller_for(run, state.run_as))
                except AutomationError:
                    pass
                self._state_failed(
                    run,
                    state,
                    ActionTimeout.error_name,
                    f"action exceeded WaitTime={state.wait_time}s",
                )
                return
            nxt = self.polling.next_interval(interval)
            if deadline is not None:
                nxt = min(nxt, max(0.0, deadline - now) + 1e-9)
            if self._passivation_eligible(run, nxt):
                # long-poll parking: page the run out until the next poll
                # (or until the provider's completion callback wakes it)
                self._passivate(
                    run,
                    state,
                    wake_time=now + nxt,
                    mode="action",
                    provider=provider,
                    action_id=action_id,
                )
                return
            self.scheduler.call_later(
                nxt, lambda: self._poll_action(run, state, generation, nxt)
            )
            return
        self._action_finished(run, state, status)

    def _action_finished(self, run: Run, state: asl.State, status) -> None:
        with run.lock:
            if run.status != RUN_ACTIVE:
                return
            # atomic claim: a completion callback and a guard poll can both
            # observe the terminal action state — only one may transition
            if run.action_id != status.action_id:
                return
            run.action_id = None
            run.action_provider_url = None
            run.action_deadline = None
        _tracing.end(
            f"{run.run_id}:{state.name}:{run.attempt}", status=status.status
        )
        now = self.clock.now()
        self.journal.append(
            {
                "type": "action_completed",
                "run_id": run.run_id,
                "state": state.name,
                "action_id": status.action_id,
                "status": status.status,
                "t": now,
            }
        )
        run.log_event(
            now,
            "ActionCompleted",
            state=state.name,
            action_id=status.action_id,
            status=status.status,
        )
        # release provider-side state (the engine is done with the action)
        try:
            provider = self.registry.lookup(state.action_url)
            provider.release(status.action_id, self._caller_for(run, state.run_as))
        except AutomationError:
            pass
        if status.status == ap.FAILED:
            if state.exception_on_action_failure or state.catch or state.retry:
                self._state_failed(
                    run,
                    state,
                    ActionFailedException.error_name,
                    _details_str(status.details),
                    details=status.details,
                )
                return
            # tolerate failure: record details and continue
        result = {
            "action_id": status.action_id,
            "status": status.status,
            "details": status.details,
        }
        with run.lock:
            self._apply_result(run, state.write_result, state.result_path, result)
        self._transition(run, state)

    # -- Parallel ------------------------------------------------------------------
    def _exec_parallel(self, run: Run, state: asl.State) -> None:
        branch_input = state.input_for(run.context)
        children: list[Run] = []
        for i, branch in enumerate(state.branches):
            child = Run(
                run_id=f"{run.run_id}.b{i}",
                flow=branch,
                flow_id=f"{run.flow_id}#∥{state.name}[{i}]",
                creator=run.creator,
                caller=run.caller,
                run_as=run.run_as,
                label=f"{run.label} / branch {i}",
                context=dict(branch_input),
                start_time=self.clock.now(),
                parent=run,
                branch_index=i,
                parent_state=state.name,
                engine=self,
                tenant_id=run.tenant_id,
            )
            children.append(child)
        with run.lock:
            run.children = children
            run.join_claimed = False
        with self._lock:
            for child in children:
                self.runs[child.run_id] = child
        for child in children:
            # branches co-locate with their parent; if the parent itself is
            # a Map child placed off its hash home, tell the pool's
            # residency index so facade lookups still resolve in O(1)
            self._note_residency(child.run_id)
        for child in children:
            self.scheduler.submit(
                lambda c=child: self._enter_state(c, c.flow.start_at)
            )

    def _parallel_child_done(self, child: Run) -> None:
        parent = child.parent
        assert parent is not None
        state = parent.flow.states[child.parent_state]
        with parent.lock:
            if parent.status != RUN_ACTIVE:
                return
            statuses = [c.status for c in parent.children]
            # claim the join atomically: two children completing on
            # concurrent workers must not both transition the parent
            if any(s == RUN_FAILED for s in statuses) or all(
                s == RUN_SUCCEEDED for s in statuses
            ):
                if parent.join_claimed:
                    return
                parent.join_claimed = True
        if any(s == RUN_FAILED for s in statuses):
            for c in parent.children:
                if c.status == RUN_ACTIVE:
                    self.cancel_run(c.run_id)
            failed = next(c for c in parent.children if c.status == RUN_FAILED)
            self._state_failed(
                parent,
                state,
                BranchFailed.error_name,
                f"branch {failed.branch_index} failed: {failed.error}",
                details=failed.error,
            )
            return
        if all(s == RUN_SUCCEEDED for s in statuses):
            results = [c.context for c in parent.children]
            with parent.lock:
                self._apply_result(
                    parent, state.write_result, state.result_path, results
                )
            self._transition(parent, state)

    # -- Map -----------------------------------------------------------------------
    def _exec_map(self, run: Run, state: asl.State) -> None:
        """Dynamic data-parallel fan-out with a sliding admission window.

        ``ItemsPath`` selects the item list from the state's effective
        input; each item becomes a child run of the ``Iterator`` sub-flow,
        but at most ``MaxConcurrency`` children exist at once — completed
        children are dropped and the next item admitted, so a 10k-item Map
        holds O(window) live runs, not O(items) (ARCHITECTURE invariant 8).
        Under an :class:`~repro.core.shard_pool.EngineShardPool` the
        children are *distributed across the pool* (deterministic per-item
        hash home, least-loaded override for skewed costs) while the join
        stays here on the owner (ARCHITECTURE invariant 10).
        Re-entering the state (Retry clause, crash recovery) rebuilds the
        join from scratch: child run ids are deterministic
        (``<parent>.m<i>``), so re-dispatched actions deduplicate on their
        journaled ``request_id`` exactly like Parallel branches, and items
        whose terminal records survive in any shard's segment re-attach
        their results without re-running.
        """
        doc = state.input_for(run.context)
        items = state.items_for(doc)
        if not isinstance(items, list):
            raise StateMachineError(
                f"Map {state.name}: ItemsPath "
                f"{state.items_path or '$'!r} must select a list, "
                f"got {type(items).__name__}"
            )
        window = state.max_concurrency or len(items)
        join = MapJoin(
            items=items, results=[None] * len(items), window=window,
            scope_doc=doc,
        )
        run.log_event(
            self.clock.now(), "MapStarted", state=state.name,
            items=len(items), max_concurrency=state.max_concurrency,
        )
        if not items:
            with run.lock:
                run.map_join = None
                self._apply_result(run, state.write_result, state.result_path, [])
            self._transition(run, state)
            return
        with run.lock:
            run.map_join = join
            run.children = []
            run.join_claimed = False
        self._map_admit(run, state)

    def _place_map_child(self, child_id: str, join: MapJoin) -> tuple["FlowEngine", bool]:
        """(host engine, stolen?) for a Map child about to be admitted.

        A bare engine hosts everything itself; a pooled shard delegates to
        :meth:`~repro.core.shard_pool.EngineShardPool.place_map_child`
        (deterministic hash home, least-loaded override within the join's
        steal budget).  Called under the parent's ``run.lock`` — the pool
        only reads dirty load gauges, no engine locks.
        """
        if self.pool is None:
            return self, False
        return self.pool.place_map_child(child_id, join)

    def _note_residency(self, run_id: str) -> None:
        if self.pool is not None:
            self.pool.note_residency(run_id, self.shard_id)

    def _forget_residency(self, run_id: str) -> None:
        if self.pool is not None:
            self.pool.forget_residency(run_id, self.shard_id)

    def _adopt_recovered_result(self, child_id: str):
        """One-shot claim of a journal-replayed terminal child result.

        Pops so a Retry attempt that rebuilds the join with the same child
        ids re-runs the items instead of replaying a superseded result.
        """
        table = self.recovered_map_results
        if not table:
            return None
        return table.pop(child_id, None)

    def _map_admit(self, run: Run, state: asl.State) -> None:
        """Admit items while the window has room (callers do NOT hold locks).

        Each admitted item becomes a child Run *hosted on the shard the
        placement policy picks* — the child registers in that engine's run
        table, journals to that shard's segment, and executes on that
        shard's scheduler; only the join bookkeeping stays here on the
        owner.  Items whose children already finished before a crash (their
        terminal records replayed from some shard's segment into
        ``recovered_map_results``) are re-attached directly to the join
        without consuming a window slot or re-executing.
        """
        admitted: list[Run] = []
        finish = None   # claimed terminal decision, applied outside the lock
        fail_fast: list[tuple[str, "FlowEngine"]] = []
        with run.lock:
            join = run.map_join
            if join is None or run.status != RUN_ACTIVE:
                return
            while (
                join.live < join.window
                and join.next_index < len(join.items)
                and not join.failing
                and not run.cancel_requested
            ):
                i = join.next_index
                join.next_index += 1
                child_id = f"{run.run_id}.m{i}"
                adopted = self._adopt_recovered_result(child_id)
                if adopted is not None:
                    # crash recovery: this item finished before the crash on
                    # whichever shard hosted it — fill its slot from the
                    # replayed image instead of re-running it
                    status, ctx, err = adopted
                    join.done += 1
                    if status == RUN_SUCCEEDED:
                        join.results[i] = copy.deepcopy(ctx)
                    else:
                        join.failed += 1
                        join.results[i] = {
                            "MapItemFailed": copy.deepcopy(err) or {
                                "Error": MapItemFailed.error_name,
                                "Cause": f"item {i} failed before recovery",
                            }
                        }
                        if (
                            join.failed > state.tolerated_failures
                            and not join.failing
                        ):
                            join.failing = True
                            fail_fast = [
                                (c.run_id, c.engine or self)
                                for c in run.children
                            ]
                    run.log_event(
                        self.clock.now(), "MapItemCompleted",
                        state=state.name, index=i, status=status,
                        completed=join.done, total=len(join.items),
                        recovered=True,
                    )
                    continue
                join.live += 1
                join.peak_live = max(join.peak_live, join.live)
                run.map_peak_live = max(run.map_peak_live, join.live)
                host, stolen = self._place_map_child(child_id, join)
                if stolen:
                    join.stolen_live += 1
                child = Run(
                    run_id=child_id,
                    flow=state.iterator,
                    flow_id=f"{run.flow_id}#map:{state.name}[{i}]",
                    creator=run.creator,
                    caller=run.caller,
                    run_as=run.run_as,
                    label=f"{run.label} / item {i}",
                    context=state.item_input(join.scope_doc, join.items[i], i),
                    start_time=self.clock.now(),
                    parent=run,
                    branch_index=i,
                    parent_state=state.name,
                    of_join=join,
                    engine=host,
                    foreign_placed=stolen,
                    tenant_id=run.tenant_id,
                )
                run.children.append(child)
                admitted.append(child)
            # adoption can drain the join without any child ever going
            # live (every item finished pre-crash) — claim the finish here,
            # since no completion callback will ever fire to claim it
            drained = join.live == 0 and (
                join.failing or join.next_index >= len(join.items)
            )
            if drained and not run.join_claimed and not run.cancel_requested:
                run.join_claimed = True
                finish = "fail" if join.failing else "ok"
        stolen_total = 0
        for child in admitted:
            host = child.engine
            with host._lock:
                host.runs[child.run_id] = child
                host.stats["map_items_admitted"] += 1
                host.map_hosted += 1
            host._note_residency(child.run_id)
            if child.foreign_placed:
                stolen_total += 1
            host.scheduler.submit(
                lambda c=child, h=host: h._enter_state(c, c.flow.start_at)
            )
        if stolen_total:
            with self._lock:
                self.stats["map_children_stolen"] += stolen_total
        for run_id, host in fail_fast:
            try:
                host.cancel_run(run_id)
            except AutomationError:
                pass
        if finish is not None:
            self._map_finish(run, state, join, finish)

    def _drop_map_child(self, child: Run) -> None:
        """Drop a terminal Map child from its HOST engine's run table.

        Runs on the host (which may not be the join owner) *before* the
        completion is routed to the owner — so each engine only ever takes
        its own ``_lock``, and live state stays bounded by the window
        regardless of item count.
        """
        with self._lock:
            # identity-checked: a Retry attempt re-registers the same child
            # ids, and a stale completion must not evict the live successor
            resident = self.runs.get(child.run_id) is child
            if resident:
                del self.runs[child.run_id]
            self.stats["map_items_completed"] += 1
            self.map_hosted = max(0, self.map_hosted - 1)
        if resident:
            self._forget_residency(child.run_id)

    def _map_child_done(self, child: Run) -> None:
        """One Map item reached a terminal state: record, refill, maybe join.

        Always executes on the join OWNER's scheduler (the parent's home
        engine) — :meth:`_fanout_child_done` routes cross-shard completions
        here after the host has already dropped the child, so the join is
        single-writer and no two shard locks are ever held together.  The
        child's slot result is its final context (success) or its error
        document (tolerated failure).
        """
        parent = child.parent
        assert parent is not None
        state = parent.flow.states[child.parent_state]
        finish = None   # claimed terminal decision, applied outside the lock
        fail_fast: list[tuple[str, "FlowEngine"]] = []
        with parent.lock:
            join = parent.map_join
            if join is None or child.of_join is not join:
                return  # stale child from a superseded attempt
            if child.foreign_placed:
                join.stolen_live = max(0, join.stolen_live - 1)
            if parent.status != RUN_ACTIVE:
                return
            if child in parent.children:
                parent.children.remove(child)
            else:
                # already accounted: a completion can be delivered twice
                # when failover re-synthesizes routing events that raced
                # the shard death — the removal above is the idempotence
                # gate, so a duplicate must not double-decrement the join
                return
            join.live -= 1
            join.done += 1
            # a child cancelled while the join is healthy (someone cancelled
            # the item directly) counts as a failed item — its partial
            # context must not masquerade as a successful result; cancelled
            # siblings of an already-failing join are the fail-fast sweep
            # and their (discarded) slots need no marker
            failed_like = child.status == RUN_FAILED or (
                child.status == RUN_CANCELLED and not join.failing
            )
            if failed_like:
                join.failed += 1
                join.results[child.branch_index] = {
                    "MapItemFailed": child.error or {
                        "Error": "States.MapItemCancelled",
                        "Cause": f"item {child.branch_index} was cancelled",
                    }
                }
                if join.failed > state.tolerated_failures and not join.failing:
                    # fail fast: stop admitting and cancel in-flight items
                    # on whichever shard hosts them
                    join.failing = True
                    fail_fast = [
                        (c.run_id, c.engine or self) for c in parent.children
                    ]
            else:
                # a successful child contributes its final context
                join.results[child.branch_index] = child.context
            parent.log_event(
                self.clock.now(), "MapItemCompleted",
                state=state.name, index=child.branch_index,
                status=child.status, completed=join.done,
                total=len(join.items),
            )
            drained = join.live == 0 and (
                join.failing or join.next_index >= len(join.items)
            )
            if drained and not parent.join_claimed:
                # claim the join atomically: concurrently completing items
                # must not both transition the parent (cf. Parallel)
                parent.join_claimed = True
                finish = "fail" if join.failing else "ok"
        for run_id, host in fail_fast:
            try:
                host.cancel_run(run_id)
            except AutomationError:
                pass
        if finish is None:
            self._map_admit(parent, state)
            return
        self._map_finish(parent, state, join, finish)

    def _map_finish(
        self, parent: Run, state: asl.State, join: MapJoin, finish: str
    ) -> None:
        """Apply a claimed join outcome (owner engine, no shard locks held)."""
        with parent.lock:
            parent.map_join = None
            parent.children = []
        if finish == "fail":
            first = next(
                (r for r in join.results
                 if isinstance(r, dict) and "MapItemFailed" in r),
                None,
            )
            self._state_failed(
                parent,
                state,
                MapItemFailed.error_name,
                f"{join.failed}/{len(join.items)} Map items failed "
                f"(tolerated {state.tolerated_failures})",
                details=(first or {}).get("MapItemFailed"),
            )
            return
        with parent.lock:
            self._apply_result(
                parent, state.write_result, state.result_path, join.results
            )
        self._transition(parent, state)

    # -- failure handling -------------------------------------------------------
    def _state_failed(
        self,
        run: Run,
        state: asl.State,
        error_name: str,
        cause: str,
        details: Any = None,
    ) -> None:
        now = self.clock.now()
        run.log_event(
            now, "StateFailed", state=state.name, error=error_name, cause=cause
        )
        # Retry clauses (ASL semantics)
        for rule in state.retry:
            if error_matches(error_name, rule.error_equals):
                if run.attempt < rule.max_attempts:
                    delay = rule.interval_seconds * (
                        rule.backoff_rate ** run.attempt
                    )
                    if rule.max_delay_seconds is not None:
                        # cap the exponential curve: a long outage must not
                        # push retries out to astronomic delays
                        delay = min(delay, rule.max_delay_seconds)
                    if rule.jitter_strategy == "FULL":
                        # full decorrelated jitter (uniform over [0, delay)):
                        # a mass provider outage fails thousands of runs at
                        # the same instant, and without jitter their retries
                        # re-converge as a synchronized storm.  The draw is
                        # a pure hash of (run, state, attempt) so virtual-
                        # clock schedules stay deterministic and replayable.
                        delay *= hash_uniform(
                            0, "retry", run.run_id, state.name, run.attempt
                        )
                    with self._lock:
                        self.stats["retries"] += 1
                    attempt = run.attempt + 1
                    run.log_event(
                        now, "StateRetried", state=state.name, attempt=attempt
                    )
                    self.scheduler.call_later(
                        delay, lambda: self._enter_state(run, state.name, attempt)
                    )
                    return
                break
        # Catch clauses
        for rule in state.catch:
            if error_matches(error_name, rule.error_equals):
                error_doc = {"Error": error_name, "Cause": cause}
                if details is not None:
                    error_doc["Details"] = details
                with run.lock:
                    self._apply_result(
                        run, rule.write_result, rule.result_path, error_doc
                    )
                self._goto(run, rule.next)
                return
        with run.lock:
            run.error = {"Error": error_name, "Cause": cause, "State": state.name}
            if details is not None:
                run.error["Details"] = details
        self._complete_run(run, RUN_FAILED)

    def _run_failed(self, run: Run, exc: AutomationError) -> None:
        with run.lock:
            run.error = exc.as_result()
        self._complete_run(run, RUN_FAILED)

    # -- transitions -----------------------------------------------------------
    def _transition(self, run: Run, state: asl.State) -> None:
        now = self.clock.now()
        self._journal_transition(
            run,
            {
                "type": "state_exited",
                "run_id": run.run_id,
                "state": state.name,
                "next": state.next,
                "t": now,
            },
        )
        run.log_event(now, "StateExited", state=state.name, next=state.next)
        if state.end or state.next is None:
            self._complete_run(run, RUN_SUCCEEDED)
        else:
            self._goto(run, state.next)

    def _goto(self, run: Run, state_name: str) -> None:
        self.scheduler.submit(lambda: self._enter_state(run, state_name))

    def _complete_run(self, run: Run, status: str) -> None:
        with run.lock:
            if run.status != RUN_ACTIVE:
                return
            run.status = status
            run.completion_time = self.clock.now()
            run.current_state = None
        self._journal_transition(
            run,
            {
                "type": "run_completed" if status != RUN_CANCELLED else "run_cancelled",
                "run_id": run.run_id,
                "status": status,
                "error": run.error,
                "t": run.completion_time,
            },
        )
        run.log_event(run.completion_time, "FlowCompleted", status=status)
        with self._lock:
            key = {
                RUN_SUCCEEDED: "runs_succeeded",
                RUN_FAILED: "runs_failed",
                RUN_CANCELLED: "runs_cancelled",
            }.get(status)
            if key:
                self.stats[key] += 1
        _tracing.end(run.run_id, status=status)
        run.done.set()
        # a parent leaving ACTIVE mid-Map abandons its fan-out: cancel the
        # in-flight children — on whichever shard hosts them — so they
        # don't run on (advisory, like Parallel)
        with run.lock:
            abandoned = (
                [(c.run_id, c.engine or self) for c in run.children]
                if run.map_join is not None and status != RUN_SUCCEEDED
                else []
            )
        for child_id, host in abandoned:
            try:
                host.cancel_run(child_id)
            except AutomationError:
                pass
        for cb in list(run.completion_callbacks):
            try:
                cb(run)
            except Exception:
                pass
        if run.parent is not None:
            self.scheduler.submit(lambda: self._fanout_child_done(run))

    def _fanout_child_done(self, child: Run) -> None:
        """Route a completed fan-out child to its join (Parallel vs Map).

        Runs on the child's HOST engine.  A Map child is first dropped from
        this host's run table (host lock only), then the join bookkeeping is
        handed to the parent's owner engine — its own scheduler event on its
        own shard — so the two shards' locks are taken strictly in
        sequence, never nested (ARCHITECTURE invariant 10).
        """
        parent = child.parent
        state = parent.flow.states.get(child.parent_state) if parent else None
        if state is not None and state.kind == "Map":
            self._drop_map_child(child)
            owner = parent.engine or self
            if owner is not self:
                owner.scheduler.submit(lambda: owner._map_child_done(child))
                return
            self._map_child_done(child)
        else:
            self._parallel_child_done(child)

    # -- auth ---------------------------------------------------------------------
    def _caller_for(self, run: Run, run_as: str | None) -> AuthContext | None:
        """Map a state's RunAs role to the identity whose tokens to use.

        Default: the run creator (paper §4.2.1 — "By default, actions are run
        as the run creator"); a ``RunAs`` role selects the alternate identity
        captured when the run started.
        """
        if run_as:
            caller = run.run_as.get(run_as)
            if caller is not None:
                return caller
        return run.caller

    # -- durability maintenance -------------------------------------------------
    def compact(self) -> dict:
        """Checkpoint-compact this shard's journal segment.

        Snapshots the engine's service counters into the checkpoint record
        alongside the live run/trigger images the journal replays for
        itself; see :meth:`repro.core.journal.Journal.compact`.
        """
        with self._lock:
            counters = dict(self.stats)
        return self.journal.compact(counters=counters)

    # -- recovery ---------------------------------------------------------------
    def recover(
        self,
        flows_by_id: dict[str, asl.Flow],
        resume: bool = True,
    ) -> list[Run]:
        """Rebuild unfinished runs from the journal and resume them.

        ``flows_by_id`` maps flow ids to parsed definitions (the Flows
        service persists definitions separately from run state, as in the
        paper where ASF holds the deployed state machine).

        Replay is checkpoint-aware: a compacted segment yields one
        checkpoint image set plus the post-checkpoint tail instead of the
        full history, and the checkpoint's service-counter snapshot is
        folded back into ``stats`` (advisory — tail activity between the
        checkpoint and the crash is not re-counted).
        """
        view = replay_segment(self.journal)  # one pass: images + counters
        if view.counters:
            with self._lock:
                for key, value in view.counters.items():
                    if isinstance(value, (int, float)):
                        self.stats[key] = max(self.stats.get(key, 0), value)
        # Terminal Map children replay from THIS shard's segment (each child
        # journals where it ran, which after cross-shard placement need not
        # be its parent's shard).  Their results are staged before any
        # parent is resumed; a recovered parent's _map_admit re-attaches
        # them to its join instead of re-running the items.  A pool merges
        # every shard's table into one shared dict afterwards — see
        # EngineShardPool.recover.
        self.recovered_map_results.update(terminal_map_children(view))
        resumed: list[Run] = []
        for image in view.runs.values():
            if (
                image.status != RUN_ACTIVE
                or image.run_id in self.runs
                or image.run_id in self.dormant
            ):
                continue
            flow = flows_by_id.get(image.flow_id)
            if flow is None:
                continue
            if image.passivated and resume and self.passivate_after is not None:
                # the run was paged out when the crash hit: re-park it as a
                # stub (with a fresh page-out record so rehydration has a
                # fast path into this segment) instead of residency
                self._adopt_dormant(image, flow)
                continue
            run = Run(
                run_id=image.run_id,
                flow=flow,
                flow_id=image.flow_id,
                creator=image.creator,
                caller=None,
                # deep copy: the image's context may alias a journal record
                # (in-memory journals hand out the same dicts on every
                # replay), and the resumed run patches its context in place
                label=image.label,
                context=copy.deepcopy(image.context),
                start_time=self.clock.now(),
                # the replayed history already established a context
                # baseline for this run; new records may patch against it
                context_journaled=True,
                engine=self,
                seq=image.seq,
                tenant_id=getattr(image, "tenant", None),
            )
            with self._lock:
                self.runs[run.run_id] = run
            resumed.append(run)
            if not resume:
                continue
            if (
                image.passivated
                and image.passivate_mode == "wait"
                and image.current_state in flow.states
            ):
                # passivation-disabled restart of a parked Wait: honor the
                # original deadline instead of restarting the whole wait
                state = flow.states[image.current_state]
                run.current_state = image.current_state
                run.attempt = image.attempt
                wake = max(image.wake_time or 0.0, self.clock.now())
                self.scheduler.call_at(
                    wake, lambda r=run, s=state: self._finish_wait(r, s)
                )
                continue
            state_name = image.current_state or flow.start_at
            attempt = image.attempt
            # Re-enter the interrupted state.  The journaled request_id makes
            # re-dispatch idempotent for providers that survived the crash.
            self.scheduler.submit(
                lambda r=run, s=state_name, a=attempt: self._enter_state(r, s, a)
            )
        return resumed

    def _adopt_dormant(self, image: RunImage, flow: asl.Flow) -> None:
        """Re-park a recovered passivated image as a dormant stub.

        Appends a fresh ``run_passivated`` record (dirty-page writeback into
        the current segment) so the stub's journal_ref addresses a live
        offset — without it every wake after recovery would pay a full
        segment replay.
        """
        now = self.clock.now()
        wake_time = image.wake_time if image.wake_time is not None else now
        mode = image.passivate_mode or "wait"
        state_name = image.current_state or flow.start_at
        offset = self.journal.append(
            {
                "type": "run_passivated",
                "run_id": image.run_id,
                "state": state_name,
                "attempt": image.attempt,
                "mode": mode,
                "wake_time": wake_time,
                "context": image.context,
                "t": now,
            }
        )
        stub = DormantStub(
            run_id=image.run_id,
            flow=flow,
            flow_id=image.flow_id or "flow",
            creator=image.creator,
            caller=None,  # like any recovery, the token wallet did not survive
            run_as=_NO_RUN_AS,
            label=image.label,
            state=state_name,
            attempt=image.attempt,
            mode=mode,
            wake_time=wake_time,
            start_time=now,
            seq=image.seq,
            tenant_id=image.tenant,
            tags=(),
            monitor_by=_NO_ACL,
            manage_by=_NO_ACL,
            events_dropped=0,
            journal_ref=(
                (self.journal.generation, offset) if offset is not None else None
            ),
        )
        with self._lock:
            self.dormant[image.run_id] = stub
            self.stats["runs_reparked"] += 1
        stub.wake_handle = self.scheduler.call_at(
            max(wake_time, now), self._wake_dormant_cb, arg=image.run_id
        )


def _details_str(details: Any) -> str:
    if isinstance(details, dict):
        for key in ("error", "cause", "message"):
            if key in details:
                return str(details[key])
    return str(details)
