"""EngineShardPool: horizontally sharded flow execution (paper §5.3 at scale).

The paper's Flows service scales by fanning run execution out across Step
Functions + SQS + Lambda workers while presenting one logical service.  This
module reproduces that shape in-process: a pool of N independent
:class:`~repro.core.engine.FlowEngine` shards — each with its own scheduler
heap, lock, worker threads, and write-ahead journal *segment* — behind a
facade that is call-compatible with a single engine.

Partitioning contract
---------------------
* Runs are **hash-partitioned by placement key**: ``shard_index(run_id, n)``
  maps a run to its home shard with a stable (process-independent) CRC32
  hash of :func:`placement_key`, so routing is stateless and a restarted
  pool recovers the same placement from its journal segments.
* ``Parallel`` branch children (``<parent>.bN``) are *dropped* from the
  placement key, so branches **co-locate with their parent** — the branch
  join never crosses a shard boundary.
* ``Map`` item children (``<parent>.mN``) are *kept* in the placement key,
  so a Map fan-out **spreads deterministically across the whole pool**
  (seeded by the parent run id + item index) instead of saturating the
  parent's shard.  The admission window and join bookkeeping stay on the
  parent's shard — the *owner* — and child completions are routed back to
  it as ordinary scheduler events, so no two shards' locks are ever held
  together (ARCHITECTURE invariant 10).  A least-loaded override (bounded
  per-join work stealing, ``map_steal_bound``) smooths skewed item costs;
  off-home placements are tracked in a small foreign-residency index so
  facade lookups stay O(1).
* Remaining cross-shard traffic lives at the facade: ``list_runs``
  aggregates all shards, and flow-as-action composition may place a child
  flow's run on a different shard than its parent (each side only touches
  its own shard's state; the parent observes the child through the provider
  API, exactly as the paper's flows observe remote actions).

Determinism contract
--------------------
Under a :class:`~repro.core.clock.VirtualClock` all shards share one clock,
and :meth:`PoolScheduler.drain` executes events in **global time order** by
merging the per-shard heaps (ties broken by shard index, then per-shard
submission order).  A flow run therefore produces the same transitions,
context, and terminal state regardless of the shard count.

Durability contract
-------------------
Each shard journals to its own segment (``<base>.shard<i>-of<n>.jsonl``)
*before* acting — the per-shard write-ahead rule is identical to the single
engine's.  Within a shard, concurrent appends group-commit (one
flush+fsync per batch; ``group_commit=False`` restores the serialized
baseline), and :meth:`EngineShardPool.compact` (or ``compact_every=N``)
checkpoint-compacts each segment independently so per-shard recovery is
O(live state), not O(history) — see docs/durability.md.
Recovery is per-shard: each shard replays only its own segment, so
a pool restarted with the same ``num_shards`` recovers every unfinished run
on its original home shard, and a Map child's terminal record replays from
the segment of the shard that *hosted* it — :meth:`EngineShardPool.recover`
merges every shard's replayed child results so a recovered parent re-attaches
them to its join regardless of where each item ran.  Restarting with a
*different* count opens fresh segments and recovers nothing (the count is
embedded in the segment file names) — restart with the original count to
recover.  For callers wiring explicit ``journals=`` whose contents don't
match the hash placement, recovery registers the off-home runs in the
foreign-residency index, so reads resolve without scanning the pool.
"""

from __future__ import annotations

import secrets
import threading
import zlib
from typing import Callable

from . import actions as ap
from . import asl
from .admission import FairAdmission
from .auth import Tenant
from .clock import Clock, MonotonicId, RealClock
from .engine import RUN_ACTIVE, FlowEngine, PollingPolicy, Run, Scheduler
from .errors import NotFound
from .journal import (
    Journal,
    JournalCrashed,
    JournalFenced,
    SimulatedCrash,
    segment_path,
)


def placement_key(run_id: str) -> str:
    """The id substring a run is hash-placed by.

    ``Parallel`` branch segments (``.bN``) are dropped — branches co-locate
    with their parent, so their join never crosses shards.  ``Map`` item
    segments (``.mN``) are kept — each item child hashes with its full Map
    path, which is exactly "parent run id + item index", giving every Map
    fan-out a deterministic spread over the pool that recovery and request
    routing can recompute from the id alone.
    """
    if "." not in run_id:
        return run_id
    parts = run_id.split(".")
    kept = [parts[0]]
    for part in parts[1:]:
        if part[:1] == "m" and part[1:].isdigit():
            kept.append(part)
    return ".".join(kept)


def shard_index(run_id: str, num_shards: int) -> int:
    """Stable hash partition of a run id onto ``num_shards`` shards.

    Hashes :func:`placement_key`, so Parallel branches land on their
    parent's shard while Map item children get their own deterministic
    home — process-independent (CRC32), hence recomputable after a crash.
    """
    return zlib.crc32(placement_key(run_id).encode("utf-8")) % num_shards


def survivor_index(key: str, num_slots: int, dead: set[int]) -> int:
    """Stable re-hash of ``key`` over the live slots of ``range(num_slots)``.

    The shared failover formula: the inline pool re-homes a dead shard's
    runs with it (``key`` = :func:`placement_key`), and the process backend
    picks a dead worker's successor with it (``key`` = the worker's shard
    label) — both sides compute the same answer from the id and the dead
    set alone, with no coordination state.
    """
    survivors = [i for i in range(num_slots) if i not in dead]
    if not survivors:
        raise NotFound(f"no live slot for {key!r}: every slot is dead")
    return survivors[zlib.crc32(key.encode("utf-8")) % len(survivors)]


class PoolScheduler:
    """Facade over the per-shard schedulers.

    Presents the same surface as :class:`~repro.core.engine.Scheduler` so
    existing callers (``flows.engine.scheduler.drain(...)``, trigger/timer
    services, providers firing completion callbacks) work unchanged against a
    pool.  Events submitted *through the facade* land on shard 0's heap;
    events the shards schedule for themselves stay on their own heaps.
    ``drain`` merges all heaps into one global time order.
    """

    def __init__(self, schedulers: list[Scheduler], clock: Clock):
        self.clock = clock
        self._schedulers = schedulers
        #: scheduler indices excluded from drain and facade routing: hung
        #: shards (ShardSupervisor.hang_shard) and fenced-dead shards
        #: (EngineShardPool.mark_dead).  Their queued events never execute.
        self._skip: set[int] = set()
        #: (scheduler_index, exc) -> bool; installed by attach_supervisor.
        #: Receives crash-channel exceptions raised out of drained events;
        #: True = handled (failover ran), False = re-raise.
        self._crash_handler: Callable[[int, BaseException], bool] | None = None

    def append_scheduler(self, sched: Scheduler) -> None:
        """Add an auxiliary scheduler (the supervisor's) to the drain merge."""
        self._schedulers.append(sched)

    def pause_shard(self, index: int) -> None:
        """Stop draining/routing to one scheduler (hang or death)."""
        self._skip.add(index)

    def _first_live(self) -> Scheduler:
        for i, sched in enumerate(self._schedulers):
            if i not in self._skip:
                return sched
        return self._schedulers[0]

    # -- Scheduler-compatible submission (auxiliary events -> first live shard)
    def call_at(self, t: float, fn: Callable[[], None]) -> None:
        self._first_live().call_at(t, fn)

    def call_later(self, delay: float, fn: Callable[[], None]) -> None:
        self._first_live().call_later(delay, fn)

    def submit(self, fn: Callable[[], None]) -> None:
        self._first_live().submit(fn)

    def pending(self) -> int:
        return sum(s.pending() for s in self._schedulers)

    def stop(self) -> None:
        for s in self._schedulers:
            s.stop()

    # -- virtual-time drive ---------------------------------------------------
    def drain(
        self,
        until: float | None = None,
        max_events: int = 10_000_000,
        stop: Callable[[], bool] | None = None,
    ) -> int:
        """Execute events across ALL shards in global time order.

        The deterministic analogue of N shards running concurrently: at each
        step the globally earliest due event runs (ties broken by shard
        index), the shared VirtualClock advances to its due time, and the
        loop repeats until quiescence, ``until``, ``max_events``, or ``stop``.
        """
        n = 0
        while n < max_events:
            if stop is not None and stop():
                return n
            best_t: float | None = None
            best_sched: Scheduler | None = None
            best_i = -1
            for i, sched in enumerate(self._schedulers):
                if i in self._skip:
                    continue
                t = sched.peek_time()
                if t is None:
                    continue
                if best_t is None or t < best_t:
                    best_t, best_sched, best_i = t, sched, i
            if best_sched is None or (until is not None and best_t > until):
                return n
            popped = best_sched.pop_next(best_t)
            if popped is None:  # raced by a live worker thread; re-scan
                continue
            t, fn = popped
            self.clock.advance_to(t)
            try:
                fn()
            except (SimulatedCrash, JournalCrashed, JournalFenced) as exc:
                # the virtual-mode crash channel: what a worker thread would
                # report in real mode surfaces here.  The supervisor (when
                # attached) turns it into a failover; otherwise it escapes
                # to the caller exactly as before.
                handler = self._crash_handler
                if handler is None or not handler(best_i, exc):
                    raise
            n += 1
        return n


class EngineShardPool:
    """N independent FlowEngine shards behind a single-engine-compatible API.

    ``FlowsService`` routes every run-scoped call (``start_run`` /
    ``get_run`` / ``cancel_run`` / ``wait`` / ``run_to_completion``) to the
    owning shard and aggregates the cross-shard views (``runs``, ``stats``,
    ``recover``).  With ``num_shards=1`` the pool is a thin wrapper with
    identical semantics to a bare engine.
    """

    def __init__(
        self,
        registry: ap.ActionRegistry,
        num_shards: int = 1,
        clock: Clock | None = None,
        journal: Journal | None = None,
        journal_path: str | None = None,
        journals: list[Journal] | None = None,
        fsync: bool = False,
        journal_latency_s: float = 0.0,
        group_commit: bool = True,
        compact_every: int | None = None,
        polling: PollingPolicy | None = None,
        max_workers: int = 8,
        start_threads: bool | None = None,
        delta_journal: bool = True,
        snapshot_every: int = 64,
        passivate_after: float | None = None,
        map_steal_bound: int | None = None,
        admission_window: int | None = None,
    ):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if journal is not None and num_shards != 1:
            raise ValueError(
                "a single shared Journal only makes sense with num_shards=1; "
                "pass journal_path= (per-shard segments) or journals= instead"
            )
        if journals is not None and len(journals) != num_shards:
            raise ValueError(
                f"journals must have one entry per shard "
                f"({len(journals)} != {num_shards})"
            )
        self.registry = registry
        self.clock = clock or RealClock()
        self.num_shards = num_shards
        self.journal_path = journal_path
        self.engines: list[FlowEngine] = []
        for i in range(num_shards):
            if journals is not None:
                seg = journals[i]
            elif journal is not None:
                seg = journal
            elif journal_path is not None:
                seg = Journal(
                    segment_path(journal_path, i, num_shards),
                    fsync=fsync,
                    latency_s=journal_latency_s,
                    group_commit=group_commit,
                    compact_every=compact_every,
                )
            else:
                seg = Journal(
                    latency_s=journal_latency_s,
                    group_commit=group_commit,
                    compact_every=compact_every,
                )
            self.engines.append(
                FlowEngine(
                    registry,
                    clock=self.clock,
                    journal=seg,
                    polling=polling,
                    max_workers=max_workers,
                    start_threads=start_threads,
                    delta_journal=delta_journal,
                    snapshot_every=snapshot_every,
                    passivate_after=passivate_after,
                )
            )
        for i, engine in enumerate(self.engines):
            engine.pool = self
            engine.shard_id = i
        self.scheduler = PoolScheduler([e.scheduler for e in self.engines], self.clock)
        self._seq = MonotonicId()  # global submission order for list_runs
        #: weighted-fair admission for metered (tenant-stamped) submissions:
        #: per-tenant token buckets at the edge + deficit-round-robin release
        #: into the shards.  ``admission_window`` caps admitted-but-active
        #: metered runs pool-wide; unmetered submissions (no tenant) bypass
        #: the queue entirely, so the seed fast path is unchanged.
        self.admission = FairAdmission(
            self.clock, self.scheduler, window=admission_window
        )
        #: per-join cap on *concurrently* off-home Map children: the
        #: least-loaded policy stops deviating from the hash home once a
        #: join has this many stolen children in flight, which bounds the
        #: foreign-residency index and keeps placement mostly deterministic
        self.map_steal_bound = (
            map_steal_bound if map_steal_bound is not None else 2 * num_shards
        )
        #: run_id -> shard index, ONLY for runs resident off their hash
        #: home (stolen Map children, runs recovered from mismatched
        #: ``journals=``).  Kept small by the steal bound; lets ``_owner``
        #: resolve misses in O(1) instead of scanning every shard.
        self._foreign: dict[str, int] = {}
        self._foreign_lock = threading.Lock()
        #: shard indices fenced off by a ShardSupervisor failover.  Routing
        #: (``live_shard_index``) re-hashes anything homed on a dead shard
        #: onto the survivors; the supervisor re-homed the existing state
        #: with the same formula, so lookups need no forwarding table.
        self.dead: set[int] = set()
        #: the attached ShardSupervisor (None until attach_supervisor)
        self.supervisor = None

    # ------------------------------------------------------------- failover
    def live_shard_index(self, run_id: str) -> int:
        """``shard_index`` restricted to live shards.

        The raw hash home when it is alive; otherwise a stable re-hash over
        the survivor set — the same formula the supervisor re-homes by, so
        a re-homed run's new location is computable from its id alone.
        """
        idx = shard_index(run_id, self.num_shards)
        if idx not in self.dead:
            return idx
        return survivor_index(placement_key(run_id), self.num_shards, self.dead)

    def mark_dead(self, shard_id: int) -> None:
        """Exclude a shard from routing and (virtual-mode) draining."""
        self.dead.add(shard_id)
        self.scheduler.pause_shard(shard_id)

    def attach_supervisor(self, supervisor) -> None:
        """Wire a ShardSupervisor into the pool (called by its start()).

        Adds the supervisor's scheduler to the drain merge, installs the
        crash channel, and unifies the per-engine recovered-Map-results
        tables into one shared dict — after a failover, a surviving parent
        must be able to adopt a terminal child replayed from the *victim's*
        segment, exactly as pool recovery already guarantees.
        """
        self.supervisor = supervisor
        self.scheduler.append_scheduler(supervisor.scheduler)
        self.scheduler._crash_handler = supervisor.on_worker_crash
        shared: dict[str, tuple] = {}
        for engine in self.engines:
            shared.update(engine.recovered_map_results)
            engine.recovered_map_results = shared

    # ------------------------------------------------------------- routing
    def shard_of(self, run_id: str) -> FlowEngine:
        """The live shard that owns (or would own) ``run_id``."""
        return self.engines[self.live_shard_index(run_id)]

    def journal_for(self, owner_id: str) -> Journal:
        """The journal segment owned by ``owner_id``'s home shard.

        Durable state that is not a run — trigger lifecycle and ack-progress
        records from the :class:`~repro.core.triggers.EventRouter` — is
        hash-owned by shards exactly like runs: records for ``owner_id`` land
        in ``shard_index(owner_id, N)``'s segment and are recovered with it.
        After a failover the ownership re-hashes to a live shard.
        """
        return self.engines[self.live_shard_index(owner_id)].journal

    @property
    def journals(self) -> list[Journal]:
        """Every shard's journal segment, in shard order."""
        return [engine.journal for engine in self.engines]

    def _owner(self, run_id: str) -> FlowEngine:
        """Resolve the engine actually holding ``run_id`` — in O(1).

        The hash home almost always matches; anything resident elsewhere
        (a stolen Map child, a run recovered from mismatched ``journals=``)
        was registered in the foreign-residency index when it was placed or
        recovered.  Unknown ids resolve to the home shard so NotFound is
        raised from the canonical place — without the full-pool scan this
        used to cost on every miss.
        """
        home = self.shard_of(run_id)
        if run_id in home.runs or run_id in home.dormant:
            return home
        idx = self._foreign.get(run_id)
        if idx is not None:
            return self.engines[idx]
        return home  # raise NotFound from the canonical place

    # ------------------------------------------------------- Map placement
    def place_map_child(self, child_id: str, join) -> tuple[FlowEngine, bool]:
        """(host engine, stolen?) for a Map child about to go live.

        Default is the child's deterministic hash home.  When the home is
        measurably busier than the least-loaded shard — skewed item costs
        pile long-running children onto one engine — the child is *stolen*
        to the least-loaded shard instead, up to ``map_steal_bound``
        concurrently-stolen children per join.  Load gauges are read dirty
        (no engine locks; the caller holds only the parent's run lock), so
        under a VirtualClock the decision is still deterministic.
        """
        home_idx = self.live_shard_index(child_id)
        live = [i for i in range(self.num_shards) if i not in self.dead]
        if len(live) == 1:
            return self.engines[live[0]], False
        best = min(live, key=lambda i: (self.engines[i].map_hosted, i))
        if (
            self.engines[home_idx].map_hosted
            <= self.engines[best].map_hosted
            or join.stolen_live >= self.map_steal_bound
        ):
            return self.engines[home_idx], False
        return self.engines[best], True

    def note_residency(self, run_id: str, shard_id: int) -> None:
        """Record that ``run_id`` is resident on ``shard_id``.

        A no-op for home placements; off-home runs go into the foreign
        index so ``_owner`` finds them without scanning.
        """
        if self.live_shard_index(run_id) != shard_id:
            with self._foreign_lock:
                self._foreign[run_id] = shard_id

    def forget_residency(self, run_id: str, shard_id: int) -> None:
        """Drop ``run_id``'s foreign-index entry if ``shard_id`` owns it.

        Guarded by owner: a stale child from a superseded Map attempt must
        not erase the entry its live successor registered from another
        shard.
        """
        with self._foreign_lock:
            if self._foreign.get(run_id) == shard_id:
                del self._foreign[run_id]

    # ------------------------------------------------------------- run API
    def start_run(self, flow: asl.Flow, flow_input: dict, **kwargs) -> Run:
        run_id = kwargs.pop("run_id", None) or "run-" + secrets.token_hex(8)
        # seq is handed to the shard so it is set at Run construction —
        # stamping it on the returned (already-live) run raced the run's
        # first transitions, which could observe/journal the default seq
        seq = self._seq.next()
        shard = self.shard_of(run_id)
        tenant: Tenant | None = kwargs.pop("tenant", None)
        if tenant is None:
            caller = kwargs.get("caller")
            tenant = getattr(caller, "tenant", None) if caller is not None else None
        if tenant is None:
            # unmetered fast path — identical to the seed submission
            return shard.start_run(
                flow, flow_input, run_id=run_id, seq=seq, **kwargs
            )
        kwargs.setdefault("tenant_id", tenant.tenant_id)
        if self.admission.admit_now(tenant):
            run = shard.start_run(
                flow, flow_input, run_id=run_id, seq=seq, **kwargs
            )
            self.admission.attach(tenant, run)
            return run
        # over quota or behind a backlog: create the run journaled-but-idle
        # and park it in the tenant's admission lane; the DRR pump releases
        # it into the shard in weighted order
        run = shard.start_run(
            flow, flow_input, run_id=run_id, seq=seq, defer_start=True,
            **kwargs,
        )
        # late-bound host: a failover may transplant the parked run to a
        # surviving shard before the DRR pump releases it — release where
        # it lives NOW, not where it was created
        self.admission.enqueue(
            tenant, run, lambda r=run, home=shard: (r.engine or home).release_run(r)
        )
        return run

    def get_run(self, run_id: str) -> Run:
        return self._owner(run_id).get_run(run_id)

    def peek_run(self, run_id: str):
        """Resident Run or dormant stub, without rehydration."""
        return self._owner(run_id).peek_run(run_id)

    def run_status(self, run_id: str) -> dict:
        """Status snapshot; dormant runs answer from their stub (no page-in)."""
        return self._owner(run_id).run_status(run_id)

    def wake_run(self, run_id: str) -> bool:
        """Rehydrate a dormant run now; False if resident or unknown."""
        return self._owner(run_id).wake_run(run_id)

    def cancel_run(self, run_id: str) -> Run:
        return self._owner(run_id).cancel_run(run_id)

    def wait(self, run_id: str, timeout: float | None = None) -> Run:
        return self._owner(run_id).wait(run_id, timeout)

    def run_to_completion(
        self,
        run_id: str,
        until: float | None = None,
        max_events: int = 10_000_000,
    ) -> Run:
        """Virtual-time mode: drain ALL shards until this run completes.

        The whole pool is drained (not just the owning shard) because a run
        may depend on another shard's progress — e.g. a flow-as-action child
        placed on a different shard.
        """
        run = self.get_run(run_id)
        self.scheduler.drain(
            until=until,
            max_events=max_events,
            stop=lambda: run.status != RUN_ACTIVE,
        )
        return run

    def drain(self, until: float | None = None) -> int:
        """Virtual-time drive: run all due events on all shards."""
        return self.scheduler.drain(until=until)

    def shutdown(self) -> None:
        if self.supervisor is not None:
            self.supervisor.stop()
        for engine in self.engines:
            engine.shutdown()

    # ---------------------------------------------------------- aggregation
    @property
    def runs(self) -> dict[str, Run]:
        """Merged snapshot of every shard's runs, in global submission order.

        Runs created internally by the shards (``Parallel`` children,
        recovered runs) carry ``seq == 0`` and sort by start time instead.
        """
        merged: list[Run] = []
        for engine in self.engines:
            with engine._lock:
                merged.extend(engine.runs.values())
        merged.sort(key=lambda r: (r.seq, r.start_time, r.run_id))
        return {r.run_id: r for r in merged}

    def dormant_stubs(self) -> list:
        """Every shard's dormant stubs, in global submission order."""
        stubs = []
        for engine in self.engines:
            stubs.extend(engine.dormant_stubs())
        stubs.sort(key=lambda s: (s.seq, s.start_time, s.run_id))
        return stubs

    @property
    def dormant(self) -> dict:
        """Merged view of every shard's dormant stubs (run_id -> stub)."""
        return {s.run_id: s for s in self.dormant_stubs()}

    @property
    def stats(self) -> dict[str, int]:
        """Counters summed across shards (per-shard via ``engines[i].stats``)."""
        totals: dict[str, int] = {}
        for engine in self.engines:
            with engine._lock:
                for key, value in engine.stats.items():
                    totals[key] = totals.get(key, 0) + value
        for key, value in self.admission.stats.items():
            totals[f"admission_{key}"] = value
        return totals

    # ------------------------------------------------------- durability maint
    def compact(self) -> list[dict]:
        """Checkpoint-compact every shard's journal segment (one summary per
        shard, in shard order).

        Each shard's segment is compacted independently — the checkpoint
        collapses that shard's own history into its live run images, its
        triggers' lifecycle + ack-progress, and a snapshot of the shard
        engine's counters — so per-shard recovery stays O(live state)
        regardless of how long the pool has been running.
        """
        return [engine.compact() for engine in self.engines]

    # ------------------------------------------------------------- recovery
    def recover(
        self,
        flows_by_id: dict[str, asl.Flow],
        resume: bool = True,
    ) -> list[Run]:
        """Per-shard crash recovery: each shard replays its own segment.

        Shards are independent — one shard's corrupt or missing segment does
        not block the others (the caller sees whatever recovered).  Two
        pool-level stitches happen on top of the per-shard replays:

        * every shard's replayed terminal Map-child results are merged into
          ONE table shared by all engines, so a recovered parent re-attaches
          items that ran (and finished) on *foreign* shards' segments — and
          the shared dict's one-shot pops stay global;
        * runs and dormant stubs that recovered onto a shard other than
          their hash home (explicit ``journals=`` wiring) are registered in
          the foreign-residency index so lookups resolve without scanning.
        """
        resumed: list[Run] = []
        merged_children: dict[str, tuple] = {}
        for engine in self.engines:
            shard_resumed = engine.recover(flows_by_id, resume=resume)
            resumed.extend(shard_resumed)
            merged_children.update(engine.recovered_map_results)
            for run in shard_resumed:
                self.note_residency(run.run_id, engine.shard_id)
            with engine._lock:
                dormant_ids = list(engine.dormant)
            for run_id in dormant_ids:
                self.note_residency(run_id, engine.shard_id)
        for engine in self.engines:
            engine.recovered_map_results = merged_children
        return resumed
