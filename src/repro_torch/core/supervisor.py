"""ShardSupervisor: live partial-failure tolerance for EngineShardPool.

The paper's first pillar is *reliable execution despite sporadic failures*.
Before this module the repro's only failure story was a whole-pool cold
restart: kill everything, reopen every segment, ``recover()``.  A hosted
control plane cannot do that — the death or hang of **one** shard must be
detected, contained, and repaired while the surviving shards keep serving
every other tenant's runs.  The supervisor makes that a first-class,
benchmarked operation (benchmarks/fig_mttr.py):

**Detection** — every shard schedules a heartbeat *beacon* on its own
scheduler; the beacon executing proves the shard's dispatcher and worker
pool are alive (real mode) or its event queue is being drained (virtual
mode).  The supervisor's sweep — on its own scheduler, so a wedged shard
cannot stall it — declares a shard failed when its beacon goes silent for
``heartbeat_timeout``.  Unhandled worker crashes (``SimulatedCrash``,
``JournalCrashed``, ``JournalFenced``) short-circuit detection: the
engine's crash channel reports them to :meth:`on_worker_crash` immediately.

**Fencing** — the victim's journal segment is fenced and taken over
(:meth:`~repro.core.journal.Journal.takeover`): a new epoch record is
journaled, the successor owns the segment, and every append a zombie
worker thread still attempts on the old handle raises
:class:`~repro.core.journal.JournalFenced` — provably rejected, never
silently interleaved (the acceptance proof in tests/core/test_failover.py).

**Re-homing** — the victim's segment is replayed *online* and its live
runs move to the surviving shards, chosen by the same rendezvous the pool
now routes by (:meth:`~repro.core.shard_pool.EngineShardPool.live_shard_index`),
so lookups need no forwarding state:

* resident runs are **transplanted as objects**: the live ``Run`` moves to
  its new host with its context, completion callbacks (admission slots
  credit back on completion, flow-as-action parents still resolve), and
  cross-shard join pointers intact; durability comes from a
  ``run_rehomed`` record embedding the full image on the new host's
  segment plus a ``run_rehomed_out`` tombstone on the takeover journal;
* dormant stubs **re-park cheaply**: the stub object is re-armed on the
  new host with a fresh ``run_passivated`` fast-path record;
* **torn runs** — the victim died between mutating a run terminal
  in-memory and journaling it — are completed on the host (terminal
  record, stats, callbacks, fan-out routing);
* Map children re-resolve through the foreign-residency index, interrupted
  joins are re-driven (``_map_admit`` / child-completion re-delivery), and
  trigger journal ownership re-hashes via ``trigger_rehomed`` records;
* runs whose images exist only in the journal (crash between append and
  registration) are rebuilt recovery-style, re-attaching their admission
  slot via :meth:`~repro.core.admission.FairAdmission.readopt`.

Throughout, the surviving shards never stop executing: takeover touches
only the victim's tables, the pool's routing maps, and ordinary journal
appends/scheduler events on the survivors.

Chaos integration: hand the supervisor a
:class:`~repro.core.chaos.ChaosPlane` and its ``plan_kill`` schedule is
armed on the supervisor's scheduler — ``crash`` kills report through the
crash channel, ``hang`` kills freeze the shard and let the heartbeat sweep
discover it.
"""

from __future__ import annotations

import copy
import threading
import traceback
from typing import Callable

from . import asl
from .engine import (
    RUN_ACTIVE,
    RUN_CANCELLED,
    RUN_FAILED,
    RUN_SUCCEEDED,
    DormantStub,
    FlowEngine,
    Run,
    Scheduler,
)
from .journal import RunImage, replay_segment, terminal_map_children

#: stats keys bumped on the host when a torn run is completed there
_TERMINAL_STAT = {
    RUN_SUCCEEDED: "runs_succeeded",
    RUN_FAILED: "runs_failed",
    RUN_CANCELLED: "runs_cancelled",
}


class ShardSupervisor:
    """Heartbeat supervision, fencing, and online run re-homing for a pool.

    Opt-in: construct one over an :class:`~repro.core.shard_pool.EngineShardPool`
    (or let :meth:`~repro.core.flows_service.FlowsService.enable_supervision`
    wire it) and call :meth:`start`.  Under a VirtualClock the beacons,
    sweeps, and kill plans are ordinary scheduler events — drive them with
    ``pool.drain(until=...)`` and the whole failover is deterministic.
    """

    def __init__(
        self,
        pool,
        heartbeat_interval: float = 0.5,
        heartbeat_timeout: float = 2.0,
        chaos=None,
        flows: "dict[str, asl.Flow] | Callable[[], dict] | None" = None,
    ):
        if heartbeat_timeout <= heartbeat_interval:
            raise ValueError(
                "heartbeat_timeout must exceed heartbeat_interval "
                f"({heartbeat_timeout} <= {heartbeat_interval})"
            )
        self.pool = pool
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.chaos = chaos
        #: flow definitions for journal-image-only rebuilds: a dict, or a
        #: callable returning one (FlowsService passes its bound lookup so
        #: flows published after start() are still resolvable)
        self._flows = flows
        #: the supervisor's own event queue: sweeps and kill plans must not
        #: ride a shard's scheduler, or the failure they watch for would
        #: also silence them
        self.scheduler = Scheduler(pool.clock)
        now = pool.clock.now()
        self.last_beat: dict[int, float] = {
            i: now for i in range(pool.num_shards)
        }
        self.failed: set[int] = set()
        self.stats = {
            "failovers": 0,
            "runs_rehomed": 0,
            "stubs_reparked": 0,
            "images_rehomed": 0,
            "torn_completed": 0,
            "triggers_rehomed": 0,
            "zombie_crashes_swallowed": 0,
        }
        #: one entry per failover: shard, reason, detection/completion
        #: times on the shared clock (the MTTR benchmark reads this)
        self.timeline: list[dict] = []
        self._lock = threading.RLock()
        self._started = False
        self._thread: threading.Thread | None = None
        # cached bound methods so every beacon/sweep shares one callback
        self._beacon_cb = self._beacon
        self._sweep_cb = self._sweep

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Arm beacons, the sweep, and any chaos kill plans."""
        with self._lock:
            if self._started:
                return
            self._started = True
        self.pool.attach_supervisor(self)
        for i, engine in enumerate(self.pool.engines):
            engine.scheduler.call_later(
                self.heartbeat_interval, self._beacon_cb, arg=i
            )
        self.scheduler.call_later(self.heartbeat_interval, self._sweep_cb)
        if self.chaos is not None:
            for plan in self.chaos.kills:
                self.scheduler.call_at(plan.at, self._execute_kill, arg=plan)
        if not self.pool.clock.virtual:
            # real mode: the supervisor drives its own queue on a dedicated
            # thread (inline executor — sweeps and kills are short and must
            # not depend on any shard's worker pool)
            self._thread = threading.Thread(
                target=self.scheduler.run_forever,
                args=(lambda fn: fn(),),
                daemon=True,
                name="shard-supervisor",
            )
            self._thread.start()

    def stop(self) -> None:
        self.scheduler.stop()

    def flows_by_id(self) -> dict:
        flows = self._flows
        if flows is None:
            return {}
        if callable(flows):
            return flows()
        return flows

    # ------------------------------------------------------------ heartbeats
    def _beacon(self, shard_id: int) -> None:
        """Executed ON the shard's scheduler: proof of life, self-rearming."""
        self.last_beat[shard_id] = self.pool.clock.now()
        if shard_id not in self.failed:
            self.pool.engines[shard_id].scheduler.call_later(
                self.heartbeat_interval, self._beacon_cb, arg=shard_id
            )

    def _sweep(self) -> None:
        """Executed on the supervisor's scheduler: declare silent shards dead."""
        now = self.pool.clock.now()
        for i in range(self.pool.num_shards):
            if i in self.failed:
                continue
            if now - self.last_beat[i] > self.heartbeat_timeout:
                silent = now - self.last_beat[i]
                try:
                    self.fail_shard(
                        i, reason=f"heartbeat silent for {silent:.3f}s"
                    )
                except Exception:  # never kill the sweep on a takeover bug
                    traceback.print_exc()
        self.scheduler.call_later(self.heartbeat_interval, self._sweep_cb)

    # ------------------------------------------------------------ crash channel
    def on_worker_crash(self, shard_id: int, exc: BaseException) -> bool:
        """An unhandled crash escaped a shard's worker loop.

        Returns True when the supervisor handled it (the worker swallows
        the exception).  Crashes from an *already-failed* shard are zombie
        work — swallowed quietly so a fenced shard's stragglers die without
        noise.  ``shard_id`` outside the pool (e.g. the supervisor's own
        scheduler index under a virtual drain) is not ours: return False
        and let the caller re-raise.
        """
        if shard_id is None or not (0 <= shard_id < self.pool.num_shards):
            return False
        with self._lock:
            if shard_id in self.failed:
                self.stats["zombie_crashes_swallowed"] += 1
                return True
        try:
            self.fail_shard(shard_id, reason=f"worker crash: {exc!r}")
        except Exception:
            traceback.print_exc()
        return True

    # ------------------------------------------------------------ chaos kills
    def _execute_kill(self, plan) -> None:
        if plan.executed or plan.shard_id in self.failed:
            return
        plan.executed = True
        if plan.mode == "hang":
            self.hang_shard(plan.shard_id)
        else:
            # "crash" and — for inline (thread) pools, where there is no
            # separate worker process to signal — "sigkill" both land here;
            # the process backend delivers "sigkill" plans as real signals
            self.fail_shard(
                plan.shard_id, reason=f"chaos kill (mode={plan.mode})"
            )

    def hang_shard(self, shard_id: int) -> None:
        """Freeze a shard's event loop without reporting anything.

        The shard stops executing (its scheduler halts in real mode; its
        events are skipped by the pool drain in virtual mode) but nothing
        tells the supervisor — only the missed heartbeats do.  This is the
        failure mode fencing exists for: the hung worker may wake up later
        and try to keep appending.
        """
        self.pool.scheduler.pause_shard(shard_id)
        if not self.pool.clock.virtual:
            self.pool.engines[shard_id].scheduler.stop()

    # ------------------------------------------------------------ failover
    def fail_shard(self, shard_id: int, reason: str = "") -> None:
        """Fence a dead shard and re-home its live state onto survivors.

        Idempotent per shard.  Refuses to fail the last live shard — with
        no survivor there is nowhere to re-home, and cold recovery is the
        correct tool.  Runs entirely on the calling thread; the surviving
        shards keep executing concurrently throughout.
        """
        pool = self.pool
        with self._lock:
            if shard_id in self.failed:
                return
            survivors = [
                i for i in range(pool.num_shards)
                if i != shard_id and i not in self.failed
            ]
            if not survivors:
                raise RuntimeError(
                    f"refusing to fail shard {shard_id}: no survivor to "
                    f"re-home onto (cold recovery required)"
                )
            self.failed.add(shard_id)
        clock = pool.clock
        t_detect = clock.now()
        victim = pool.engines[shard_id]

        # 1. stop routing to / executing on the victim.  mark_dead switches
        # every pool routing map to the survivor set; stopping the victim's
        # scheduler parks its queue (zombie threads may still be mid-event —
        # the fence below is what actually neutralizes them).
        pool.mark_dead(shard_id)
        victim.scheduler.stop()
        vpool = getattr(victim, "_pool", None)
        if vpool is not None:
            vpool.shutdown(wait=False)

        # 2. fence + takeover: ``victim.journal`` REMAINS the fenced object
        # every zombie code path still holds, so their late appends raise
        # JournalFenced; the successor owns the segment under epoch+1.
        takeover = victim.journal.takeover(
            reason=f"shard {shard_id} failover: {reason}"
        )

        # 3. replay the victim's segment online (survivors keep running).
        view = replay_segment(takeover)

        # 4. terminal Map-child results from the victim's segment join the
        # pool-wide shared table so any parent's _map_admit re-attaches
        # them (the table was unified across engines at attach time).
        shared = pool.engines[survivors[0]].recovered_map_results
        for child_id, result in terminal_map_children(view).items():
            shared.setdefault(child_id, result)

        # 5. snapshot-and-clear the victim's tables.  From here on, zombie
        # events on the victim fail their _live() identity check; the
        # objects belong to their new hosts.
        with victim._lock:
            residents = sorted(
                victim.runs.values(),
                key=lambda r: (r.seq, r.start_time, r.run_id),
            )
            victim.runs.clear()
            stubs = sorted(
                victim.dormant.values(),
                key=lambda s: (s.seq, s.start_time, s.run_id),
            )
            victim.dormant.clear()
        with pool._foreign_lock:
            for run_id in [
                rid for rid, idx in pool._foreign.items() if idx == shard_id
            ]:
                del pool._foreign[run_id]

        now = clock.now()
        # 6. dormant stubs re-park on their new host (cheap: the stub object
        # moves; one run_rehomed + one run_passivated append per stub).
        for stub in stubs:
            self._repark_stub(stub, view, takeover, now)

        # 7. resident runs: torn terminal runs are completed on the host;
        # ACTIVE runs transplant.  Two passes — every run is registered and
        # journaled on its new host before any continuation is scheduled,
        # so re-driven joins see the whole family in place.
        transplanted: list[tuple[Run, FlowEngine]] = []
        torn: list[tuple[Run, FlowEngine]] = []
        for run in residents:
            host = pool.engines[pool.live_shard_index(run.run_id)]
            if run.status != RUN_ACTIVE:
                if run.done.is_set():
                    # terminal and fully journaled pre-crash: re-register
                    # for status lookups, nothing to repair
                    self._register(run, host)
                else:
                    torn.append((run, host))
                continue
            self._transplant(run, host, takeover, now)
            transplanted.append((run, host))
        for run, host in torn:
            self._complete_torn(run, host, takeover, now)
        for run, host in transplanted:
            self._resume_on_host(run, host)

        # 8. images with no in-memory object (the victim died between the
        # append and the registration, or a dormant image predating this
        # process): rebuild recovery-style.
        seen = {run.run_id for run in residents} | {s.run_id for s in stubs}
        flows = self.flows_by_id()
        for run_id in sorted(view.runs):
            image = view.runs[run_id]
            if image.status != RUN_ACTIVE or image.run_id in seen:
                continue
            self._rehome_image(image, flows, takeover, now)

        # 9. trigger journal ownership re-hashes: each trigger image from
        # the victim's segment is re-journaled (full state, ack-progress
        # included) on its new hash home so recovery finds it there.
        for trigger_id in sorted(view.triggers):
            pool.journal_for(trigger_id).append(
                {
                    "type": "trigger_rehomed",
                    "trigger_id": trigger_id,
                    "from_shard": shard_id,
                    "image": view.triggers[trigger_id].to_state(),
                    "t": now,
                }
            )
            self.stats["triggers_rehomed"] += 1

        t_done = clock.now()
        with self._lock:
            self.stats["failovers"] += 1
            self.timeline.append(
                {
                    "shard": shard_id,
                    "reason": reason,
                    "detected_at": t_detect,
                    "completed_at": t_done,
                    "takeover_s": t_done - t_detect,
                    "runs_rehomed": len(transplanted),
                    "torn_completed": len(torn),
                    "stubs_reparked": len(stubs),
                    "epoch": takeover.epoch,
                }
            )

    # ------------------------------------------------------------ re-homing
    def _register(self, run: Run, host: FlowEngine) -> None:
        run.engine = host
        with host._lock:
            host.runs[run.run_id] = run
        self.pool.note_residency(run.run_id, host.shard_id)

    def _rehomed_record(
        self, run_id: str, image_state: dict, host: FlowEngine,
        takeover, now: float,
    ) -> None:
        """Durable half of a re-home: image on the host, tombstone behind."""
        host.journal.append(
            {
                "type": "run_rehomed",
                "run_id": run_id,
                "to_shard": host.shard_id,
                "epoch": takeover.epoch,
                "image": image_state,
                "t": now,
            }
        )
        takeover.append(
            {
                "type": "run_rehomed_out",
                "run_id": run_id,
                "to_shard": host.shard_id,
                "t": now,
            }
        )

    def _repark_stub(
        self, stub: DormantStub, view, takeover, now: float
    ) -> None:
        """Re-park a dormant stub on its new host.

        The stub object itself moves (caller identity, tags, ACLs — richer
        than a cold-recovery re-adoption); the paged-out context is read
        from the replayed image and written back to the host's segment so
        rehydration keeps its one-seek fast path.
        """
        pool = self.pool
        host = pool.engines[pool.live_shard_index(stub.run_id)]
        image = view.runs.get(stub.run_id)
        context = copy.deepcopy(image.context) if image is not None else None
        image_state = (
            image.to_state()
            if image is not None
            else {"run_id": stub.run_id, "flow_id": stub.flow_id,
                  "status": RUN_ACTIVE, "passivated": True,
                  "current_state": stub.state, "attempt": stub.attempt,
                  "wake_time": stub.wake_time, "passivate_mode": stub.mode,
                  "seq": stub.seq, "tenant": stub.tenant_id}
        )
        self._rehomed_record(stub.run_id, image_state, host, takeover, now)
        offset = host.journal.append(
            {
                "type": "run_passivated",
                "run_id": stub.run_id,
                "state": stub.state,
                "attempt": stub.attempt,
                "mode": stub.mode,
                "wake_time": stub.wake_time,
                "context": context,
                "t": now,
            }
        )
        stub.journal_ref = (
            (host.journal.generation, offset) if offset is not None else None
        )
        with host._lock:
            host.dormant[stub.run_id] = stub
            host.stats["runs_reparked"] += 1
        pool.note_residency(stub.run_id, host.shard_id)
        # the old wake_handle died with the victim's scheduler; re-arm here
        stub.wake_handle = host.scheduler.call_at(
            max(stub.wake_time, now), host._wake_dormant_cb, arg=stub.run_id
        )
        self.stats["stubs_reparked"] += 1

    def _transplant(
        self, run: Run, host: FlowEngine, takeover, now: float
    ) -> None:
        """Move a live Run object to ``host``, durably.

        The in-memory object is authoritative (it may hold context patches
        not yet journaled), so the ``run_rehomed`` image snapshots *it*,
        not the replayed view; after the append the run journals deltas
        against that baseline on the host's segment.  Moving the object —
        not rebuilding it — preserves completion callbacks (admission
        slots, flow-as-action watchers) and cross-shard parent/child join
        pointers by identity.
        """
        with run.lock:
            image_state = {
                "run_id": run.run_id,
                "flow_id": run.flow_id,
                "creator": run.creator,
                "label": run.label,
                "status": run.status,
                "context": copy.deepcopy(run.context),
                "current_state": run.current_state,
                "attempt": run.attempt,
                "seq": run.seq,
                "tenant": run.tenant_id,
                "error": run.error,
                "action_id": run.action_id,
                "action_provider": run.action_provider_url,
                "passivated": False,
            }
            # the rehomed record carries the full context: subsequent
            # deltas on the host apply against this baseline
            run.context_journaled = True
            run.pending_patch = []
            run.patch_records = 0
        self._rehomed_record(run.run_id, image_state, host, takeover, now)
        self._register(run, host)
        if run.of_join is not None:
            with host._lock:
                host.map_hosted += 1
        self.stats["runs_rehomed"] += 1

    def _complete_torn(
        self, run: Run, host: FlowEngine, takeover, now: float
    ) -> None:
        """Finish a run the victim completed in memory but never journaled.

        ``run.status != ACTIVE`` with ``done`` unset means the victim died
        inside ``_complete_run`` between the in-memory mutation and the
        terminal append.  The decision already happened — journal it on the
        host and run the rest of the completion protocol (stats, waiters,
        callbacks, fan-out routing) there.
        """
        with run.lock:
            image_state = {
                "run_id": run.run_id,
                "flow_id": run.flow_id,
                "creator": run.creator,
                "label": run.label,
                "status": run.status,
                "context": copy.deepcopy(run.context),
                "current_state": None,
                "attempt": run.attempt,
                "seq": run.seq,
                "tenant": run.tenant_id,
                "error": run.error,
            }
        self._rehomed_record(run.run_id, image_state, host, takeover, now)
        self._register(run, host)
        key = _TERMINAL_STAT.get(run.status)
        if key:
            with host._lock:
                host.stats[key] += 1
        run.done.set()
        for cb in list(run.completion_callbacks):
            try:
                cb(run)
            except Exception:
                pass
        if run.parent is not None:
            host.scheduler.submit(lambda r=run: host._fanout_child_done(r))
        self.stats["torn_completed"] += 1

    def _resume_on_host(self, run: Run, host: FlowEngine) -> None:
        """Re-establish a transplanted run's continuation on its new host.

        Every scheduler event the run was waiting on died with the victim's
        queue; this schedules the minimal replacement.  Re-entering a state
        is idempotent: the journaled ``request_id`` dedups action
        re-dispatch, Pass/Choice re-execution is a fixed point, and a
        restarted Wait shifts timing but not the terminal state.
        """
        if run.deferred:
            # parked in an admission lane: the DRR pump holds the
            # continuation and releases it via run.engine (now the host)
            return
        if run.map_join is not None:
            # Map owner: children whose completion events died in flight
            # re-deliver (idempotent — the join's removal gate drops
            # duplicates), then the window refills
            state = run.flow.states.get(run.current_state or "")
            with run.lock:
                finished = [
                    c for c in run.children if c.status != RUN_ACTIVE
                ]
            for child in finished:
                host.scheduler.submit(
                    lambda c=child: host._map_child_done(c)
                )
            if state is not None:
                host.scheduler.submit(
                    lambda r=run, s=state: host._map_admit(r, s)
                )
            return
        if run.children:
            # Parallel owner: children run on (one of) the shards; the join
            # re-evaluates on any completion.  If the last completion's
            # event was lost, synthesize one — join_claimed makes it safe.
            with run.lock:
                finished = [
                    c for c in run.children if c.status != RUN_ACTIVE
                ]
            if finished:
                host.scheduler.submit(
                    lambda c=finished[0]: host._parallel_child_done(c)
                )
            return
        state_name = run.current_state or run.flow.start_at
        attempt = run.attempt
        host.scheduler.submit(
            lambda r=run, s=state_name, a=attempt: host._enter_state(r, s, a)
        )

    def _rehome_image(
        self, image: RunImage, flows: dict, takeover, now: float
    ) -> None:
        """Rebuild a run that exists only as a journal image.

        The victim died between journaling and registering it (or the image
        predates this process).  Mirrors cold recovery — including dormant
        re-adoption — but lands the run on its live home shard and credits
        its admission slot callback back via ``FairAdmission.readopt``
        (the original admission's counter is still held; only the
        in-memory callback died with the victim).
        """
        pool = self.pool
        host = pool.engines[pool.live_shard_index(image.run_id)]
        flow = flows.get(image.flow_id)
        if flow is None:
            # un-resumable without a definition; the rehomed image is still
            # journaled so a later cold recovery (with flows) can resume it
            self._rehomed_record(
                image.run_id, image.to_state(), host, takeover, now
            )
            return
        self._rehomed_record(
            image.run_id, image.to_state(), host, takeover, now
        )
        if image.passivated and host.passivate_after is not None:
            host._adopt_dormant(image, flow)
            pool.note_residency(image.run_id, host.shard_id)
            self.stats["images_rehomed"] += 1
            return
        run = Run(
            run_id=image.run_id,
            flow=flow,
            flow_id=image.flow_id,
            creator=image.creator,
            caller=None,
            label=image.label,
            context=copy.deepcopy(image.context),
            start_time=now,
            context_journaled=True,
            engine=host,
            seq=image.seq,
            tenant_id=image.tenant,
        )
        with host._lock:
            host.runs[run.run_id] = run
        pool.note_residency(run.run_id, host.shard_id)
        if run.tenant_id is not None:
            pool.admission.readopt(run.tenant_id, run)
        state_name = image.current_state or flow.start_at
        attempt = image.attempt
        host.scheduler.submit(
            lambda r=run, s=state_name, a=attempt: host._enter_state(r, s, a)
        )
        self.stats["images_rehomed"] += 1
