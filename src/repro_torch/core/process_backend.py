"""ProcessBackend: shard engines hosted in spawned worker processes.

The GIL pins the inline (thread-per-shard) pool to one core: past two
shards, adding engines only adds lock convoy (the first open ROADMAP
item, visible in ``benchmarks/results/baseline.json`` as throughput
*regressing* from 2 to 8 shards).  This backend moves execution across a
real process boundary, the way fleet-scale workflow services host engine
workers:

* each **worker process** owns a group of shards — their
  :class:`~repro.core.engine.FlowEngine` s, journal *segments*, action
  providers, and worker threads — rebuilt from plain data after spawn;
* the **parent** keeps the whole control plane: flow publishing, auth,
  :class:`~repro.core.admission.FairAdmission` tenant metering, run
  handles, heartbeat supervision, and chaos kill plans;
* the two sides speak a **framed length-prefixed pipe protocol** (each
  frame one JSON object over ``Connection.send_bytes``; msgpack would be
  byte-compatible here, JSON is what the container has).  **No pickle of
  live objects** ever crosses: flows travel as their ASL definition
  documents, runs as ids + plain status payloads, registries as
  ``"module:callable"`` factory specs re-resolved worker-side.

Auth/tenancy across the boundary
--------------------------------
Tokens are **never shipped**.  A submission carries only the creator's
username and the tenant *id* string; the worker-side registry factory is
the re-delegation point — it mints whatever worker-local credentials its
providers need, exactly as a fleet worker exchanges its own identity for
scoped action tokens instead of receiving the user's.  Tenant metering
(token buckets, DRR queues, the admission window) stays entirely
parent-side; when a worker reports a terminal run the parent credits the
slot back by tenant id (:meth:`FairAdmission.credit` — the
admission-credit message of the protocol is the ``run_done`` event).

Failure model
-------------
Worker death is detected by **pid-wait + heartbeat silence** (heartbeats
ride the event pipe).  Recovery reuses the journal's failover machinery verbatim:
the successor worker reopens the dead worker's segments (lazy per-process
file handles — no fd crosses the spawn), **bumps the fencing epoch**, and
replays — terminal runs resolve the parent's handles, unfinished runs
resume on the successor.  Submissions the victim never journaled are
re-sent by the parent; workers deduplicate by run id, so every run
executes **exactly once** as observed by the journal.  Successor choice
is :func:`~repro.core.shard_pool.survivor_index` over the worker pool —
the same stable re-hash the inline supervisor re-homes by.

Limitations (by design, guarded with clear errors): real clock only (the
deterministic VirtualClock merge is the inline backend's job), no event
router / queue triggers, no passivation, and Map children co-locate with
their parent's shard inside the worker (invariant 13 is about terminal
states, not placement).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import secrets
import signal
import threading
import time
from typing import Callable

from . import asl
from .admission import FairAdmission
from .auth import Tenant
from .backend import ExecutionBackend
from .clock import Clock, MonotonicId, RealClock
from .engine import (
    RUN_ACTIVE,
    RUN_CANCELLED,
    RUN_SUCCEEDED,
    FlowEngine,
    Scheduler,
)
from .errors import NotFound
from .journal import Journal, _jsonable, replay_segment, segment_path
from .shard_pool import shard_index, survivor_index

#: statuses a worker reports and a handle can rest in
_TERMINAL = ("SUCCEEDED", "FAILED", "CANCELLED")


def _encode(msg: dict) -> bytes:
    return json.dumps(msg, separators=(",", ":"), default=_jsonable).encode()


def _resolve_registry(spec: str):
    """``"module:callable"`` -> the registry that callable builds.

    The factory-spec indirection is the no-pickle rule applied to
    providers: a registry full of live objects (auth managers, token
    stores, open clients) cannot cross a spawn, but the *recipe* for one
    is a dotted string any process can resolve.
    """
    modname, _, attr = spec.partition(":")
    if not modname or not attr:
        raise ValueError(f"registry spec must be 'module:callable', got {spec!r}")
    import importlib

    factory = getattr(importlib.import_module(modname), attr)
    return factory()


def default_registry():
    """Echo + Sleep registry factory (tests and examples).

    Worker processes re-delegate credentials here: the factory runs
    *inside* the worker, so any auth its providers need is minted locally
    — the parent never serializes a token into a submit message.
    """
    from .actions import ActionRegistry
    from .providers import EchoProvider, SleepProvider

    registry = ActionRegistry()
    registry.register(EchoProvider())
    registry.register(SleepProvider())
    return registry


# --------------------------------------------------------------------------
# worker side
# --------------------------------------------------------------------------


class _WorkerHost:
    """Everything one worker process owns: engines, journals, providers."""

    def __init__(self, worker_id, shard_ids, num_shards, options, cmd, evt):
        self.worker_id = worker_id
        self.num_shards = num_shards
        self.options = options
        self.cmd = cmd
        self.evt = evt
        self._evt_lock = threading.Lock()
        self.clock = RealClock()
        self.registry = _resolve_registry(options["registry_spec"])
        self.flows: dict[str, asl.Flow] = {}
        self.engines: dict[int, FlowEngine] = {}
        #: run ids this process accepted (parent re-sends after failover
        #: race; first submit wins — the exactly-once half the worker owns)
        self._submitted: set[str] = set()
        self._submit_lock = threading.Lock()
        from concurrent.futures import ThreadPoolExecutor

        # submits journal synchronously (group commit batches concurrent
        # appenders), so they must not serialize behind the pipe reader
        self._exec = ThreadPoolExecutor(
            max_workers=int(options.get("max_workers", 8)),
            thread_name_prefix=f"worker{worker_id}-submit",
        )
        for shard in shard_ids:
            self._add_engine(shard)

    # ------------------------------------------------------------ plumbing
    def _send(self, msg: dict) -> None:
        try:
            with self._evt_lock:
                self.evt.send_bytes(_encode(msg))
        except OSError:  # parent gone: nothing left to report to
            pass

    def _reply(self, req: int, ok: bool, value=None, error: str = "") -> None:
        self._send({"ev": "reply", "req": req, "ok": ok,
                    "value": value, "error": error})

    def _journal(self, shard: int) -> Journal:
        opts = self.options
        return Journal(
            segment_path(opts["journal_path"], shard, self.num_shards),
            fsync=bool(opts.get("fsync", False)),
            latency_s=float(opts.get("journal_latency_s", 0.0)),
            group_commit=bool(opts.get("group_commit", True)),
            compact_every=opts.get("compact_every"),
        )

    def _add_engine(self, shard: int, journal: Journal | None = None) -> FlowEngine:
        engine = FlowEngine(
            self.registry,
            clock=self.clock,
            journal=journal if journal is not None else self._journal(shard),
            max_workers=int(self.options.get("max_workers", 8)),
            delta_journal=bool(self.options.get("delta_journal", True)),
            snapshot_every=int(self.options.get("snapshot_every", 64)),
        )
        engine.shard_id = shard

        def die(exc, shard=shard):
            # the process IS the shard: a durability-layer crash ends it
            # and the parent's pid-wait + silence detection takes over
            self._send({"ev": "crashed", "worker": self.worker_id,
                        "shard": shard, "error": repr(exc)})
            os._exit(70)

        engine.crash_listener = die
        self.engines[shard] = engine
        return engine

    def _watch(self, run) -> None:
        """Report ``run``'s terminal state over the pipe, exactly-once-ish.

        Attach-then-check closes the race with a run completing before the
        callback lands; the parent's resolve is idempotent, so the rare
        double fire is harmless.
        """

        def report(r):
            with r.lock:
                payload = {
                    "ev": "run_done",
                    "run_id": r.run_id,
                    "status": r.status,
                    "error": r.error,
                    "context": r.context,
                    "current_state": r.current_state,
                    "completion_time": r.completion_time,
                    "tenant": r.tenant_id,
                }
            self._send(payload)

        with run.lock:
            run.completion_callbacks.append(report)
            terminal = run.status != RUN_ACTIVE
        if terminal:
            report(run)

    # ------------------------------------------------------------ operations
    def op_publish(self, msg) -> None:
        self.flows[msg["flow_id"]] = asl.parse(msg["definition"])

    def op_submit(self, msg) -> None:
        run_id = msg["run_id"]
        engine = self.engines[msg["shard"]]
        with self._submit_lock:
            if run_id in self._submitted:
                # duplicate (parent re-sent across a failover race): the
                # run already lives here — re-report if it's terminal so a
                # lost run_done cannot strand the parent's handle
                run = engine.runs.get(run_id)
                if run is not None and run.status != RUN_ACTIVE:
                    self._watch(run)
                return
            self._submitted.add(run_id)
        def reject(error: dict) -> None:
            self._send({"ev": "run_done", "run_id": run_id,
                        "status": "FAILED", "error": error,
                        "context": None, "current_state": None,
                        "completion_time": self.clock.now(),
                        "tenant": msg.get("tenant")})

        flow = self.flows.get(msg["flow_id"])
        if flow is None:
            reject({"code": "FlowNotFound", "cause": msg["flow_id"]})
            return
        try:
            run = engine.start_run(
                flow,
                msg.get("input"),
                flow_id=msg["flow_id"],
                creator=msg.get("creator", "anonymous"),
                label=msg.get("label", ""),
                run_id=run_id,
                seq=int(msg.get("seq", 0)),
                tenant_id=msg.get("tenant"),
            )
        except Exception as exc:
            # a submission that cannot even start must still resolve the
            # parent's handle, or its client would wait forever
            reject({"code": "SubmitFailed", "cause": repr(exc)})
            return
        self._watch(run)

    def op_cancel(self, msg) -> None:
        engine = self.engines.get(msg["shard"])
        if engine is None:
            return
        try:
            engine.cancel_run(msg["run_id"])
        except NotFound:
            pass

    def op_status(self, msg):
        return self.engines[msg["shard"]].run_status(msg["run_id"])

    def op_wake(self, msg):
        engine = self.engines.get(msg["shard"])
        return False if engine is None else engine.wake_run(msg["run_id"])

    def op_stats(self, msg):
        totals: dict[str, int] = {}
        for engine in self.engines.values():
            with engine._lock:
                for key, value in engine.stats.items():
                    totals[key] = totals.get(key, 0) + value
        return totals

    def op_compact(self, msg):
        return [self.engines[s].compact() for s in sorted(self.engines)]

    def _replay_terminal(self, journal: Journal) -> dict[str, dict]:
        view = replay_segment(journal)
        out = {}
        for run_id, image in view.runs.items():
            if image.status in _TERMINAL:
                out[run_id] = {
                    "status": image.status,
                    "error": image.error,
                    "context": image.context,
                    "current_state": image.current_state,
                    "completion_time": None,
                    "tenant": image.tenant,
                }
        return out

    def op_recover(self, msg):
        """Cold recovery of this worker's own segments (parent restart)."""
        resumed, terminal = [], {}
        for shard in sorted(self.engines):
            engine = self.engines[shard]
            terminal.update(self._replay_terminal(engine.journal))
            for run in engine.recover(self.flows, resume=msg.get("resume", True)):
                with self._submit_lock:
                    self._submitted.add(run.run_id)
                self._watch(run)
                resumed.append({
                    "run_id": run.run_id, "flow_id": run.flow_id,
                    "creator": run.creator, "label": run.label,
                    "seq": run.seq, "tenant": run.tenant_id,
                    "shard": shard,
                })
        return {"resumed": resumed, "terminal": terminal}

    def op_takeover(self, msg):
        """Adopt a dead worker's shards: fence -> replay -> resume.

        The journal's takeover, across a process boundary: the segment's
        scan recovers the victim's fencing epoch, :meth:`Journal.bump_epoch`
        claims the next one (journaled, so any reader of the segment sees
        the succession), and the replayed images either resolve parent
        handles (terminal) or resume here (ACTIVE).
        """
        reason = msg.get("reason", "worker failover")
        resumed, terminal, epochs = [], {}, {}
        for shard in msg["shards"]:
            if shard in self.engines:
                continue  # idempotent: already adopted
            journal = self._journal(shard)
            epochs[str(shard)] = journal.bump_epoch(reason)
            terminal.update(self._replay_terminal(journal))
            engine = self._add_engine(shard, journal=journal)
            for run in engine.recover(self.flows, resume=True):
                with self._submit_lock:
                    self._submitted.add(run.run_id)
                self._watch(run)
                resumed.append(run.run_id)
        return {"resumed": resumed, "terminal": terminal, "epochs": epochs}

    # ------------------------------------------------------------ main loop
    def heartbeat_loop(self, stop: threading.Event) -> None:
        interval = float(self.options.get("heartbeat_interval", 0.5))
        while not stop.wait(interval):
            self._send({"ev": "hb", "worker": self.worker_id,
                        "t": time.time()})

    def serve(self) -> None:
        stop = threading.Event()
        hb = threading.Thread(target=self.heartbeat_loop, args=(stop,),
                              daemon=True, name=f"worker{self.worker_id}-hb")
        hb.start()
        self._send({"ev": "hello", "worker": self.worker_id,
                    "pid": os.getpid(),
                    "shards": sorted(self.engines)})
        try:
            while True:
                try:
                    msg = json.loads(self.cmd.recv_bytes())
                except (EOFError, OSError):
                    break  # parent went away: shut down quietly
                op = msg.get("op")
                if op == "shutdown":
                    break
                if op == "submit":
                    self._exec.submit(self._guard, self.op_submit, msg)
                elif op == "cancel":
                    self._exec.submit(self._guard, self.op_cancel, msg)
                elif op == "publish":
                    self.op_publish(msg)
                else:
                    handler = getattr(self, f"op_{op}", None)
                    req = msg.get("req")
                    if handler is None:
                        if req is not None:
                            self._reply(req, False, error=f"unknown op {op!r}")
                        continue
                    try:
                        value = handler(msg)
                    except Exception as exc:  # reply, don't die
                        if req is not None:
                            self._reply(req, False, error=repr(exc))
                    else:
                        if req is not None:
                            self._reply(req, True, value=value)
        finally:
            stop.set()
            self._exec.shutdown(wait=False)
            for engine in self.engines.values():
                engine.shutdown()

    def _guard(self, fn, msg) -> None:
        try:
            fn(msg)
        except Exception:
            import traceback

            traceback.print_exc()


def _worker_main(worker_id, shard_ids, num_shards, options, cmd, evt) -> None:
    """Spawn target (module-level so the child can import it)."""
    host = _WorkerHost(worker_id, shard_ids, num_shards, options, cmd, evt)
    host.serve()


# --------------------------------------------------------------------------
# parent side
# --------------------------------------------------------------------------


class _RunHandle:
    """The parent's Run-shaped view of a worker-resident run.

    Duck-compatible with :class:`~repro.core.engine.Run` where the control
    plane needs it: ``FlowsService`` filters on ``tags`` / ACL sets,
    ``FairAdmission`` appends ``completion_callbacks`` and reads
    ``status``, benchmarks ``wait()`` on ``done``.  The authoritative
    state lives in the worker's journal; this is a mirror the ``run_done``
    event keeps honest.
    """

    __slots__ = (
        "run_id", "flow_id", "shard", "creator", "label", "seq",
        "tenant_id", "tags", "monitor_by", "manage_by", "input",
        "status", "error", "context", "current_state", "start_time",
        "completion_time", "events_dropped", "parent", "deferred",
        "cancel_requested", "lock", "done", "completion_callbacks",
    )

    def __init__(self, run_id, flow_id, shard, *, creator="anonymous",
                 label="", seq=0, tenant_id=None, tags=None,
                 monitor_by=None, manage_by=None, flow_input=None,
                 start_time=0.0):
        self.run_id = run_id
        self.flow_id = flow_id
        self.shard = shard
        self.creator = creator
        self.label = label
        self.seq = seq
        self.tenant_id = tenant_id
        self.tags = list(tags or [])
        self.monitor_by = set(monitor_by or ())
        self.manage_by = set(manage_by or ())
        self.input = flow_input
        self.status = RUN_ACTIVE
        self.error = None
        self.context = None
        self.current_state = None
        self.start_time = start_time
        self.completion_time = None
        self.events_dropped = 0
        self.parent = None
        self.deferred = False
        self.cancel_requested = False
        self.lock = threading.RLock()
        self.done = threading.Event()
        self.completion_callbacks: list[Callable] = []

    def as_status(self) -> dict:
        return {
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


class _Worker:
    """Parent-side record of one worker process."""

    __slots__ = ("worker_id", "proc", "cmd", "evt", "send_lock", "reader")

    def __init__(self, worker_id, proc, cmd, evt):
        self.worker_id = worker_id
        self.proc = proc
        self.cmd = cmd
        self.evt = evt
        self.send_lock = threading.Lock()
        self.reader = None


class ProcessBackend(ExecutionBackend):
    """Process-parallel execution behind the ExecutionBackend seam."""

    backend_name = "process"

    def __init__(
        self,
        registry_spec: str,
        num_shards: int = 1,
        clock: Clock | None = None,
        journal_path: str | None = None,
        fsync: bool = False,
        journal_latency_s: float = 0.0,
        group_commit: bool = True,
        compact_every: int | None = None,
        max_workers: int = 8,
        delta_journal: bool = True,
        snapshot_every: int = 64,
        admission_window: int | None = None,
        num_workers: int | None = None,
        heartbeat_interval: float = 0.5,
        heartbeat_timeout: float = 2.0,
        chaos=None,
        start_timeout: float = 60.0,
    ):
        if clock is not None and clock.virtual:
            raise ValueError(
                "process backend is real-clock only; the deterministic "
                "VirtualClock merge is the inline backend's job"
            )
        if heartbeat_timeout <= heartbeat_interval:
            raise ValueError("heartbeat_timeout must exceed heartbeat_interval")
        self.registry_spec = registry_spec
        self.clock = clock or RealClock()
        self.num_shards = num_shards
        if num_workers is None:
            # one worker per core, floor 2 (a single worker would put the
            # whole pool back behind one GIL), cap one worker per shard —
            # shard *groups* are the unit a worker owns, not single shards
            num_workers = max(2, os.cpu_count() or 1)
        self.num_workers = max(1, min(num_workers, num_shards))
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.chaos = chaos
        self._owned_dir: str | None = None
        if journal_path is None:
            import tempfile

            self._owned_dir = tempfile.mkdtemp(prefix="repro-procpool-")
            journal_path = os.path.join(self._owned_dir, "journal.jsonl")
        self.journal_path = journal_path
        self._options = {
            "registry_spec": registry_spec,
            "journal_path": journal_path,
            "fsync": fsync,
            "journal_latency_s": journal_latency_s,
            "group_commit": group_commit,
            "compact_every": compact_every,
            "max_workers": max_workers,
            "delta_journal": delta_journal,
            "snapshot_every": snapshot_every,
            "heartbeat_interval": heartbeat_interval,
        }
        self._seq = MonotonicId()
        self._req = MonotonicId()
        self._handles: dict[str, _RunHandle] = {}
        self._handles_lock = threading.Lock()
        self._flow_defs: dict[str, dict] = {}
        self._flows_lock = threading.Lock()
        #: shard -> worker id; updated (under _route_lock) by failover
        self._shard_owner = {
            shard: shard % self.num_workers for shard in range(num_shards)
        }
        self._route_lock = threading.Lock()
        self.dead_workers: set[int] = set()
        #: shards whose home worker died (compat with the inline pool's
        #: ``dead`` — here shards survive by moving, so this stays empty)
        self.dead: set[int] = set()
        self.supervisor = None
        #: one entry per worker failover (mttr-style timeline)
        self.failovers: list[dict] = []
        self._failover_lock = threading.Lock()
        self._pending: dict[int, dict] = {}
        self._pending_lock = threading.Lock()
        self.last_beat: dict[int, float] = {}
        self._closing = False

        # parent-side control-plane scheduler (admission pump, timers)
        self.scheduler = Scheduler(self.clock)
        self._sched_thread = threading.Thread(
            target=self.scheduler.run_forever, args=(lambda fn: fn(),),
            daemon=True, name="process-backend-scheduler",
        )
        self._sched_thread.start()
        self.admission = FairAdmission(
            self.clock, self.scheduler, window=admission_window
        )

        ctx = mp.get_context("spawn")
        self._workers: dict[int, _Worker] = {}
        shards_of = {
            wid: [s for s in range(num_shards) if s % self.num_workers == wid]
            for wid in range(self.num_workers)
        }
        for wid in range(self.num_workers):
            cmd_parent, cmd_child = ctx.Pipe(duplex=False)
            evt_parent, evt_child = ctx.Pipe(duplex=False)
            # cmd flows parent -> worker, evt flows worker -> parent
            proc = ctx.Process(
                target=_worker_main,
                args=(wid, shards_of[wid], num_shards, self._options,
                      cmd_parent, evt_child),
                daemon=True,
                name=f"repro-worker-{wid}",
            )
            # NB: Pipe(duplex=False) returns (recv_end, send_end); the
            # worker receives commands on cmd_parent and sends events on
            # evt_child, so the parent keeps cmd_child (send) + evt_parent
            # (recv)
            proc.start()
            cmd_parent.close()
            evt_child.close()
            self._workers[wid] = _Worker(wid, proc, cmd_child, evt_parent)
        self._hello = {wid: threading.Event() for wid in self._workers}
        for worker in self._workers.values():
            worker.reader = threading.Thread(
                target=self._reader_loop, args=(worker,), daemon=True,
                name=f"process-backend-reader-{worker.worker_id}",
            )
            worker.reader.start()
        deadline = time.time() + start_timeout
        for wid, ev in self._hello.items():
            if not ev.wait(max(0.0, deadline - time.time())):
                self.shutdown()
                raise RuntimeError(f"worker {wid} failed to start")
        self._monitor_stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="process-backend-monitor",
        )
        self._monitor.start()

    # ------------------------------------------------------------ transport
    def _send_to(self, wid: int, msg: dict) -> None:
        worker = self._workers[wid]
        payload = _encode(msg)
        with worker.send_lock:
            worker.cmd.send_bytes(payload)

    def _send_routed(self, shard: int, msg: dict, tries: int = 100) -> int:
        """Send to the shard's current owner, riding out a failover."""
        for _ in range(tries):
            with self._route_lock:
                wid = self._shard_owner[shard]
            msg["shard"] = shard
            try:
                self._send_to(wid, msg)
                return wid
            except OSError:
                time.sleep(0.05)  # owner mid-death: wait for re-homing
        raise RuntimeError(f"no live owner for shard {shard}")

    def _request(self, wid: int, msg: dict, timeout: float = 30.0):
        req = self._req.next()
        entry = {"event": threading.Event(), "wid": wid,
                 "ok": False, "value": None, "error": "no reply"}
        with self._pending_lock:
            self._pending[req] = entry
        msg["req"] = req
        try:
            self._send_to(wid, msg)
        except OSError as exc:
            with self._pending_lock:
                self._pending.pop(req, None)
            raise RuntimeError(f"worker {wid} unreachable: {exc}") from exc
        if not entry["event"].wait(timeout):
            with self._pending_lock:
                self._pending.pop(req, None)
            raise RuntimeError(f"worker {wid} did not answer {msg.get('op')!r}")
        if not entry["ok"]:
            raise RuntimeError(
                f"worker {wid} {msg.get('op')!r} failed: {entry['error']}"
            )
        return entry["value"]

    # -------------------------------------------------------- introspection
    def shard_owner(self, shard: int) -> int:
        """The worker id currently hosting ``shard`` (moves on failover)."""
        with self._route_lock:
            return self._shard_owner[shard]

    def worker_pid(self, wid: int) -> int:
        """The OS pid of worker ``wid`` (chaos harnesses kill this)."""
        return self._workers[wid].proc.pid

    # ------------------------------------------------------------ event side
    def _reader_loop(self, worker: _Worker) -> None:
        wid = worker.worker_id
        while True:
            try:
                msg = json.loads(worker.evt.recv_bytes())
            except (EOFError, OSError):
                break
            ev = msg.get("ev")
            if ev == "run_done":
                self._resolve(msg)
            elif ev == "hb":
                self.last_beat[wid] = time.time()
            elif ev == "reply":
                with self._pending_lock:
                    entry = self._pending.pop(msg.get("req"), None)
                if entry is not None:
                    entry["ok"] = bool(msg.get("ok"))
                    entry["value"] = msg.get("value")
                    entry["error"] = msg.get("error", "")
                    entry["event"].set()
            elif ev == "hello":
                self.last_beat[wid] = time.time()
                self._hello[wid].set()
            elif ev == "crashed":
                # informational: the worker is exiting; pid-wait follows
                self.last_beat.pop(wid, None)
        if not self._closing:
            self._worker_lost(wid, "event pipe closed")

    def _resolve(self, payload: dict) -> None:
        """Idempotently fold a terminal report into the parent handle."""
        handle = self._handles.get(payload["run_id"])
        if handle is None:
            return  # a child run or a handle from a previous life
        with handle.lock:
            if handle.status != RUN_ACTIVE:
                return  # duplicate report (re-submit race): first wins
            handle.status = payload.get("status", "FAILED")
            handle.error = payload.get("error")
            handle.context = payload.get("context")
            handle.current_state = payload.get("current_state")
            handle.completion_time = payload.get("completion_time")
            callbacks = list(handle.completion_callbacks)
        handle.done.set()
        for cb in callbacks:
            cb(handle)

    # ------------------------------------------------------------ supervision
    def _monitor_loop(self) -> None:
        poll = max(0.05, self.heartbeat_interval / 2.0)
        while not self._monitor_stop.wait(poll):
            now = time.time()
            if self.chaos is not None:
                self._fire_chaos(now)
            for wid, worker in list(self._workers.items()):
                if wid in self.dead_workers or self._closing:
                    continue
                if not worker.proc.is_alive():
                    self._worker_lost(wid, "process exited (pid-wait)")
                elif now - self.last_beat.get(wid, now) > self.heartbeat_timeout:
                    self._worker_lost(wid, "heartbeat silence")

    def _fire_chaos(self, now: float) -> None:
        for plan in self.chaos.kills:
            if plan.executed or plan.mode != "sigkill" or now < plan.at:
                continue
            plan.executed = True
            with self._route_lock:
                wid = self._shard_owner.get(plan.shard_id)
            if wid is None or wid in self.dead_workers:
                continue
            self.chaos._record("kill", f"worker{wid}", "sigkill")
            try:
                os.kill(self._workers[wid].proc.pid, signal.SIGKILL)
            except (OSError, TypeError):
                pass  # already gone

    def _worker_lost(self, wid: int, reason: str) -> None:
        """Fence -> replay -> re-home a dead worker's shards (the journal's failover)."""
        with self._failover_lock:
            if wid in self.dead_workers or self._closing:
                return
            detected_at = time.time()
            self.dead_workers.add(wid)
            worker = self._workers[wid]
            # make death final before adopting segments: a half-dead
            # victim must not keep appending behind the successor's epoch
            try:
                worker.proc.kill()
                worker.proc.join(5.0)
            except (OSError, AssertionError):
                pass
            # fail requests still waiting on the victim
            with self._pending_lock:
                stale = [e for e in self._pending.values() if e["wid"] == wid]
            for entry in stale:
                entry["error"] = f"worker {wid} died"
                entry["event"].set()

            orphans = sorted(
                s for s, owner in self._shard_owner.items() if owner == wid
            )
            by_successor: dict[int, list[int]] = {}
            with self._route_lock:
                for shard in orphans:
                    successor = survivor_index(
                        f"shard{shard}", self.num_workers, self.dead_workers
                    )
                    self._shard_owner[shard] = successor
                    by_successor.setdefault(successor, []).append(shard)

            resumed: set[str] = set()
            terminal: dict[str, dict] = {}
            for successor, shards in sorted(by_successor.items()):
                value = self._request(
                    successor,
                    {"op": "takeover", "shards": shards,
                     "reason": f"worker {wid} {reason}"},
                    timeout=60.0,
                )
                resumed.update(value.get("resumed", ()))
                terminal.update(value.get("terminal", {}))

            # terminal-in-segment runs whose run_done was lost with the
            # victim resolve from the replay; still-missing ACTIVE runs
            # were never journaled — re-submit them to the new owner
            # (the worker dedups by run id: exactly-once)
            for run_id, payload in terminal.items():
                payload = dict(payload, run_id=run_id)
                self._resolve(payload)
            with self._handles_lock:
                snapshot = list(self._handles.values())
            resubmitted = 0
            for handle in snapshot:
                if handle.shard not in orphans:
                    continue
                with handle.lock:
                    pending = (
                        handle.status == RUN_ACTIVE
                        and not handle.deferred
                        and handle.run_id not in resumed
                        and handle.run_id not in terminal
                    )
                if pending:
                    self._submit(handle)
                    resubmitted += 1
            self.failovers.append({
                "worker": wid,
                "shards": orphans,
                "reason": reason,
                "detected_at": detected_at,
                "completed_at": time.time(),
                "takeover_s": time.time() - detected_at,
                "runs_resumed": len(resumed),
                "terminal_resolved": len(terminal),
                "resubmitted": resubmitted,
            })

    # ------------------------------------------------------------ flow plane
    def publish_flow_definition(self, flow_id: str, definition: dict) -> None:
        """Record + broadcast a flow definition (the publish message)."""
        with self._flows_lock:
            self._flow_defs[flow_id] = definition
        msg = {"op": "publish", "flow_id": flow_id, "definition": definition}
        for wid, worker in self._workers.items():
            if wid in self.dead_workers:
                continue
            try:
                self._send_to(wid, msg)
            except OSError:
                pass  # dying worker: failover republishes nothing it needs

    def _ensure_published(self, flow_id: str, flow: asl.Flow) -> None:
        with self._flows_lock:
            known = flow_id in self._flow_defs
        if not known:
            definition = getattr(flow, "definition", None) or {}
            if not definition:
                raise ValueError(
                    f"flow {flow_id!r} has no definition document; the "
                    "process backend ships flows as plain ASL, not objects"
                )
            self.publish_flow_definition(flow_id, definition)

    # ------------------------------------------------------------- run API
    def _submit(self, handle: _RunHandle) -> None:
        self._send_routed(handle.shard, {
            "op": "submit",
            "run_id": handle.run_id,
            "flow_id": handle.flow_id,
            "input": handle.input,
            "creator": handle.creator,
            "label": handle.label,
            "seq": handle.seq,
            "tenant": handle.tenant_id,
        })

    def start_run(self, flow: asl.Flow, flow_input, **kwargs) -> _RunHandle:
        run_id = kwargs.pop("run_id", None) or "run-" + secrets.token_hex(8)
        flow_id = kwargs.pop("flow_id", "flow")
        tenant: Tenant | None = kwargs.pop("tenant", None)
        caller = kwargs.pop("caller", None)
        kwargs.pop("run_as", None)  # tokens NEVER cross the boundary
        if tenant is None and caller is not None:
            tenant = getattr(caller, "tenant", None)
        tenant_id = kwargs.pop("tenant_id", None) or (
            tenant.tenant_id if tenant is not None else None
        )
        creator = kwargs.pop("creator", None)
        if creator is None and caller is not None:
            creator = getattr(caller, "username", None)
        self._ensure_published(flow_id, flow)
        handle = _RunHandle(
            run_id,
            flow_id,
            shard_index(run_id, self.num_shards),
            creator=creator or "anonymous",
            label=kwargs.pop("label", ""),
            seq=self._seq.next(),
            tenant_id=tenant_id,
            tags=kwargs.pop("tags", None),
            monitor_by=kwargs.pop("monitor_by", None),
            manage_by=kwargs.pop("manage_by", None),
            flow_input=flow_input,
            start_time=self.clock.now(),
        )
        with self._handles_lock:
            if handle.run_id in self._handles:
                raise ValueError(f"duplicate run id {run_id!r}")
            self._handles[handle.run_id] = handle
        if tenant is None:
            self._submit(handle)  # unmetered fast path
            return handle
        if self.admission.admit_now(tenant):
            self.admission.attach(tenant, handle)
            self._submit(handle)
            return handle
        handle.deferred = True

        def release(h=handle):
            with h.lock:
                if h.status != RUN_ACTIVE:
                    return  # cancelled while parked
                h.deferred = False
            self._submit(h)

        self.admission.enqueue(tenant, handle, release)
        return handle

    def get_run(self, run_id: str) -> _RunHandle:
        handle = self._handles.get(run_id)
        if handle is None:
            raise NotFound(f"unknown run {run_id!r}")
        return handle

    peek_run = get_run

    def run_status(self, run_id: str) -> dict:
        handle = self.get_run(run_id)
        with handle.lock:
            local = handle.status != RUN_ACTIVE or handle.deferred
        if not local:
            try:
                return self._request(
                    self._shard_owner[handle.shard],
                    {"op": "status", "run_id": run_id, "shard": handle.shard},
                    timeout=10.0,
                )
            except (RuntimeError, KeyError):
                pass  # worker mid-failover: the mirror is still truthful
        return handle.as_status()

    def cancel_run(self, run_id: str) -> _RunHandle:
        handle = self.get_run(run_id)
        with handle.lock:
            if handle.status != RUN_ACTIVE:
                return handle
            handle.cancel_requested = True
            parked = handle.deferred
            if parked:
                handle.status = RUN_CANCELLED
                handle.completion_time = self.clock.now()
            callbacks = list(handle.completion_callbacks) if parked else []
        if parked:
            handle.done.set()
            for cb in callbacks:
                cb(handle)
            return handle
        try:
            self._send_routed(handle.shard,
                              {"op": "cancel", "run_id": run_id})
        except RuntimeError:
            pass  # every owner dead; shutdown path
        return handle

    def wait(self, run_id: str, timeout: float | None = None) -> _RunHandle:
        handle = self.get_run(run_id)
        handle.done.wait(timeout)
        return handle

    def wake_run(self, run_id: str) -> bool:
        handle = self._handles.get(run_id)
        if handle is None:
            return False
        return bool(self._request(
            self._shard_owner[handle.shard],
            {"op": "wake", "run_id": run_id, "shard": handle.shard},
            timeout=10.0,
        ))

    # ---------------------------------------------------------- aggregation
    @property
    def runs(self) -> dict[str, _RunHandle]:
        with self._handles_lock:
            handles = sorted(
                self._handles.values(),
                key=lambda h: (h.seq, h.start_time, h.run_id),
            )
        return {h.run_id: h for h in handles}

    def dormant_stubs(self) -> list:
        return []  # passivation is inline-only

    @property
    def dormant(self) -> dict:
        return {}

    @property
    def stats(self) -> dict[str, int]:
        totals: dict[str, int] = {}
        for wid in list(self._workers):
            if wid in self.dead_workers:
                continue
            try:
                worker_stats = self._request(wid, {"op": "stats"}, timeout=10.0)
            except RuntimeError:
                continue
            for key, value in worker_stats.items():
                totals[key] = totals.get(key, 0) + value
        for key, value in self.admission.stats.items():
            totals[f"admission_{key}"] = value
        return totals

    def compact(self) -> list[dict]:
        summaries: list[dict] = []
        for wid in sorted(self._workers):
            if wid in self.dead_workers:
                continue
            summaries.extend(self._request(wid, {"op": "compact"},
                                           timeout=60.0))
        return summaries

    # ------------------------------------------------------------- recovery
    def recover(self, flows_by_id: dict[str, asl.Flow],
                resume: bool = True) -> list[_RunHandle]:
        for flow_id, flow in flows_by_id.items():
            self._ensure_published(flow_id, flow)
        recovered: list[_RunHandle] = []
        for wid in sorted(self._workers):
            if wid in self.dead_workers:
                continue
            value = self._request(wid, {"op": "recover", "resume": resume},
                                  timeout=120.0)
            for info in value.get("resumed", ()):
                handle = _RunHandle(
                    info["run_id"], info["flow_id"], info["shard"],
                    creator=info.get("creator", "anonymous"),
                    label=info.get("label", ""),
                    seq=info.get("seq", 0),
                    tenant_id=info.get("tenant"),
                    start_time=self.clock.now(),
                )
                with self._handles_lock:
                    existing = self._handles.setdefault(handle.run_id, handle)
                if existing is handle:
                    recovered.append(handle)
        return recovered

    # ------------------------------------------------------------- teardown
    def shutdown(self) -> None:
        self._closing = True
        stop = getattr(self, "_monitor_stop", None)
        if stop is not None:
            stop.set()
        for worker in self._workers.values():
            try:
                self._send_to(worker.worker_id, {"op": "shutdown"})
            except OSError:
                pass
        for worker in self._workers.values():
            worker.proc.join(5.0)
            if worker.proc.is_alive():
                worker.proc.kill()
                worker.proc.join(5.0)
            for conn in (worker.cmd, worker.evt):
                try:
                    conn.close()
                except OSError:
                    pass
        self.scheduler.stop()
        if self._owned_dir is not None:
            import shutil

            shutil.rmtree(self._owned_dir, ignore_errors=True)
