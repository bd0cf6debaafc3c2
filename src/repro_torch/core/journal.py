"""Write-ahead journal: durable run state + crash recovery.

The paper outsources durability to AWS (Step Functions keeps the state
machine's execution state; SQS persists in-flight work).  Offline, the same
guarantee — *a flow run survives the failure of the machinery executing it* —
is provided by journaling every run-state transition to an append-only JSONL
file before acting on it.  ``FlowEngine.recover()`` replays the journal,
rebuilds each unfinished run at its last recorded state, and resumes it.

Replay safety: action starts are journaled with the idempotency
``request_id`` that providers deduplicate on, so a crash between "journal
action_started" and "provider run()" resolves to at-least-once dispatch with
exactly-once effect for providers that survived (and clean re-execution for
in-process providers that did not — the paper's model, where re-running an
idempotent action is the recovery path).

Two mechanisms keep durability cheap as flows age (see docs/durability.md):

* **Group commit** — concurrent ``append()`` callers enqueue records and
  block on a commit ticket; one caller becomes the batch *leader* and
  performs a single write+flush+fsync for everything queued, so N concurrent
  transitions pay ~1 durability round trip instead of N serialized ones.
  The write-ahead invariant is untouched: ``append()`` returns only after
  the caller's record is durable.
* **Checkpoint compaction** — ``Journal.compact()`` collapses the full
  append-only history into one ``checkpoint`` record (live run images,
  trigger images + ack-progress, service counters) written to a fresh
  segment *generation* and atomically swapped over the old file, so
  ``recover()`` replays one checkpoint plus the post-checkpoint tail:
  recovery cost is O(live state), not O(history).
"""

from __future__ import annotations

import copy
import io
import json
import os
import threading
import time
from typing import Any, Callable, Iterator

from . import jsonpath


def segment_path(base_path: str, index: int, num_shards: int) -> str:
    """Per-shard journal segment file name.

    ``journal.jsonl`` with 4 shards becomes ``journal.shard0-of4.jsonl`` ...
    ``journal.shard3-of4.jsonl``.  The shard count is part of the name so a
    pool restarted with a different count opens fresh segments and recovers
    nothing, instead of silently recovering a partial, misrouted view —
    restart with the original count (visible in the segment file names) to
    recover.
    """
    root, ext = os.path.splitext(base_path)
    return f"{root}.shard{index}-of{num_shards}{ext}"


class SimulatedCrash(RuntimeError):
    """Raised by a fault hook to simulate the process dying at a kill point.

    Crash-point injection tests install a :class:`Journal` ``fault_hook``
    that raises this between batch write, flush, and fsync; the journal
    poisons itself (every later ``append`` raises :class:`JournalCrashed`,
    like a dead process), and the test recovers from the on-disk segment
    with a fresh journal.
    """


class JournalCrashed(RuntimeError):
    """The journal's committer died; no further appends are possible."""


class JournalFenced(RuntimeError):
    """The journal was fenced by a failover takeover; appends are rejected.

    When the :class:`~repro.core.supervisor.ShardSupervisor` declares a
    shard dead it calls :meth:`Journal.fence` on the victim's segment
    *before* re-homing its runs.  A zombie worker thread that wakes up
    later and tries to append sees this error instead of silently writing
    into a segment whose runs now live (and journal) elsewhere — the
    classic split-brain append is structurally impossible.
    """


class GroupCommitter:
    """Leader-based group commit: coalesce concurrent durability requests.

    Callers ``submit()`` an item (getting a monotonically increasing ticket)
    and then ``commit(ticket)``.  The first committer to arrive becomes the
    *leader*: it drains everything submitted so far and hands the batch to
    ``flush`` in one call; every waiter whose ticket the batch covers is
    released when the flush returns.  Waiters that arrive while a flush is
    in flight queue up for the next batch — under concurrency the flush cost
    (fsync, network RTT, snapshot write) is amortized across all of them,
    while a lone caller pays exactly one flush with no added latency.

    ``poison_on_error=True`` (write-ahead-log semantics): a flush failure is
    fatal — dropping a batch while later batches commit would tear a hole in
    the log's prefix, so every subsequent commit raises
    :class:`JournalCrashed`.  ``poison_on_error=False`` (snapshot
    semantics, used by :class:`~repro.core.queues.QueueService`
    persistence): the failed batch's waiters see the error, later commits
    retry fresh — safe because each flush rewrites the full snapshot.
    """

    def __init__(
        self,
        flush: Callable[[list[Any]], None],
        poison_on_error: bool = True,
    ):
        self._flush = flush
        self._poison_on_error = poison_on_error
        self._cv = threading.Condition()
        self._pending: list[Any] = []
        self._next_ticket = 0
        self._durable = -1  # highest ticket whose batch has been flushed
        self._leader_active = False
        self._poison: BaseException | None = None
        # non-poisoning mode: tickets <= _failed_hi (and > _durable) failed
        self._failed_hi = -1
        self._failed_exc: BaseException | None = None
        #: flush calls performed (vs tickets issued = amortization ratio)
        self.flushes = 0

    def submit(self, item: Any) -> int:
        with self._cv:
            if self._poison is not None:
                raise JournalCrashed("committer is poisoned") from self._poison
            ticket = self._next_ticket
            self._next_ticket += 1
            self._pending.append(item)
            return ticket

    def commit(self, ticket: int) -> None:
        """Block until the batch containing ``ticket`` is flushed."""
        while True:
            with self._cv:
                if self._poison is not None:
                    raise JournalCrashed(
                        "committer is poisoned"
                    ) from self._poison
                if self._durable >= ticket:
                    return
                if ticket <= self._failed_hi:
                    raise RuntimeError(
                        "group commit flush failed for this batch"
                    ) from self._failed_exc
                if self._leader_active:
                    # a leader is flushing (our ticket may be in its batch,
                    # or we queue for the next); wait and re-check
                    self._cv.wait()
                    continue
                self._leader_active = True
                batch = self._pending
                self._pending = []
                hi = self._next_ticket - 1
            try:
                if batch:
                    self._flush(batch)
            except BaseException as exc:
                with self._cv:
                    if self._poison_on_error:
                        self._poison = exc
                    else:
                        self._failed_hi = hi
                        self._failed_exc = exc
                    self._leader_active = False
                    self._cv.notify_all()
                raise
            with self._cv:
                self.flushes += 1
                self._durable = hi
                self._leader_active = False
                self._cv.notify_all()

    def append_and_commit(self, item: Any) -> None:
        self.commit(self.submit(item))

    def run_exclusive(self, fn: Callable[[list[Any]], None]) -> None:
        """Run ``fn(pending_batch)`` with the leader slot held.

        Used for maintenance that must not race a flush (checkpoint
        compaction swaps the underlying file).  ``fn`` receives everything
        submitted-but-unflushed and is responsible for making it durable;
        when it returns, those tickets are marked durable.

        Unlike a flush failure — which tears a hole in the log and poisons
        the committer — a failed ``fn`` must leave the underlying log
        intact (compaction guarantees this: a checkpoint that fails to
        write never replaces the old segment), so the error propagates to
        the drained batch's waiters (conservative: their records may in
        fact be durable, which is replay-safe) and later commits proceed.
        """
        while True:
            with self._cv:
                if self._poison is not None:
                    raise JournalCrashed(
                        "committer is poisoned"
                    ) from self._poison
                if self._leader_active:
                    self._cv.wait()
                    continue
                self._leader_active = True
                batch = self._pending
                self._pending = []
                hi = self._next_ticket - 1
            try:
                fn(batch)
            except BaseException as exc:
                with self._cv:
                    self._failed_hi = hi
                    self._failed_exc = exc
                    self._leader_active = False
                    self._cv.notify_all()
                raise
            with self._cv:
                self._durable = hi
                self._leader_active = False
                self._cv.notify_all()
            return


class Journal:
    """Append-only JSONL journal.  ``path=None`` keeps records in memory.

    ``latency_s`` simulates the durability round trip the paper's engine
    pays on every transition (Step Functions persists execution state and
    SQS persists in-flight work across a network hop).  Under group commit
    the round trip is paid once per *batch*: concurrent appenders share one
    flush, which is exactly the amortization ``benchmarks/shard_scaling.py``
    measures on its group-commit axis.  ``group_commit=False`` restores the
    old serialized write+flush+fsync per append under one lock (kept as the
    benchmark baseline).

    ``fault_hook(phase, batch)`` — when set, called at each kill point of a
    batch commit (``"pre-write"``, ``"post-write"``, ``"post-flush"``,
    ``"post-fsync"``); raising :class:`SimulatedCrash` from the hook
    poisons the journal, simulating a crash at that boundary.

    ``compact_every=N`` auto-compacts once more than ``N`` records have
    accumulated since the last checkpoint (see :meth:`compact`).
    """

    def __init__(
        self,
        path: str | None = None,
        fsync: bool = False,
        latency_s: float = 0.0,
        group_commit: bool = True,
        fault_hook: Callable[[str, list[str]], None] | None = None,
        compact_every: int | None = None,
    ):
        self.path = path
        self.fsync = fsync
        self.latency_s = latency_s
        self.group_commit = group_commit
        self.fault_hook = fault_hook
        self.compact_every = compact_every
        self._lock = threading.RLock()  # serialized mode + fh lifecycle
        self._memory: list[dict] = []
        self._fh: io.TextIOBase | None = None
        #: checkpoint generation of the current segment (0 = never compacted)
        self.generation = 0
        #: fencing epoch of the current segment (0 = never failed over);
        #: bumped by each failover takeover via :meth:`bump_epoch`
        self.epoch = 0
        #: non-None once :meth:`fence` was called; every later append raises
        #: :class:`JournalFenced` with this reason
        self.fenced: str | None = None
        #: records appended since the last checkpoint (compaction trigger)
        self._since_checkpoint = 0
        #: one auto-compaction at a time (concurrent appenders all cross the
        #: threshold together; only one should pay for the swap)
        self._auto_compacting = False
        #: last auto-compaction failure, if any (auto-compaction is
        #: best-effort: it must never fail the append that triggered it)
        self.last_compact_error: Exception | None = None
        #: byte offset (file) / index (memory) where the next record lands,
        #: and the per-append offset handoff (see :meth:`append`)
        self._pos = 0
        self._offsets: dict[int, int] = {}
        #: pid that opened the current append handle.  File handles are
        #: opened lazily in the *owning* process (first append wins): a
        #: Journal constructed before a spawn/fork must not ship an fd —
        #: or a shared flock — into the child, and a handle inherited
        #: across fork is abandoned (never close()d, which would re-flush
        #: the parent's buffered data) and reopened under the child's pid.
        self._fh_pid: int | None = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            if os.path.exists(path):
                self._scan_existing(path)
                self._pos = os.path.getsize(path)
        self._committer = GroupCommitter(self._flush_batch)

    def _scan_existing(self, path: str) -> None:
        """Open-time repair + bookkeeping for a pre-existing segment.

        Recovers ``generation`` and the post-checkpoint tail length, and
        **truncates a torn tail**: a crash between batch write and flush can
        leave a partial final line, and appending after it would glue new
        records onto the tear, making them unreadable.  Everything from the
        first incomplete/undecodable line onward is untrusted (replay stops
        there anyway), so the journal seals the segment back to its last
        durable record before appending.
        """
        good_end = 0
        with open(path, "rb") as fh:
            for raw in fh:
                if not raw.endswith(b"\n"):
                    break  # torn tail: unterminated final line
                stripped = raw.strip()
                if stripped:
                    try:
                        rec = json.loads(stripped)
                    except ValueError:
                        break  # torn/corrupt: nothing past here is trusted
                    if rec.get("type") == "checkpoint":
                        self.generation = rec.get("generation", self.generation)
                        self.epoch = rec.get("epoch", self.epoch)
                        self._since_checkpoint = 0
                    else:
                        if rec.get("type") == "epoch":
                            self.epoch = rec.get("epoch", self.epoch)
                        self._since_checkpoint += 1
                good_end += len(raw)
        if good_end < os.path.getsize(path):
            with open(path, "rb+") as fh:
                fh.truncate(good_end)

    # ------------------------------------------------------------------ append
    def append(self, record: dict) -> int | None:
        """Write-ahead append: returns only once ``record`` is durable.

        Returns the record's position in the current segment — a byte
        offset for file journals, a list index for in-memory ones — valid
        until the next compaction (callers must pair it with
        :attr:`generation` and treat a generation mismatch as stale; see
        :meth:`record_at`).  Run passivation uses this as a page-table
        entry: rehydrating a dormant run seeks straight to its
        ``run_passivated`` record instead of replaying the segment.
        """
        if self.fenced is not None:
            raise JournalFenced(self.fenced)
        line = json.dumps(record, separators=(",", ":"), default=_jsonable)
        try:
            if self.group_commit:
                self._committer.append_and_commit(line)
            else:
                # serialized baseline: one durability round trip per record,
                # taken while holding the journal lock
                with self._lock:
                    self._flush_batch([line])
        finally:
            # the leader that flushed our batch parked our offset under this
            # exact string object's id; claim it (pop even on failure so the
            # handoff dict cannot leak entries for poisoned appends)
            offset = self._offsets.pop(id(line), None)
        if (
            self.compact_every is not None
            and self._since_checkpoint > self.compact_every
        ):
            self._maybe_auto_compact()
        return offset

    def _maybe_auto_compact(self) -> None:
        with self._lock:
            if self._auto_compacting:
                return
            self._auto_compacting = True
        try:
            # recheck under the flag: a just-finished compaction may have
            # already reset the tail counter
            if self._since_checkpoint > self.compact_every:
                self.compact()
        except Exception as exc:
            # best-effort: the append that triggered us already committed
            # durably, and a failed compaction leaves the old segment
            # intact — record the error and retry at the next threshold
            # crossing instead of failing a successful append
            self.last_compact_error = exc
        finally:
            with self._lock:
                self._auto_compacting = False

    def _hook(self, phase: str, batch: list[str]) -> None:
        if self.fault_hook is not None:
            self.fault_hook(phase, batch)

    def _flush_batch(self, lines: list[str]) -> None:
        """One durable commit for a whole batch (the group-commit payoff)."""
        if self.fenced is not None:
            # a batch that raced the fence (submitted before, flushed after)
            # dies here; the committer poisons itself, which is exactly
            # right — the segment belongs to the takeover journal now
            raise JournalFenced(self.fenced)
        self._hook("pre-write", lines)
        if self.latency_s:
            time.sleep(self.latency_s)  # one simulated RTT per batch
        if self.path is not None:
            fh = self._ensure_fh()
            # park each record's byte offset for its append() caller, keyed
            # by the submitted string object's identity (unique while the
            # caller holds the reference).  json.dumps emits ASCII
            # (ensure_ascii), so byte length == len(line) + newline.
            base = self._pos
            for line in lines:
                self._offsets[id(line)] = base
                base += len(line) + 1
            fh.write("".join(line + "\n" for line in lines))
            self._pos = base
            self._hook("post-write", lines)
            fh.flush()
            self._hook("post-flush", lines)
            if self.fsync:
                os.fsync(fh.fileno())
        else:
            base = len(self._memory)
            for i, line in enumerate(lines):
                self._offsets[id(line)] = base + i
            self._memory.extend(json.loads(line) for line in lines)
            self._hook("post-write", lines)
            self._hook("post-flush", lines)
        self._hook("post-fsync", lines)
        self._since_checkpoint += len(lines)

    def record_at(self, offset: int) -> dict | None:
        """Decode the single record at ``offset`` (from :meth:`append`).

        Returns ``None`` when the offset no longer addresses a complete
        record — a compaction rewrote the segment, the tail is torn, or the
        position is simply out of range.  Callers are expected to have
        checked :attr:`generation` against the generation captured alongside
        the offset and to fall back to :func:`replay_segment` on ``None``.
        """
        if self.path is None:
            with self._lock:
                if 0 <= offset < len(self._memory):
                    return self._memory[offset]
            return None
        try:
            with open(self.path, "rb") as fh:
                fh.seek(offset)
                raw = fh.readline()
        except OSError:
            return None
        if not raw.endswith(b"\n"):
            return None  # torn or truncated: not a durable record
        try:
            return json.loads(raw)
        except ValueError:
            return None

    # ------------------------------------------------------------------ read
    def records(self) -> Iterator[dict]:
        """Committed records in append order (checkpoint first, if any).

        Every record whose ``append()`` returned is visible: group commit
        flushes each batch before releasing its waiters, so no reader-side
        flush is needed.  A torn trailing line (crash between write and
        flush/fsync) terminates the iteration — everything after the first
        undecodable line is a suspect partial write, never silently skipped
        past.
        """
        if self.path is None:
            with self._lock:
                yield from list(self._memory)
            return
        yield from _read_records(self.path)

    def _ensure_fh(self) -> io.TextIOBase:
        """Return the append handle, opening it lazily in *this* process.

        A handle opened by another pid (inherited across fork) is abandoned
        and replaced: closing it here would flush the parent's buffered
        data from the child, and sharing it would interleave two processes'
        buffered writes into the segment.  ``_pos`` is re-read from disk on
        every (re)open so offsets stay byte-accurate.
        """
        fh = self._fh
        if fh is not None and self._fh_pid == os.getpid():
            return fh
        with self._lock:
            fh = self._fh
            if fh is not None and self._fh_pid == os.getpid():
                return fh
            assert self.path is not None
            self._fh = open(self.path, "a", encoding="utf-8")
            self._fh_pid = os.getpid()
            self._pos = os.path.getsize(self.path)
            return self._fh

    def _drop_fh(self) -> None:
        """Forget the append handle (caller holds ``_lock``).

        Only the pid that opened the handle may close it — a handle
        inherited across fork is dropped without close so the child never
        flushes the parent's buffer.
        """
        fh, owner = self._fh, self._fh_pid
        self._fh = None
        self._fh_pid = None
        if fh is not None and owner == os.getpid():
            fh.close()

    def close(self) -> None:
        with self._lock:
            self._drop_fh()

    # --------------------------------------------------------------- fencing
    def fence(self, reason: str = "journal fenced by failover") -> None:
        """Reject every subsequent append with :class:`JournalFenced`.

        Idempotent.  Called on a dead shard's segment before its runs are
        re-homed, so a zombie worker's late appends are provably rejected
        instead of corrupting state the takeover journal now owns.
        """
        with self._lock:
            if self.fenced is None:
                self.fenced = reason

    def bump_epoch(self, reason: str = "") -> int:
        """Journal a new fencing epoch for this segment and return it.

        The epoch record is ordinary (durable, replayed, checkpointed), so
        any reader of the segment — online takeover or cold recovery — sees
        the highest epoch and can reject state stamped with an older one.
        """
        new_epoch = self.epoch + 1
        self.append(
            {"type": "epoch", "epoch": new_epoch, "reason": reason,
             "t": time.time()}
        )
        self.epoch = new_epoch
        return new_epoch

    def takeover(self, reason: str = "shard failover") -> "Journal":
        """Fence this journal and return a successor for the same segment.

        The successor owns the segment under epoch ``+1`` (journaled as its
        first record): file journals are reopened from disk (sealing any
        torn tail the dead worker left), in-memory journals share the same
        record list.  The fenced predecessor keeps serving reads
        (:meth:`records`, :meth:`record_at`) but every append on it raises
        :class:`JournalFenced`.
        """
        self.fence(reason)
        successor = Journal.__new__(Journal)
        successor.path = self.path
        successor.fsync = self.fsync
        successor.latency_s = self.latency_s
        successor.group_commit = self.group_commit
        successor.fault_hook = None  # faults targeted the dead shard
        successor.compact_every = self.compact_every
        successor._lock = threading.RLock()
        successor._memory = self._memory  # shared for in-memory journals
        successor._fh = None
        successor.generation = self.generation
        successor.epoch = self.epoch
        successor.fenced = None
        successor._since_checkpoint = self._since_checkpoint
        successor._auto_compacting = False
        successor.last_compact_error = None
        successor._pos = len(self._memory)
        successor._offsets = {}
        successor._fh_pid = None
        if self.path is not None:
            self.close()  # release the dead shard's append handle
            successor.generation = 0
            successor.epoch = 0
            successor._since_checkpoint = 0
            if os.path.exists(self.path):
                successor._scan_existing(self.path)
                successor._pos = os.path.getsize(self.path)
            else:
                successor._pos = 0
        successor._committer = GroupCommitter(successor._flush_batch)
        successor.bump_epoch(reason)
        return successor

    # ------------------------------------------------------------- compaction
    def compact(self, counters: dict | None = None) -> dict:
        """Collapse history into one checkpoint record (generation swap).

        Replays the current segment into live images — unfinished
        :class:`RunImage` s, every :class:`TriggerImage` with its
        ack-progress — writes a single ``checkpoint`` record to a fresh
        ``<path>.gen<N>.tmp``, fsyncs it, and atomically ``os.replace`` s it
        over the segment.  Terminal runs are dropped: ``recover()`` never
        resumes them, so they are dead weight the checkpoint sheds.

        Because the checkpoint is *defined* as the replay of the history it
        replaces, recovery after compaction is equivalent by construction to
        recovery from the full history (tested in
        tests/core/test_compaction.py).

        ``counters`` snapshots service counters (e.g. ``FlowEngine.stats``)
        into the checkpoint; when omitted, the previous checkpoint's
        counters are carried forward.  Returns a summary dict.
        """
        summary: dict = {}

        def do(batch: list[str]) -> None:
            # flush anything queued behind us into the OLD segment first, so
            # the replay below sees it (their waiters are released when
            # run_exclusive marks them durable)
            if batch:
                self._flush_batch(batch)
            view = replay_segment(self)  # one decode pass feeds everything
            live_runs = [
                image.to_state()
                for image in view.runs.values()
                if image.status == "ACTIVE"
            ]
            checkpoint = {
                "type": "checkpoint",
                "generation": self.generation + 1,
                "epoch": self.epoch,
                "runs": live_runs,
                "triggers": [
                    image.to_state() for image in view.triggers.values()
                ],
                "counters": counters if counters is not None else view.counters,
                "t": time.time(),
            }
            line = json.dumps(
                checkpoint, separators=(",", ":"), default=_jsonable
            )
            if self.path is not None:
                # a failure anywhere before os.replace leaves the old
                # segment untouched (the tmp file is scrap); the append
                # handle is reopened even on a failed swap so the journal
                # stays writable either way
                tmp = f"{self.path}.gen{self.generation + 1}.tmp"
                with open(tmp, "w", encoding="utf-8") as fh:
                    fh.write(line + "\n")
                    fh.flush()
                    if self.fsync:
                        os.fsync(fh.fileno())
                with self._lock:
                    self._drop_fh()
                    try:
                        os.replace(tmp, self.path)
                    finally:
                        # next append reopens lazily; only _pos must track
                        # the swapped (or, on failure, surviving) segment
                        self._pos = os.path.getsize(self.path)
                    if self.fsync:
                        _fsync_dir(os.path.dirname(os.path.abspath(self.path)))
            else:
                with self._lock:
                    self._memory = [json.loads(line)]
            self.generation += 1
            self._since_checkpoint = 0
            summary.update(
                generation=self.generation,
                records_before=view.record_count,
                records_after=1,
                live_runs=len(live_runs),
                triggers=len(checkpoint["triggers"]),
                path=self.path,
            )

        if self.group_commit:
            self._committer.run_exclusive(do)
        else:
            # serialized mode: hold the append lock across the whole swap so
            # no append can land on (and be lost with) the old file between
            # the replay and the os.replace; _lock is reentrant for do()'s
            # own acquisitions
            with self._lock:
                do([])
        return summary


def _fsync_dir(dirname: str) -> None:
    """Make a rename durable (best-effort on platforms without dir fds)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform-specific
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _read_records(path: str) -> Iterator[dict]:
    try:
        fh = open(path, encoding="utf-8")
    except FileNotFoundError:
        return
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                # torn tail from a crash mid-write: stop here — later lines
                # (if any) are past the tear and must not be trusted
                return


def _jsonable(obj: Any):
    """Fallback serializer: keep the journal writable no matter the payload."""
    try:
        return dict(obj)
    except Exception:
        return repr(obj)


class RunImage:
    """Reconstructed view of one run from journal records."""

    #: scalar fields that round-trip through a checkpoint record
    _STATE_FIELDS = (
        "run_id", "flow_id", "input", "creator", "label", "status",
        "context", "current_state", "attempt", "seq", "tenant", "error",
        "action_id", "action_provider", "action_request_id",
        "passivated", "wake_time", "passivate_mode",
    )

    def __init__(self, run_id: str):
        self.run_id = run_id
        self.flow_id: str | None = None
        self.input: Any = None
        self.creator: str = "anonymous"
        self.label: str = ""
        self.status: str = "ACTIVE"
        self.context: Any = None
        self.current_state: str | None = None
        self.attempt: int = 0
        #: global submission order (run_created ``seq``; 0 = shard-internal)
        self.seq: int = 0
        #: tenant stamp from run_created (None = unmetered submission)
        self.tenant: str | None = None
        #: terminal error document (run_completed / run_cancelled records)
        self.error: Any = None
        # outstanding action (if the run crashed mid-action)
        self.action_id: str | None = None
        self.action_provider: str | None = None
        self.action_request_id: str | None = None
        # passivation: the run was paged out of the engine while parked in a
        # Wait (mode "wait") or between action polls (mode "action"); it
        # owes a wake-up at ``wake_time``
        self.passivated: bool = False
        self.wake_time: float | None = None
        self.passivate_mode: str | None = None
        self.records: list[dict] = []
        #: False while ``context`` aliases a journal record (copy-on-write:
        #: the first patch deep-copies, so patching never mutates a record
        #: an in-memory journal still holds)
        self._ctx_owned = True

    def to_state(self) -> dict:
        """Checkpoint serialization (the raw record list is history, not
        state — a checkpointed image carries none)."""
        return {name: getattr(self, name) for name in self._STATE_FIELDS}

    @classmethod
    def from_state(cls, state: dict) -> "RunImage":
        image = cls(state["run_id"])
        for name in cls._STATE_FIELDS:
            if name in state:
                setattr(image, name, state[name])
        image._ctx_owned = False
        return image

    def _set_context(self, value: Any) -> None:
        """Adopt a full context from a record (the record keeps ownership)."""
        self.context = value
        self._ctx_owned = False

    def _apply_patch(self, ops: list[dict]) -> None:
        """Apply delta-encoded context ops (see docs/durability.md).

        ``put`` writes a value at a JSONPath, ``replace`` swaps the whole
        context, ``merge`` is the Pass-state root merge.  Values are
        deep-copied on application so replayed state never aliases journal
        records (an in-memory journal hands out the same dicts on every
        ``records()`` pass).
        """
        for op in ops:
            kind = op.get("op")
            if kind == "replace":
                self._set_context(op.get("value"))
                continue
            if not self._ctx_owned:
                self.context = copy.deepcopy(self.context)
                self._ctx_owned = True
            if not isinstance(self.context, dict):
                self.context = {}
            if kind == "put":
                jsonpath.put(
                    self.context, op["path"], copy.deepcopy(op.get("value"))
                )
            elif kind == "merge":
                self.context.update(copy.deepcopy(op.get("value") or {}))

    def _context_from(self, rec: dict) -> None:
        """Update ``context`` from a transition record (full or delta)."""
        if "context" in rec:
            self._set_context(rec["context"])
        elif "context_patch" in rec:
            self._apply_patch(rec["context_patch"])

    def apply(self, rec: dict) -> None:
        self.records.append(rec)
        kind = rec["type"]
        if kind == "run_created":
            self.flow_id = rec.get("flow_id")
            self.input = rec.get("input")
            self.creator = rec.get("creator", "anonymous")
            self.label = rec.get("label", "")
            self.seq = rec.get("seq", 0)
            self.tenant = rec.get("tenant")
            self._set_context(rec.get("input"))
        elif kind == "state_entered":
            self.current_state = rec["state"]
            self.attempt = rec.get("attempt", 0)
            self.action_id = None
            self.action_provider = None
            self.action_request_id = None
            self.passivated = False
            self.wake_time = None
            self.passivate_mode = None
            self._context_from(rec)
        elif kind == "run_snapshot":
            self._context_from(rec)
        elif kind == "run_passivated":
            # page-out image: the run keeps its current state and owes a
            # wake-up; any later state_entered/state_exited (journaled by
            # the rehydrated run) clears the dormant marker
            self.current_state = rec.get("state", self.current_state)
            self.attempt = rec.get("attempt", self.attempt)
            self.passivated = True
            self.wake_time = rec.get("wake_time")
            self.passivate_mode = rec.get("mode", "wait")
            self._context_from(rec)
        elif kind == "action_started":
            self.action_id = rec.get("action_id")
            self.action_provider = rec.get("provider_url")
            self.action_request_id = rec.get("request_id")
        elif kind == "action_completed":
            self.action_id = None
            self.action_provider = None
            self.action_request_id = None
        elif kind == "state_exited":
            self._context_from(rec)
            self.current_state = None
            self.passivated = False
            self.wake_time = None
            self.passivate_mode = None
        elif kind == "run_completed":
            self.status = rec.get("status", "SUCCEEDED")
            self.error = rec.get("error")
            self._context_from(rec)
        elif kind == "run_cancelled":
            self.status = "CANCELLED"
            self.error = rec.get("error")
            self._context_from(rec)
        elif kind == "run_rehomed":
            # the run arrived here from a fenced shard: the record embeds a
            # full image snapshot (identity + context + progress) because
            # this segment has none of the run's earlier history
            state = rec.get("image") or {}
            for name in self._STATE_FIELDS:
                if name in state:
                    setattr(self, name, state[name])
            self._ctx_owned = False
        elif kind == "run_rehomed_out":
            # tombstone on the victim's (taken-over) segment: the live image
            # now journals on rec["to_shard"], so cold recovery of *this*
            # segment must neither resume it nor checkpoint it as live
            self.status = "REHOMED"


class SegmentView:
    """Everything one pass over a segment can reconstruct.

    ``replay`` / ``replay_triggers`` / ``replay_counters`` are narrowing
    views over this; :meth:`Journal.compact` and
    :meth:`~repro.core.engine.FlowEngine.recover` use it directly so a long
    segment is decoded once, not once per view.
    """

    def __init__(self):
        self.runs: dict[str, RunImage] = {}
        self.triggers: dict[str, TriggerImage] = {}
        self.counters: dict = {}
        self.generation = 0
        #: highest fencing epoch seen in the segment (0 = never failed over)
        self.epoch = 0
        self.record_count = 0


def replay_segment(journal: Journal) -> SegmentView:
    """Replay a segment into run images, trigger images, and counters.

    A ``checkpoint`` record *resets* every view to the checkpoint's
    collapsed state — it is the replay of everything before it — and the
    post-checkpoint tail applies on top, so replay cost after compaction is
    O(live state + tail), independent of the collapsed history's length.
    Run records carry ``run_id`` and trigger records carry ``trigger_id``;
    the two views are independent over one shared record stream.
    """
    view = SegmentView()
    for rec in journal.records():
        view.record_count += 1
        if rec.get("type") == "checkpoint":
            view.runs = {
                state["run_id"]: RunImage.from_state(state)
                for state in rec.get("runs", ())
            }
            view.triggers = {
                state["trigger_id"]: TriggerImage.from_state(state)
                for state in rec.get("triggers", ())
            }
            view.counters = rec.get("counters", {}) or {}
            view.generation = rec.get("generation", view.generation)
            view.epoch = rec.get("epoch", view.epoch)
            continue
        if rec.get("type") == "epoch":
            view.epoch = rec.get("epoch", view.epoch)
            continue
        run_id = rec.get("run_id")
        if run_id is not None:
            image = view.runs.get(run_id)
            if image is None:
                image = view.runs[run_id] = RunImage(run_id)
            image.apply(rec)
            continue
        trigger_id = rec.get("trigger_id")
        if trigger_id is not None:
            trig = view.triggers.get(trigger_id)
            if trig is None:
                trig = view.triggers[trigger_id] = TriggerImage(trigger_id)
            trig.apply(rec)
    return view


def replay(journal: Journal) -> dict[str, RunImage]:
    """Group journal records into per-run images (ordered by appearance)."""
    return replay_segment(journal).runs


def replay_counters(journal: Journal) -> tuple[dict, int]:
    """(service counters, generation) from the last checkpoint record.

    Counters are an advisory snapshot taken at compaction time; activity in
    the post-checkpoint tail is not folded in.
    """
    view = replay_segment(journal)
    return view.counters, view.generation


def terminal_map_children(view: SegmentView) -> dict[str, tuple]:
    """Finished Map-item children in a replayed segment.

    Keyed by child run id (``<parent>.m<i>``); each value is
    ``(status, final context, error doc)``.  Cross-shard Map placement means
    a child journals to *its* shard's segment, not its parent's — recovery
    replays each segment independently and
    :meth:`~repro.core.engine.FlowEngine._map_admit` re-attaches these
    results to the recovered parent's join so finished items are not
    re-executed.  Cancelled children are excluded: pre-crash cancellations
    (a fail-fast sweep interrupted mid-flight) must not shadow an item a
    fresh attempt would run normally.
    """
    results: dict[str, tuple] = {}
    for run_id, image in view.runs.items():
        if image.status not in ("SUCCEEDED", "FAILED"):
            continue
        dot = run_id.rfind(".")
        tail = run_id[dot + 1:]
        if dot < 0 or len(tail) < 2 or tail[0] != "m" or not tail[1:].isdigit():
            continue
        results[run_id] = (image.status, image.context, image.error)
    return results


class TriggerImage:
    """Reconstructed view of one trigger from journal records.

    Triggers share the write-ahead journal with runs: ``trigger_created`` /
    ``trigger_enabled`` / ``trigger_disabled`` record the lifecycle, and each
    ``trigger_fired`` records ack-progress — which message ids this trigger
    has already successfully handled — so crash recovery redelivers *only*
    the events that had not yet produced an invocation.
    """

    _STATE_FIELDS = (
        "trigger_id", "queue_id", "predicate", "transform", "action_ref",
        "owner", "enabled", "poll_min_s", "poll_max_s", "batch", "stats",
        "wake_run_key",
    )

    def __init__(self, trigger_id: str):
        self.trigger_id = trigger_id
        self.queue_id: str | None = None
        self.predicate: str = "True"
        self.transform: dict = {}
        self.action_ref: str = ""
        self.owner: str = "anonymous"
        self.enabled: bool = False
        self.poll_min_s: float = 0.5
        self.poll_max_s: float = 30.0
        self.batch: int = 10
        self.stats: dict = {}
        #: when set, matches wake a dormant run instead of invoking an action
        self.wake_run_key: str | None = None
        #: message ids already handled to completion (invoked or discarded)
        self.resolved_message_ids: set[str] = set()
        #: the subset of resolved messages whose disposition was "invoked"
        self.invoked_message_ids: set[str] = set()

    def to_state(self) -> dict:
        state = {name: getattr(self, name) for name in self._STATE_FIELDS}
        state["resolved_message_ids"] = sorted(self.resolved_message_ids)
        state["invoked_message_ids"] = sorted(self.invoked_message_ids)
        return state

    @classmethod
    def from_state(cls, state: dict) -> "TriggerImage":
        image = cls(state["trigger_id"])
        for name in cls._STATE_FIELDS:
            if name in state:
                setattr(image, name, state[name])
        image.resolved_message_ids = set(state.get("resolved_message_ids", ()))
        image.invoked_message_ids = set(state.get("invoked_message_ids", ()))
        return image

    def apply(self, rec: dict) -> None:
        kind = rec["type"]
        if kind == "trigger_created":
            self.queue_id = rec.get("queue_id")
            self.predicate = rec.get("predicate", "True")
            self.transform = rec.get("transform", {})
            self.action_ref = rec.get("action_ref", "")
            self.owner = rec.get("owner", "anonymous")
            self.poll_min_s = rec.get("poll_min_s", 0.5)
            self.poll_max_s = rec.get("poll_max_s", 30.0)
            self.batch = rec.get("batch", 10)
            self.wake_run_key = rec.get("wake_run_key")
        elif kind == "trigger_enabled":
            self.enabled = True
        elif kind == "trigger_disabled":
            self.enabled = False
        elif kind == "trigger_resolved":
            if "stats" in rec:
                self.stats = rec["stats"]
            mid = rec.get("message_id")
            if mid is not None:
                self.resolved_message_ids.add(mid)
                if rec.get("disposition") == "invoked":
                    self.invoked_message_ids.add(mid)
        elif kind == "trigger_rehomed":
            # failover moved this trigger's journal ownership here: the
            # record embeds the full image (lifecycle + ack-progress) as
            # replayed from the fenced shard's segment.  Ack-progress
            # merges — this segment may also hold records of its own.
            state = rec.get("image") or {}
            for name in self._STATE_FIELDS:
                if name in state:
                    setattr(self, name, state[name])
            self.resolved_message_ids |= set(
                state.get("resolved_message_ids", ())
            )
            self.invoked_message_ids |= set(
                state.get("invoked_message_ids", ())
            )


def replay_triggers(journal: Journal) -> dict[str, TriggerImage]:
    """Group journal records into per-trigger images (ordered by appearance).

    Run records carry ``run_id`` and trigger records carry ``trigger_id``, so
    the two replays are independent views over one shared segment.  Like
    :func:`replay`, a ``checkpoint`` record resets the map to its collapsed
    trigger images (lifecycle + ack-progress survive compaction).
    """
    return replay_segment(journal).triggers
