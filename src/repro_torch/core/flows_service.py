"""The Flows service (paper §5.3): publish, discover, invoke, and manage
flows, with role-based access control and auth delegation.

Publish-time behaviour follows §5.3.1: the definition and input schema are
validated; the flow is registered with Auth as its own resource server with a
unique run scope whose *dependent scopes* are the scopes of every action
provider the definition references (discovered by introspection), plus
per-``RunAs``-role scopes; the flow is deployed to the engine and — because
every flow is itself an action provider — exposed behind the AP API so flows
can invoke flows.

Run-time behaviour follows §5.3.2: the caller's identity is checked against
the flow's Starter policy, input is validated against the schema, dependent
tokens for the invoking user (and any RunAs roles) are retrieved and stored
for use when invoking actions, and the state machine is started.

Execution is delegated to an :class:`~repro.core.shard_pool.EngineShardPool`
(``shards=1`` by default): the service is a thin routing front-end — it
publishes and authorizes, the pool hash-routes each run to its owning shard,
and cross-shard views (``list_runs``) aggregate over all shards.  See
docs/ARCHITECTURE.md for the layering contract.
"""

from __future__ import annotations

import secrets
import threading
from dataclasses import dataclass, field

from . import asl, schema as jsonschema
from .actions import (
    FAILED as AP_FAILED,
    SUCCEEDED as AP_SUCCEEDED,
    ActionProvider,
    ActionRegistry,
    _Action,
)
from .auth import AuthContext, AuthService, Identity, principal_matches
from .clock import Clock, RealClock
from .engine import (
    RUN_ACTIVE,
    RUN_SUCCEEDED,
    PollingPolicy,
    Run,
)
from .errors import AutomationError, Forbidden, InputValidationError, NotFound
from .journal import Journal, TriggerImage
from .queues import QueueService
from .backend import make_backend
from .shard_pool import EngineShardPool
from .triggers import EventRouter, Trigger, TriggerConfig


@dataclass
class FlowRecord:
    flow_id: str
    flow: asl.Flow
    input_schema: dict
    title: str
    description: str = ""
    keywords: list[str] = field(default_factory=list)
    owner: str = "anonymous"
    scope: str = ""
    # RBAC principals (user:/group:/public/all_authenticated_users)
    viewers: list[str] = field(default_factory=list)
    starters: list[str] = field(default_factory=list)
    administrators: list[str] = field(default_factory=list)
    runs: list[str] = field(default_factory=list)

    def visible_to(self, identity: Identity | None) -> bool:
        principals = (
            self.viewers + self.starters + self.administrators + [f"user:{self.owner}"]
        )
        return any(principal_matches(identity, p) for p in principals)


class FlowsService:
    def __init__(
        self,
        registry: ActionRegistry,
        clock: Clock | None = None,
        auth: AuthService | None = None,
        journal: Journal | None = None,
        polling: PollingPolicy | None = None,
        max_workers: int = 8,
        shards: int = 1,
        journal_path: str | None = None,
        fsync: bool = False,
        journal_latency_s: float = 0.0,
        group_commit: bool = True,
        compact_every: int | None = None,
        queues: QueueService | None = None,
        delta_journal: bool = True,
        snapshot_every: int = 64,
        passivate_after: float | None = None,
        map_steal_bound: int | None = None,
        admission_window: int | None = None,
        backend: str = "thread",
        backend_options: dict | None = None,
    ):
        self.clock = clock or RealClock()
        self.auth = auth
        self.registry = registry
        if backend != "thread" and queues is not None:
            raise ValueError(
                "queue triggers (EventRouter) require the thread backend; "
                "the process backend has no shared scheduler to route on"
            )
        #: sharded execution layer behind the ExecutionBackend seam;
        #: ``backend="thread"`` (default) is the in-process
        #: thread-per-shard pool, ``backend="process"`` hosts shard groups
        #: in spawned worker processes (``backend_options`` must carry the
        #: worker registry factory spec — see repro.core.process_backend).
        #: ``max_workers`` is the per-shard pool size.  Map fan-outs
        #: spread their item children across all ``shards`` (deterministic
        #: hash placement with a least-loaded override capped by
        #: ``map_steal_bound``); the join stays on the parent's shard —
        #: see repro.core.shard_pool.
        self.engine = make_backend(
            backend,
            registry,
            num_shards=shards,
            clock=self.clock,
            journal=journal,
            journal_path=journal_path,
            fsync=fsync,
            journal_latency_s=journal_latency_s,
            group_commit=group_commit,
            compact_every=compact_every,
            polling=polling,
            max_workers=max_workers,
            delta_journal=delta_journal,
            snapshot_every=snapshot_every,
            passivate_after=passivate_after,
            map_steal_bound=map_steal_bound,
            admission_window=admission_window,
            options=backend_options,
        )
        self._flows: dict[str, FlowRecord] = {}
        self._lock = threading.RLock()
        #: shared event fabric (paper §5.4/§5.5): one EventRouter dispatches
        #: every trigger; trigger records are journaled to the owning shard's
        #: segment (hash-owned by trigger id, like runs by run id), and the
        #: router schedules through the pool so VirtualClock dispatch stays
        #: deterministic at every shard count
        self.queues = queues
        self.router: EventRouter | None = None
        if queues is not None:
            self.router = EventRouter(
                queues,
                clock=self.clock,
                scheduler=self.engine.scheduler,
                journal_for=self.engine.journal_for,
                run_waker=self.engine.wake_run,
                admission=self.engine.admission,
            )
        if auth is not None:
            auth.register_resource_server("flows.repro")
            self.manage_scope = auth.register_scope(
                "flows.repro", "urn:repro:scopes:flows:manage_flows"
            ).urn

    # ------------------------------------------------------------- publishing
    def publish_flow(
        self,
        definition: dict,
        input_schema: dict | None = None,
        title: str = "",
        description: str = "",
        keywords: list[str] | None = None,
        owner: str = "anonymous",
        viewers: list[str] | None = None,
        starters: list[str] | None = None,
        administrators: list[str] | None = None,
        flow_id: str | None = None,
    ) -> FlowRecord:
        flow = asl.parse(definition)  # raises FlowValidationError
        input_schema = input_schema if input_schema is not None else {"type": "object"}
        jsonschema.check_schema(input_schema)
        flow_id = flow_id or "flow-" + secrets.token_hex(8)
        record = FlowRecord(
            flow_id=flow_id,
            flow=flow,
            input_schema=input_schema,
            title=title or flow_id,
            description=description,
            keywords=list(keywords or ()),
            owner=owner,
            viewers=list(viewers or ()),
            starters=list(starters or ()),
            administrators=list(administrators or ()),
        )
        if self.auth is not None:
            # the flow becomes its own resource server + run scope, with every
            # referenced AP's scope as a dependent scope (paper §5.3.1)
            server = f"flow.{flow_id}"
            self.auth.register_resource_server(server)
            deps = []
            for url in asl.action_urls(flow):
                provider = self.registry.lookup(url)
                deps.append(provider.introspect()["globus_auth_scope"])
            record.scope = self.auth.register_scope(
                server, f"urn:repro:scopes:flow:{flow_id}:run", deps
            ).urn
        with self._lock:
            self._flows[flow_id] = record
        # a backend hosting execution elsewhere (worker processes) needs
        # the definition document pushed to it — flows cross the boundary
        # as plain ASL, never as compiled objects
        forward = getattr(self.engine, "publish_flow_definition", None)
        if forward is not None:
            forward(flow_id, definition)
        # every flow is an action provider: register it behind the AP API
        self.registry.register(
            FlowActionProvider(self, record, clock=self.clock), f"flow://{flow_id}"
        )
        return record

    def update_flow(self, flow_id: str, caller: AuthContext | None = None, **updates):
        record = self._record(flow_id)
        self._require(
            record,
            caller,
            record.administrators + [f"user:{record.owner}"],
            "Administrator",
        )
        if "definition" in updates:
            record.flow = asl.parse(updates.pop("definition"))
        if "input_schema" in updates:
            jsonschema.check_schema(updates["input_schema"])
            record.input_schema = updates.pop("input_schema")
        for key in ("title", "description", "keywords", "viewers", "starters",
                    "administrators", "owner"):
            if key in updates:
                setattr(record, key, updates[key])
        return record

    def remove_flow(self, flow_id: str, caller: AuthContext | None = None) -> None:
        record = self._record(flow_id)
        self._require(record, caller, [f"user:{record.owner}"], "Owner")
        with self._lock:
            del self._flows[flow_id]

    # ------------------------------------------------------------- discovery
    def get_flow(self, flow_id: str, caller: AuthContext | None = None) -> FlowRecord:
        record = self._record(flow_id)
        if self.auth is not None:
            identity = caller.identity if caller else None
            if not record.visible_to(identity):
                raise Forbidden(f"flow {flow_id} is not visible to caller")
        return record

    def search_flows(
        self, q: str = "", caller: AuthContext | None = None
    ) -> list[FlowRecord]:
        identity = caller.identity if caller else None
        out = []
        with self._lock:
            records = list(self._flows.values())
        for record in records:
            if self.auth is not None and not record.visible_to(identity):
                continue
            blob = " ".join(
                [record.title, record.description, " ".join(record.keywords)]
            ).lower()
            if q.lower() in blob:
                out.append(record)
        return out

    # ------------------------------------------------------------- invocation
    def run_flow(
        self,
        flow_id: str,
        flow_input: dict,
        caller: AuthContext | None = None,
        run_as: dict[str, AuthContext] | None = None,
        label: str = "",
        tags: list[str] | None = None,
        monitor_by: list[str] | None = None,
        manage_by: list[str] | None = None,
    ) -> Run:
        record = self._record(flow_id)
        identity = caller.identity if caller else None
        if self.auth is not None:
            principals = record.starters + record.administrators + [
                f"user:{record.owner}"
            ]
            if not any(principal_matches(identity, p) for p in principals):
                raise Forbidden(
                    f"{identity.username if identity else 'anonymous'} lacks the "
                    f"Starter role on flow {flow_id}"
                )
            # delegation: exchange the caller's flow-scope token for dependent
            # AP tokens, stored with the run (paper §5.3.2)
            token = caller.token_for(record.scope) if caller else None
            if token is None:
                raise InputValidationError(
                    f"caller must present a token for scope {record.scope}"
                )
            dependent = self.auth.get_dependent_tokens(token)
            # the run's AuthContext: merged wallet + tenant stamp + a handle
            # back to the AuthService so token_for can re-delegate expired
            # tokens (a run parked past its tokens' lifetime wakes cleanly)
            caller = AuthContext(
                identity=identity,
                tokens={**caller.tokens, **dependent},
                tenant=self.auth.tenant_of(identity),
                auth=self.auth,
            )
            resolved_run_as: dict[str, AuthContext] = {}
            for role, role_caller in (run_as or {}).items():
                role_token = role_caller.token_for(record.scope)
                role_tokens = dict(role_caller.tokens)
                if role_token is not None:
                    role_tokens.update(self.auth.get_dependent_tokens(role_token))
                resolved_run_as[role] = AuthContext(
                    identity=role_caller.identity,
                    tokens=role_tokens,
                    tenant=self.auth.tenant_of(role_caller.identity),
                    auth=self.auth,
                )
            run_as = resolved_run_as
        try:
            flow_input = jsonschema.validate(dict(flow_input), record.input_schema)
        except InputValidationError:
            raise
        run = self.engine.start_run(
            record.flow,
            flow_input,
            flow_id=flow_id,
            creator=identity.username if identity else "anonymous",
            caller=caller,
            run_as=run_as,
            label=label,
            tags=tags,
            monitor_by=monitor_by,
            manage_by=manage_by,
        )
        record.runs.append(run.run_id)
        return run

    # ------------------------------------------------------------- run mgmt
    def run_status(self, run_id: str, caller: AuthContext | None = None) -> dict:
        # peek_run answers from a dormant run's stub without rehydrating it —
        # a status poll against a parked run must stay O(1), not page the
        # whole run back in (passivation transparency, ARCHITECTURE.md inv. 9)
        run = self.engine.peek_run(run_id)
        self._require_run(run, caller, run.monitor_by | run.manage_by, "Monitor")
        return run.as_status()

    def run_events(self, run_id: str, caller: AuthContext | None = None) -> list[dict]:
        run = self.engine.get_run(run_id)
        self._require_run(run, caller, run.monitor_by | run.manage_by, "Monitor")
        return list(run.events)

    def cancel_run(self, run_id: str, caller: AuthContext | None = None) -> dict:
        run = self.engine.get_run(run_id)
        self._require_run(run, caller, run.manage_by, "Manager")
        return self.engine.cancel_run(run_id).as_status()

    def list_runs(
        self,
        caller: AuthContext | None = None,
        flow_id: str | None = None,
        status: str | None = None,
        tag: str | None = None,
    ) -> list[dict]:
        # ``engine.runs`` aggregates every shard's runs in submission order;
        # dormant stubs are appended so parked runs stay listable without
        # being rehydrated (their stub carries the status snapshot)
        out = []
        resident = list(self.engine.runs.values())
        for run in resident + self.engine.dormant_stubs():
            if run.parent is not None:
                continue
            if flow_id and run.flow_id != flow_id:
                continue
            if status and run.status != status:
                continue
            if tag and tag not in run.tags:
                continue
            try:
                self._require_run(
                    run, caller, run.monitor_by | run.manage_by, "Monitor"
                )
            except Forbidden:
                continue
            out.append(run.as_status())
        return out

    # ------------------------------------------------------------- internals
    def _record(self, flow_id: str) -> FlowRecord:
        with self._lock:
            record = self._flows.get(flow_id)
        if record is None:
            raise NotFound(f"unknown flow {flow_id!r}")
        return record

    def flows_by_id(self) -> dict[str, asl.Flow]:
        with self._lock:
            return {fid: rec.flow for fid, rec in self._flows.items()}

    def enable_supervision(
        self,
        heartbeat_interval: float = 0.5,
        heartbeat_timeout: float = 2.0,
        chaos=None,
    ):
        """Attach and start a :class:`~repro.core.supervisor.ShardSupervisor`.

        Live partial-failure tolerance for the service's shard pool: shard
        heartbeats, journal fencing on failure, online re-homing of the
        dead shard's runs onto the survivors.  ``chaos`` optionally wires a
        :class:`~repro.core.chaos.ChaosPlane` whose kill plans the
        supervisor executes.  The supervisor resolves flow definitions
        through this service, so runs rebuilt from a fenced shard's journal
        can resume flows published at any time.  Returns the supervisor.
        """
        from .supervisor import ShardSupervisor

        if not isinstance(self.engine, EngineShardPool):
            raise ValueError(
                f"the {self.engine.backend_name!r} backend supervises its "
                "own workers (pid-wait + pipe heartbeats); ShardSupervisor "
                "only attaches to the inline thread pool"
            )
        supervisor = ShardSupervisor(
            self.engine,
            heartbeat_interval=heartbeat_interval,
            heartbeat_timeout=heartbeat_timeout,
            chaos=chaos,
            flows=self.flows_by_id,
        )
        supervisor.start()
        return supervisor

    def recover_runs(self, resume: bool = True) -> list[Run]:
        """Resume unfinished runs of published flows after a restart.

        Delegates to per-shard journal replay (each shard recovers only the
        runs it owns; see :meth:`EngineShardPool.recover`), then
        **re-delegates** each resumed run's credentials: token wallets do
        not survive a crash (tokens are never journaled), but the creator's
        *consent* persists in the AuthService, so the run re-acquires a
        fresh scoped wallet (paper §5.3 — long-running actions outliving
        their original tokens).  A run whose consent was revoked while the
        service was down resumes without a wallet and fails its next
        provider invocation with the precise coded ``AuthError``.
        """
        recovered = self.engine.recover(self.flows_by_id(), resume=resume)
        if self.auth is not None:
            for run in recovered:
                self._redelegate_run(run)
            for stub in self.engine.dormant_stubs():
                if stub.caller is None:
                    self._redelegate_run(stub)
        return recovered

    def _redelegate_run(self, run) -> None:
        """Attach a freshly-delegated AuthContext to a recovered run/stub."""
        if run.caller is not None:
            return
        record = self._flows.get(run.flow_id)
        if record is None or not record.scope:
            return
        try:
            identity = self.auth.get_identity(run.creator)
            wallet = self.auth.redelegate(run.creator, record.scope)
        except AutomationError:
            return  # unknown creator or revoked consent: fail at invocation
        run.caller = AuthContext(
            identity=identity,
            tokens=wallet,
            tenant=self.auth.tenant_of(identity),
            auth=self.auth,
        )
        if isinstance(run, Run):
            run.tenant_id = run.tenant_id or (
                run.caller.tenant.tenant_id if run.caller.tenant else None
            )

    def compact(self) -> list[dict]:
        """Checkpoint-compact every shard's journal segment on demand.

        Collapses each segment's append-only history into one checkpoint
        record (live runs, triggers + ack-progress, service counters) so
        the next recovery replays O(live state) instead of the full
        history.  Construct the service with ``compact_every=N`` for
        automatic compaction once a segment's post-checkpoint tail exceeds
        N records.  Returns one summary dict per shard.
        """
        return self.engine.compact()

    # ------------------------------------------------------------- triggers
    def _router(self) -> EventRouter:
        if self.router is None:
            raise NotFound(
                "no event fabric: construct FlowsService(queues=QueueService(...))"
            )
        return self.router

    def _trigger_invoker(self, flow_id: str):
        def invoke(action_input: dict, caller: AuthContext | None) -> str:
            return self.run_flow(flow_id, action_input, caller=caller).run_id

        return invoke

    def create_trigger(
        self,
        queue_id: str,
        predicate: str,
        flow_id: str,
        transform: dict[str, str] | None = None,
        owner: str = "anonymous",
        trigger_id: str | None = None,
        poll_min_s: float = 0.5,
        poll_max_s: float = 30.0,
        batch: int = 10,
    ) -> Trigger:
        """Bind a queue + predicate to a published flow (paper §5.5).

        The binding is journaled (``trigger_created``) to the owning shard's
        segment with the durable action ref ``flow:<flow_id>``, so
        :meth:`recover_triggers` can re-bind the invoker after a restart.
        """
        self._record(flow_id)  # raises NotFound for unpublished flows
        config = TriggerConfig(
            queue_id=queue_id,
            predicate=predicate,
            action_invoker=self._trigger_invoker(flow_id),
            transform=dict(transform or {}),
            poll_min_s=poll_min_s,
            poll_max_s=poll_max_s,
            batch=batch,
            action_ref=f"flow:{flow_id}",
        )
        return self._router().create_trigger(
            config, owner=owner, trigger_id=trigger_id
        )

    def create_run_wake_trigger(
        self,
        queue_id: str,
        predicate: str,
        run_id_key: str = "run_id",
        transform: dict[str, str] | None = None,
        owner: str = "anonymous",
        trigger_id: str | None = None,
        poll_min_s: float = 0.5,
        poll_max_s: float = 30.0,
        batch: int = 10,
    ) -> Trigger:
        """Bind a queue + predicate to *waking dormant runs* (paper §5.5 +
        passivation).

        A matching event rehydrates the parked run whose id sits at
        ``run_id_key`` of the transformed input, instead of starting a new
        flow.  Journaled with the durable action ref ``run-wake`` so
        :meth:`recover_triggers` re-binds it without needing any flow to be
        re-published first.
        """
        config = TriggerConfig(
            queue_id=queue_id,
            predicate=predicate,
            action_invoker=lambda _input, _caller: "",  # unused on wake path
            transform=dict(transform or {}),
            poll_min_s=poll_min_s,
            poll_max_s=poll_max_s,
            batch=batch,
            action_ref="run-wake",
            wake_run_key=run_id_key,
        )
        return self._router().create_trigger(
            config, owner=owner, trigger_id=trigger_id
        )

    def enable_trigger(self, trigger_id: str, caller: AuthContext | None = None) -> None:
        self._router().enable(trigger_id, caller=caller)

    def disable_trigger(self, trigger_id: str) -> None:
        self._router().disable(trigger_id)

    def trigger_status(self, trigger_id: str) -> dict:
        trig = self._router().get(trigger_id)
        return {
            "trigger_id": trig.trigger_id,
            "queue_id": trig.config.queue_id,
            "action_ref": trig.config.action_ref,
            "predicate": trig.config.predicate,
            "owner": trig.owner,
            "enabled": trig.enabled,
            "stats": dict(trig.stats),
            "recent_results": list(trig.recent_results[-10:]),
        }

    def recover_triggers(self) -> list[Trigger]:
        """Restore journaled triggers after a restart (paper §5.5 durably).

        Replays every shard's journal segment (triggers are hash-owned by
        shards), re-binds each ``flow:<flow_id>`` action ref to
        :meth:`run_flow`, and re-enables triggers that were enabled at the
        crash.  Flows must be re-published (same ``flow_id``) first; a
        trigger whose flow is no longer published is recovered *disabled*.
        """
        router = self._router()

        def invoker_for(image: TriggerImage):
            if image.action_ref == "run-wake":
                # wake-run triggers dispatch through the router's run_waker;
                # the invoker is never called on that path
                return lambda _input, _caller: ""
            flow_id = image.action_ref.removeprefix("flow:")
            return self._trigger_invoker(flow_id)

        def flow_published(image: TriggerImage) -> bool:
            if image.action_ref == "run-wake":
                return True  # not bound to a flow; always recoverable
            with self._lock:
                return image.action_ref.removeprefix("flow:") in self._flows

        # the publication check gates enable (it must not run after: with
        # real-clock worker threads an enabled trigger can dispatch before a
        # later disable lands)
        return router.recover(
            invoker_for,
            journals=self.engine.journals,
            enable_filter=flow_published,
        )

    def _require(
        self,
        record: FlowRecord,
        caller: AuthContext | None,
        principals: list[str],
        role: str,
    ) -> None:
        if self.auth is None:
            return
        identity = caller.identity if caller else None
        if not any(principal_matches(identity, p) for p in principals):
            raise Forbidden(
                f"caller lacks the {role} role on flow {record.flow_id}"
            )

    def _require_run(
        self, run: Run, caller: AuthContext | None, extra: set[str], role: str
    ) -> None:
        if self.auth is None:
            return
        identity = caller.identity if caller else None
        principals = [f"user:{run.creator}", *extra]
        if not any(principal_matches(identity, p) for p in principals):
            raise Forbidden(f"caller lacks the {role} role on run {run.run_id}")


class FlowActionProvider(ActionProvider):
    """Adapter exposing a published flow behind the action-provider API.

    "Every flow automatically implements this API and therefore is also an
    action provider ... a flow can invoke another flow as an action" —
    paper §5.2.
    """

    synchronous = False

    def __init__(self, service: FlowsService, record: FlowRecord, clock=None):
        self.service = service
        self.record = record
        self.title = f"Flow: {record.title}"
        self.url = f"flow://{record.flow_id}"
        self.scope_suffix = f"flow.{record.flow_id}"
        self.input_schema = record.input_schema
        super().__init__(clock=clock, auth=None)  # RBAC enforced by FlowsService
        if service.auth is not None and record.scope:
            self.scope = record.scope

    def introspect(self) -> dict:
        doc = super().introspect()
        doc["flow_id"] = self.record.flow_id
        doc["definition"] = self.record.flow.definition
        return doc

    def _start(self, action: _Action, identity) -> None:
        # the parent's caller wallet carries the dependent token for this
        # flow's scope (registered as a dependent scope at publish time)
        run = self.service.run_flow(
            self.record.flow_id,
            action.body,
            caller=action.caller,
            label=f"child of action {action.action_id}",
        )
        action.details = {"run_id": run.run_id}
        action.display_status = f"running flow {self.record.flow_id}"
        if not hasattr(self, "_child_runs"):
            self._child_runs: dict[str, str] = {}
        self._child_runs[action.action_id] = run.run_id
        # completion callback so parent engines in callback mode see child
        # flows finish immediately (and _poll stays correct regardless)
        run.completion_callbacks.append(lambda _run: self._poll(action))

    def _poll(self, action: _Action) -> None:
        run_id = getattr(self, "_child_runs", {}).get(action.action_id)
        if run_id is None:
            return
        run = self.service.engine.get_run(run_id)
        if run.status == RUN_ACTIVE:
            return
        if run.status == RUN_SUCCEEDED:
            self._complete(
                action, AP_SUCCEEDED, details={"run_id": run_id, "output": run.context}
            )
        else:
            self._complete(
                action, AP_FAILED, details={"run_id": run_id, "error": run.error}
            )

    def _cancel(self, action: _Action) -> None:
        run_id = getattr(self, "_child_runs", {}).get(action.action_id)
        if run_id is not None:
            self.service.engine.cancel_run(run_id)
        super()._cancel(action)
