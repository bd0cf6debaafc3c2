"""The Action Provider API (paper §5.2).

Every activity "with some notion of completion" is exposed behind one
uniform, *asynchronous* interface:

* ``introspect()``            — descriptive/administrative info, the Globus
  Auth scope required to invoke, and the input schema.  May be called without
  authentication (the paper allows unauthenticated introspection so scopes
  can be discovered).
* ``run(body) -> status``     — begin an action; returns an ``action_id`` and
  a state in {ACTIVE, SUCCEEDED, FAILED} plus action-specific ``details``.
* ``status(action_id)``       — poll; same document shape as ``run``.
* ``cancel(action_id)``       — advisory cancellation.
* ``release(action_id)``      — drop completed-action state; subsequent
  references to the id are unrecognized.  (Providers otherwise retain state
  for 30 days.)

Flows are themselves action providers (composability), as are the built-in
providers under :mod:`repro.core.providers`.

Reliability details matching the paper's platform behaviour:

* idempotent invocation — ``run`` accepts a ``request_id``; re-submitting the
  same request id returns the original action rather than starting a new one
  (this is what makes journal-replay after an engine crash safe);
* completion callbacks — an *extension beyond the paper* (which polls with
  exponential backoff): in-process providers may notify waiters immediately on
  completion, which the optimized engine mode exploits (EXPERIMENTS.md §Perf).
"""

from __future__ import annotations

import heapq
import secrets
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from . import schema as jsonschema
from .auth import AuthContext, AuthService, Identity
from .clock import Clock, RealClock
from .errors import ActionUnknown, AuthError, Forbidden

ACTIVE = "ACTIVE"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"

#: Providers retain completed-action state for 30 days (paper §5.2).
RETENTION_SECONDS = 30 * 24 * 3600.0


@dataclass
class ActionStatus:
    """The status document returned by run/status/cancel/release."""

    action_id: str
    status: str
    creator: str
    details: Any = None
    display_status: str = ""
    start_time: float = 0.0
    completion_time: float | None = None
    release_after: float = RETENTION_SECONDS

    def as_dict(self) -> dict:
        return {
            "action_id": self.action_id,
            "status": self.status,
            "creator_id": self.creator,
            "details": self.details,
            "display_status": self.display_status,
            "start_time": self.start_time,
            "completion_time": self.completion_time,
            "release_after": self.release_after,
        }


@dataclass
class _Action:
    """Internal per-action record."""

    action_id: str
    creator: str
    body: dict
    caller: "AuthContext | None" = None
    status: str = ACTIVE
    details: Any = None
    display_status: str = ""
    start_time: float = 0.0
    completion_time: float | None = None
    completes_at: float | None = None  # for time-based actions
    monitor_by: set[str] = field(default_factory=set)
    manage_by: set[str] = field(default_factory=set)
    callbacks: list[Callable[[ActionStatus], None]] = field(default_factory=list)
    request_id: str | None = None  # idempotency key, dropped with the action


class ActionProvider:
    """Base class for all action providers.

    Subclasses set class attributes (``title``, ``url``, ``scope_suffix``,
    ``input_schema``, ``synchronous``) and implement ``_start``; optionally
    ``_poll`` (for actions that complete on their own) and ``_cancel``.
    """

    api_version = "1.0"
    title = "Action Provider"
    subtitle = ""
    admin_contact = "automation@repro.example"
    url = "ap://base"
    scope_suffix = "base"
    input_schema: dict = {"type": "object"}
    #: hint that run() usually returns a completed status immediately
    synchronous = False

    def __init__(
        self,
        clock: Clock | None = None,
        auth: AuthService | None = None,
        scope: str | None = None,
        retention_seconds: float = RETENTION_SECONDS,
    ):
        self.clock = clock or RealClock()
        self.auth = auth
        #: optional scheduler (attached by the engine): lets time-based
        #: actions fire completion callbacks instead of being poll-discovered
        self.scheduler = None
        #: optional ChaosPlane (armed by ChaosPlane.arm_providers): injects
        #: seeded invoke/status faults and latency spikes keyed on the
        #: caller's request_id, after the dedup check — a failover
        #: re-dispatch of an already-run request never re-draws
        self.chaos = None
        self._lock = threading.RLock()
        self._actions: dict[str, _Action] = {}
        self._requests: dict[str, str] = {}  # request_id -> action_id
        #: completed-action retention window (paper §5.2: 30 days).  State
        #: past retention is garbage-collected on access — without this a
        #: long-lived provider's ``_actions``/``_requests`` maps grow
        #: without bound (every completed action held forever).
        self.retention_seconds = retention_seconds
        self._expiry: list[tuple[float, str]] = []  # (expires_at, action_id)
        self.scope = scope or f"urn:repro:scopes:{self.scope_suffix}:run"
        if auth is not None:
            auth.register_resource_server(self.url)
            auth.register_scope(self.url, self.scope)
        # run counters (service statistics, cf. paper §7)
        self.stats = {
            "run": 0, "poll": 0, "cancel": 0, "release": 0, "failed": 0,
            "expired": 0,
        }

    # ------------------------------------------------------------------ API
    def introspect(self) -> dict:
        """GET <action_url>/ — no authentication required."""
        return {
            "api_version": self.api_version,
            "title": self.title,
            "subtitle": self.subtitle,
            "admin_contact": self.admin_contact,
            "globus_auth_scope": self.scope,
            "input_schema": self.input_schema,
            "synchronous": self.synchronous,
            "types": ["Action"],
        }

    def run(
        self,
        body: dict,
        caller: AuthContext | None = None,
        request_id: str | None = None,
        monitor_by: list[str] | None = None,
        manage_by: list[str] | None = None,
    ) -> ActionStatus:
        """POST <action_url>/run."""
        identity = self._authenticate(caller)
        self._expire_completed()
        with self._lock:
            if request_id is not None and request_id in self._requests:
                return self._status_of(self._actions[self._requests[request_id]])
        if self.chaos is not None and request_id is not None:
            # after the dedup check: a retry carries a NEW request_id (the
            # attempt number is part of it) and draws fresh, while an
            # idempotent re-dispatch of an existing request resolved above
            # without consulting chaos at all
            self.chaos.invoke("provider.run", self.url, request_id)
        body = jsonschema.validate(dict(body), self.input_schema)
        action = _Action(
            action_id=f"{self.scope_suffix}-" + secrets.token_hex(8),
            creator=identity.username if identity else "anonymous",
            body=body,
            caller=caller,
            start_time=self.clock.now(),
            monitor_by=set(monitor_by or ()),
            manage_by=set(manage_by or ()),
            request_id=request_id,
        )
        with self._lock:
            self._actions[action.action_id] = action
            if request_id is not None:
                self._requests[request_id] = action.action_id
            self.stats["run"] += 1
        try:
            self._start(action, identity)
        except Exception as e:  # provider-internal error -> FAILED action
            self._complete(action, FAILED, details={"error": str(e)})
        return self._status_of(action)

    def status(self, action_id: str, caller: AuthContext | None = None) -> ActionStatus:
        """GET <action_id>/status."""
        action = self._get(action_id)
        self._authorize_view(action, caller)
        with self._lock:
            self.stats["poll"] += 1
        if self.chaos is not None and action.request_id is not None:
            # keyed on (request, poll time): each poll of an action is an
            # independent draw, but the same poll at the same virtual time
            # draws identically across shard counts
            self.chaos.invoke(
                "provider.status",
                self.url,
                action.request_id,
                f"{self.clock.now():.9f}",
            )
        if action.status == ACTIVE:
            self._poll(action)
        return self._status_of(action)

    def cancel(self, action_id: str, caller: AuthContext | None = None) -> ActionStatus:
        """POST <action_id>/cancel — advisory only (paper §5.2)."""
        action = self._get(action_id)
        self._authorize_manage(action, caller)
        with self._lock:
            self.stats["cancel"] += 1
        if action.status == ACTIVE:
            self._cancel(action)
        return self._status_of(action)

    def release(self, action_id: str, caller: AuthContext | None = None) -> ActionStatus:
        """POST <action_id>/release — forget a completed action."""
        action = self._get(action_id)
        self._authorize_manage(action, caller)
        if action.status == ACTIVE:
            self._poll(action)
        if action.status == ACTIVE:
            raise Forbidden(f"action {action_id} is still ACTIVE; cancel first")
        status = self._status_of(action)
        with self._lock:
            self._actions.pop(action_id, None)
            self._requests = {
                k: v for k, v in self._requests.items() if v != action_id
            }
            self.stats["release"] += 1
        return status

    # -------------------------------------------------- completion callbacks
    def subscribe(
        self, action_id: str, callback: Callable[[ActionStatus], None]
    ) -> bool:
        """Register a completion callback (beyond-paper optimization).

        Returns False (and does not register) if the action already completed;
        the caller should read the status instead.  Time-based actions
        (``completes_at`` set) additionally schedule their own completion so
        the callback actually fires (requires an attached scheduler).
        """
        with self._lock:
            action = self._actions.get(action_id)
            if action is None or action.status != ACTIVE:
                return False
            action.callbacks.append(callback)
            completes_at = action.completes_at
        if completes_at is not None and self.scheduler is not None:
            self.scheduler.call_at(completes_at, lambda: self._poll(action))
        return True

    # ------------------------------------------------------- subclass hooks
    def _start(self, action: _Action, identity: Identity | None) -> None:
        raise NotImplementedError

    def _poll(self, action: _Action) -> None:
        """Default: time-based completion via ``completes_at``."""
        if action.completes_at is not None and self.clock.now() >= action.completes_at:
            self._complete(action, SUCCEEDED, details=action.details)

    def _cancel(self, action: _Action) -> None:
        self._complete(action, FAILED, details={"error": "cancelled"})

    # ---------------------------------------------------------------- misc
    def _expire_completed(self) -> None:
        """GC completed actions past retention (swept on every access).

        The expiry heap makes each sweep O(actually-expired); entries whose
        action was already ``release``d are skipped.  Expired actions also
        drop their idempotency mapping — a re-submitted ``request_id`` after
        retention starts a *new* action, exactly like the paper's providers
        forgetting state after 30 days.
        """
        now = self.clock.now()
        with self._lock:
            while self._expiry and self._expiry[0][0] <= now:
                _, action_id = heapq.heappop(self._expiry)
                action = self._actions.get(action_id)
                if action is None or action.status == ACTIVE:
                    continue  # released already (or id reused; never ACTIVE)
                del self._actions[action_id]
                if action.request_id is not None:
                    self._requests.pop(action.request_id, None)
                self.stats["expired"] += 1

    def _complete(self, action: _Action, status: str, details: Any = None) -> None:
        with self._lock:
            if action.status != ACTIVE:
                return
            action.status = status
            action.details = details if details is not None else action.details
            action.completion_time = self.clock.now()
            heapq.heappush(
                self._expiry,
                (action.completion_time + self.retention_seconds,
                 action.action_id),
            )
            callbacks = list(action.callbacks)
            action.callbacks.clear()
            if status == FAILED:
                self.stats["failed"] += 1
        doc = self._status_of(action)
        for cb in callbacks:
            try:
                cb(doc)
            except Exception:
                pass

    def _status_of(self, action: _Action) -> ActionStatus:
        # release_after reports the retention *remaining* for completed
        # actions (how long the id stays dereferenceable), not the constant
        remaining = self.retention_seconds
        if action.completion_time is not None:
            remaining = max(
                0.0,
                action.completion_time + self.retention_seconds
                - self.clock.now(),
            )
        return ActionStatus(
            action_id=action.action_id,
            status=action.status,
            creator=action.creator,
            details=action.details,
            display_status=action.display_status,
            start_time=action.start_time,
            completion_time=action.completion_time,
            release_after=remaining,
        )

    def _get(self, action_id: str) -> _Action:
        self._expire_completed()
        with self._lock:
            action = self._actions.get(action_id)
        if action is None:
            raise ActionUnknown(f"unknown action id {action_id!r}")
        return action

    def _authenticate(self, caller: AuthContext | None) -> Identity | None:
        if self.auth is None:
            return caller.identity if caller else None
        if caller is None:
            raise AuthError(
                f"{self.url}: authentication required", code="missing_token"
            )
        token = caller.token_for(self.scope)
        return self.auth.require(token, self.scope)

    def _authorize_view(self, action: _Action, caller: AuthContext | None) -> None:
        self._authorize(action, caller, action.monitor_by | action.manage_by)

    def _authorize_manage(self, action: _Action, caller: AuthContext | None) -> None:
        self._authorize(action, caller, action.manage_by)

    def _authorize(
        self, action: _Action, caller: AuthContext | None, extra: set[str]
    ) -> None:
        if self.auth is None:
            return
        identity = self._authenticate(caller)
        if identity is None or (
            identity.username != action.creator
            and identity.username not in extra
            and not (identity.groups & {g[6:] for g in extra if g.startswith("group:")})
        ):
            raise Forbidden(
                f"{identity.username if identity else 'anonymous'} may not "
                f"access action {action.action_id}"
            )


class ActionRegistry:
    """URL -> provider map; what the flow engine dispatches against."""

    def __init__(self):
        self._providers: dict[str, ActionProvider] = {}
        self._lock = threading.Lock()

    def register(self, provider: ActionProvider, url: str | None = None) -> str:
        url = url or provider.url
        with self._lock:
            self._providers[url] = provider
        provider.url = url
        return url

    def lookup(self, url: str) -> ActionProvider:
        with self._lock:
            provider = self._providers.get(url)
        if provider is None:
            raise ActionUnknown(f"no action provider registered at {url!r}")
        return provider

    def urls(self) -> list[str]:
        with self._lock:
            return sorted(self._providers)
