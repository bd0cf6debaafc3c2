"""Authorization-delegation model (paper §5.1), offline.

Structural reproduction of the Globus Auth mechanics the automation services
rely on:

* every service / action provider / flow is registered as a **resource
  server** owning one or more **scopes** (URN-like strings);
* a scope may declare **dependent scopes** — downstream operations the
  service performs on the caller's behalf (e.g. a flow's run scope depends on
  the scopes of every action provider it invokes);
* users grant **consents** for (client, scope) pairs; a consent covers the
  scope's transitive dependency closure;
* clients obtain **access tokens** bound to (identity, scope) with a
  clock-driven **expiry** (``issue_token(..., lifetime_s=...)``); services
  **introspect** tokens to authenticate callers, and may exchange a token for
  **dependent tokens** to call downstream services — the paper's delegation
  chain;
* consents outlive tokens: a flow parked for weeks wakes with expired
  tokens, but the standing consent lets it **re-delegate**
  (:meth:`AuthService.redelegate`, :meth:`AuthContext.token_for`) without
  user interaction — the paper's core long-running-action story (§5.3);
* ``RunAs`` roles map to alternate identities whose tokens are captured when
  the run starts (paper §4.2.1 / §5.3.2);
* identities belong to **tenants** (:class:`Tenant`) carrying a fair-share
  weight and admission quotas, consumed by the shard pool's weighted-fair
  admission queue (see repro.core.admission).

Everything is in-process, but the *protocol shape* (introspection, dependent
token issuance, consent checks) matches the paper so that authorization
failures propagate exactly like the real system's (cf. Fig 2f — a run failing
on an invalid credential).  Auth failures carry a machine-readable ``code``
(``token_expired`` / ``consent_required`` / ``scope_mismatch`` ...) so flows
can ``Catch`` and model re-consent.
"""

from __future__ import annotations

import secrets
import threading
from dataclasses import dataclass, field

from .clock import Clock, RealClock
from .errors import AuthError, AutomationError, ConsentRequired, NotFound


@dataclass
class Identity:
    username: str
    id: str = field(default_factory=lambda: "id-" + secrets.token_hex(8))
    groups: set[str] = field(default_factory=set)


@dataclass
class Scope:
    urn: str
    resource_server: str
    dependent_scopes: list[str] = field(default_factory=list)


@dataclass
class Tenant:
    """An accounting/fairness domain identities belong to (think: project).

    ``weight`` sets the tenant's share in the pool's weighted
    deficit-round-robin admission; ``rate_per_s``/``burst`` parameterize the
    per-tenant token bucket at the service edge; ``max_concurrency`` caps the
    tenant's simultaneously-active runs.  ``None`` quotas are unlimited.
    """

    tenant_id: str
    weight: float = 1.0
    rate_per_s: float | None = None
    burst: float | None = None
    max_concurrency: int | None = None


@dataclass
class TokenInfo:
    token: str
    identity: Identity
    scope: str
    active: bool = True
    #: absolute expiry timestamp (clock domain of the issuing AuthService);
    #: None = never expires
    exp: float | None = None

    def as_introspection(self, now: float | None = None) -> dict:
        active = self.active and not (
            self.exp is not None and now is not None and now >= self.exp
        )
        doc = {
            "active": active,
            "username": self.identity.username,
            "identity_id": self.identity.id,
            "scope": self.scope,
        }
        if self.exp is not None:
            doc["exp"] = self.exp
        return doc


class AuthService:
    """In-process stand-in for the Globus Auth platform.

    ``clock`` drives token expiry (VirtualClock makes expiry deterministic
    in tests); ``default_token_lifetime_s=None`` issues non-expiring tokens
    unless a lifetime is passed explicitly — the seed behavior.
    """

    def __init__(
        self,
        clock: Clock | None = None,
        default_token_lifetime_s: float | None = None,
    ):
        self._lock = threading.RLock()
        self._clock = clock or RealClock()
        self.default_token_lifetime_s = default_token_lifetime_s
        self._identities: dict[str, Identity] = {}
        self._resource_servers: set[str] = set()
        self._scopes: dict[str, Scope] = {}
        self._tokens: dict[str, TokenInfo] = {}
        # consents: identity_id -> set of scope URNs the user has consented to
        self._consents: dict[str, set[str]] = {}
        self._tenants: dict[str, Tenant] = {}
        # identity_id -> tenant_id
        self._tenant_of: dict[str, str] = {}

    # -- identities ---------------------------------------------------------
    def create_identity(self, username: str, groups: set[str] | None = None) -> Identity:
        with self._lock:
            if username in self._identities:
                return self._identities[username]
            ident = Identity(username=username, groups=set(groups or ()))
            self._identities[username] = ident
            return ident

    def get_identity(self, username: str) -> Identity:
        with self._lock:
            if username not in self._identities:
                raise NotFound(f"unknown identity {username!r}")
            return self._identities[username]

    # -- tenants ------------------------------------------------------------
    def register_tenant(
        self,
        tenant_id: str,
        weight: float = 1.0,
        rate_per_s: float | None = None,
        burst: float | None = None,
        max_concurrency: int | None = None,
    ) -> Tenant:
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        with self._lock:
            tenant = Tenant(tenant_id, weight, rate_per_s, burst, max_concurrency)
            self._tenants[tenant_id] = tenant
            return tenant

    def get_tenant(self, tenant_id: str) -> Tenant:
        with self._lock:
            if tenant_id not in self._tenants:
                raise NotFound(f"unknown tenant {tenant_id!r}")
            return self._tenants[tenant_id]

    def assign_tenant(self, username: str, tenant_id: str) -> None:
        ident = self.get_identity(username)
        with self._lock:
            if tenant_id not in self._tenants:
                raise NotFound(f"unknown tenant {tenant_id!r}")
            self._tenant_of[ident.id] = tenant_id

    def tenant_of(self, identity: Identity | None) -> Tenant | None:
        """The tenant ``identity`` belongs to, or None (unmetered)."""
        if identity is None:
            return None
        with self._lock:
            tid = self._tenant_of.get(identity.id)
            return self._tenants.get(tid) if tid is not None else None

    # -- resource servers & scopes -------------------------------------------
    def register_resource_server(self, name: str) -> str:
        with self._lock:
            self._resource_servers.add(name)
            return name

    def register_scope(
        self,
        resource_server: str,
        urn: str,
        dependent_scopes: list[str] | None = None,
    ) -> Scope:
        with self._lock:
            if resource_server not in self._resource_servers:
                raise NotFound(f"unknown resource server {resource_server!r}")
            for dep in dependent_scopes or []:
                if dep not in self._scopes:
                    raise NotFound(f"dependent scope {dep!r} is not registered")
            scope = Scope(urn, resource_server, list(dependent_scopes or []))
            self._scopes[urn] = scope
            return scope

    def get_scope(self, urn: str) -> Scope:
        with self._lock:
            if urn not in self._scopes:
                raise NotFound(f"unknown scope {urn!r}")
            return self._scopes[urn]

    def add_dependent_scope(self, urn: str, dependent: str) -> None:
        with self._lock:
            scope = self.get_scope(urn)
            self.get_scope(dependent)
            if dependent not in scope.dependent_scopes:
                scope.dependent_scopes.append(dependent)

    def dependency_closure(self, urn: str) -> list[str]:
        """Transitive closure of dependent scopes (includes ``urn`` itself)."""
        with self._lock:
            out: list[str] = []
            seen: set[str] = set()
            stack = [urn]
            while stack:
                cur = stack.pop()
                if cur in seen:
                    continue
                seen.add(cur)
                out.append(cur)
                stack.extend(self.get_scope(cur).dependent_scopes)
            return out

    # -- consents & tokens ----------------------------------------------------
    def grant_consent(self, username: str, scope_urn: str) -> None:
        """User consents to ``scope_urn`` *and its dependency closure*.

        This mirrors the OAuth consent screen the paper describes: when a user
        runs a flow, "the list of all action providers used on their behalf
        will be displayed and the user must provide consent".
        """
        ident = self.get_identity(username)
        with self._lock:
            closure = self.dependency_closure(scope_urn)
            self._consents.setdefault(ident.id, set()).update(closure)

    def revoke_consent(self, username: str, scope_urn: str) -> None:
        """Revoke the consent for ``scope_urn`` **and its dependency closure**.

        Consent was granted closure-wide, so revocation must be closure-wide
        too: dropping only the root URN would leave dependent-scope consents
        (and any already-issued dependent tokens) live — a revoked delegation
        chain that keeps working.  Every outstanding token on a revoked scope
        is deactivated.
        """
        ident = self.get_identity(username)
        with self._lock:
            if scope_urn in self._scopes:
                revoked = set(self.dependency_closure(scope_urn))
            else:
                revoked = {scope_urn}
            held = self._consents.get(ident.id)
            if held is not None:
                held -= revoked
            for info in self._tokens.values():
                if info.identity.id == ident.id and info.scope in revoked:
                    info.active = False

    def has_consent(self, username: str, scope_urn: str) -> bool:
        ident = self.get_identity(username)
        with self._lock:
            return scope_urn in self._consents.get(ident.id, set())

    def issue_token(
        self,
        username: str,
        scope_urn: str,
        lifetime_s: float | None = None,
    ) -> str:
        """Issue an access token for (identity, scope); requires consent.

        ``lifetime_s`` (default: the service-wide
        ``default_token_lifetime_s``) sets the expiry; None never expires.
        """
        ident = self.get_identity(username)
        with self._lock:
            if scope_urn not in self._scopes:
                raise NotFound(f"unknown scope {scope_urn!r}")
            if scope_urn not in self._consents.get(ident.id, set()):
                raise ConsentRequired(
                    f"{username} has not consented to scope {scope_urn}"
                )
            if lifetime_s is None:
                lifetime_s = self.default_token_lifetime_s
            exp = self._clock.now() + lifetime_s if lifetime_s is not None else None
            token = "tok-" + secrets.token_hex(16)
            self._tokens[token] = TokenInfo(token, ident, scope_urn, exp=exp)
            return token

    def _expired(self, info: TokenInfo) -> bool:
        return info.exp is not None and self._clock.now() >= info.exp

    def introspect(self, token: str) -> dict:
        """OAuth-style token introspection (paper §5.1).

        An expired token introspects as ``active: False`` with its ``exp``
        still present, so callers can tell expiry from revocation.
        """
        with self._lock:
            info = self._tokens.get(token)
            if info is None:
                return {"active": False}
            return info.as_introspection(now=self._clock.now())

    def token_live(self, token: str | None) -> bool:
        """True iff ``token`` is known, unrevoked, and unexpired."""
        if token is None:
            return False
        with self._lock:
            info = self._tokens.get(token)
            return info is not None and info.active and not self._expired(info)

    def get_dependent_tokens(
        self, token: str, lifetime_s: float | None = None
    ) -> dict[str, str]:
        """Exchange a token for tokens on each *direct* dependent scope.

        This is the paper's delegation step: a service holding a user token
        for its own scope retrieves downstream tokens to invoke the actions a
        flow defines.  The returned map is scope URN -> token.  Dependent
        tokens inherit the parent token's expiry unless ``lifetime_s`` sets a
        shorter one; exchanging an expired or revoked token fails with the
        matching coded :class:`~repro.core.errors.AuthError`.
        """
        with self._lock:
            info = self._tokens.get(token)
            if info is None:
                raise AuthError("invalid token", code="token_invalid")
            if self._expired(info):
                raise AuthError(
                    f"token for scope {info.scope} has expired",
                    code="token_expired",
                )
            if not info.active:
                raise AuthError("revoked token", code="token_invalid")
            scope = self.get_scope(info.scope)
            exp = info.exp
            if lifetime_s is not None:
                cap = self._clock.now() + lifetime_s
                exp = cap if exp is None else min(exp, cap)
            out = {}
            for dep in scope.dependent_scopes:
                if dep not in self._consents.get(info.identity.id, set()):
                    raise ConsentRequired(
                        f"{info.identity.username} lacks consent for {dep}"
                    )
                t = "tok-" + secrets.token_hex(16)
                self._tokens[t] = TokenInfo(t, info.identity, dep, exp=exp)
                out[dep] = t
            return out

    def redelegate(
        self,
        username: str,
        scope_urn: str,
        lifetime_s: float | None = None,
    ) -> dict[str, str]:
        """Fresh wallet for ``scope_urn`` and its whole dependency closure.

        The re-delegation path for long-running work: tokens captured at
        flow start expire while a run is parked (passivated) or a crashed
        engine is down, but the *consent* persists — so a woken or recovered
        run re-acquires live tokens without user interaction.  Raises
        :class:`~repro.core.errors.ConsentRequired` if any scope in the
        closure is no longer consented.
        """
        with self._lock:
            return {
                dep: self.issue_token(username, dep, lifetime_s=lifetime_s)
                for dep in self.dependency_closure(scope_urn)
            }

    def invalidate_token(self, token: str) -> None:
        with self._lock:
            if token in self._tokens:
                self._tokens[token].active = False

    # -- authorization helper ---------------------------------------------------
    def require(self, token: str | None, scope_urn: str) -> Identity:
        """Validate ``token`` grants ``scope_urn``; return the caller identity.

        This is the per-invocation gate (ARCHITECTURE invariant 11): every
        ``ActionProvider.run/status/cancel/release`` funnels through it, so
        expiry and consent are enforced at *every* provider invocation, not
        just flow start.  Failures carry a machine-readable ``code``.
        """
        if token is None:
            raise AuthError(
                f"missing access token for scope {scope_urn}",
                code="missing_token",
            )
        with self._lock:
            info = self._tokens.get(token)
            if info is None:
                raise AuthError("invalid token", code="token_invalid")
            if self._expired(info):
                raise AuthError(
                    f"token for scope {info.scope} has expired",
                    code="token_expired",
                )
            if not info.active:
                if info.scope not in self._consents.get(info.identity.id, set()):
                    raise ConsentRequired(
                        f"consent for {info.scope} was revoked"
                    )
                raise AuthError("revoked token", code="token_invalid")
            if info.scope != scope_urn:
                raise AuthError(
                    f"token scope {info.scope} does not grant {scope_urn}",
                    code="scope_mismatch",
                )
            return info.identity


@dataclass
class AuthContext:
    """Authenticated caller context passed uniformly through the stack.

    ``FlowsService -> EngineShardPool -> FlowEngine -> ActionProvider``
    all hand the same object along: identity + tenant + token wallet
    (``tokens`` maps scope URN -> access token) + an optional handle back to
    the issuing :class:`AuthService`.

    :meth:`token_for` is **expiry-aware**: when the wallet's token for a
    scope has expired and the auth handle is present, it transparently
    re-delegates against the standing consent — the wake path for a run
    parked past its tokens' lifetime.  If re-delegation is impossible (no
    handle, consent revoked) the stale token is returned unchanged so the
    downstream ``require()`` raises the precise coded error.
    """

    identity: Identity
    tokens: dict[str, str] = field(default_factory=dict)
    tenant: Tenant | None = None
    auth: AuthService | None = field(default=None, repr=False)

    def token_for(self, scope_urn: str, refresh: bool = True) -> str | None:
        token = self.tokens.get(scope_urn)
        if token is None or self.auth is None or not refresh:
            return token
        if self.auth.token_live(token):
            return token
        try:
            fresh = self.auth.issue_token(self.identity.username, scope_urn)
        except AutomationError:
            return token
        self.tokens[scope_urn] = fresh
        return fresh

    @property
    def tenant_id(self) -> str | None:
        return self.tenant.tenant_id if self.tenant is not None else None


#: Deprecated alias — the seed's caller type.  ``Caller(identity=...,
#: tokens=...)`` keeps constructing the same object; new code should say
#: :class:`AuthContext`.
Caller = AuthContext


def principal_matches(identity: Identity, principal: str) -> bool:
    """RBAC principal matching (paper §4.3).

    Principals may be ``user:<name>``, ``group:<name>``, ``public``, or
    ``all_authenticated_users``.
    """
    if principal == "public":
        return True
    if principal == "all_authenticated_users":
        return identity is not None
    if principal.startswith("user:"):
        return identity is not None and identity.username == principal[5:]
    if principal.startswith("group:"):
        return identity is not None and principal[6:] in identity.groups
    return False
