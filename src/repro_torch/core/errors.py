"""Error taxonomy for the automation services.

Mirrors the error names used by the paper's flow language (which inherits
Amazon States Language conventions): states raise typed errors that ``Catch``
clauses match against via ``ErrorEquals`` — including the wildcard
``States.ALL`` and the paper's ``ActionFailedException``.
"""

from __future__ import annotations


class AutomationError(Exception):
    """Base class for all automation-service errors.

    ``error_name`` is the string that ``Catch.ErrorEquals`` matches against.
    """

    error_name = "States.Runtime"

    def __init__(self, message: str = "", *, cause: str | None = None):
        super().__init__(message)
        self.message = message
        self.cause = cause if cause is not None else message

    def as_result(self) -> dict:
        return {"Error": self.error_name, "Cause": self.cause}


class FlowValidationError(AutomationError):
    """A flow definition or input schema failed validation at publish time."""

    error_name = "FlowValidationError"


class InputValidationError(AutomationError):
    """Run input failed validation against the flow's input schema."""

    error_name = "InputValidationError"


class ActionFailedException(AutomationError):
    """An action completed in the FAILED state (paper §4.2.1)."""

    error_name = "ActionFailedException"


class ActionTimeout(AutomationError):
    """An action exceeded its ``WaitTime`` (paper: treat as a failed state)."""

    error_name = "States.Timeout"


class ActionUnknown(AutomationError):
    """Reference to an unknown action id (e.g. after ``release``)."""

    error_name = "ActionUnknown"


class StateMachineError(AutomationError):
    """Internal inconsistency while executing a run (bad Next, bad path...)."""

    error_name = "States.Runtime"


class BranchFailed(AutomationError):
    """A Parallel branch terminated in a failed state."""

    error_name = "States.BranchFailed"


class MapItemFailed(AutomationError):
    """More Map iterations failed than ``ToleratedFailureCount`` allows."""

    error_name = "States.MapItemFailed"


class AuthError(AutomationError):
    """Authentication / authorization failure (missing or bad token/scope).

    ``code`` is a machine-readable discriminator (``token_expired``,
    ``consent_required``, ``scope_mismatch``, ``missing_token``,
    ``token_invalid``) surfaced in ``as_result()`` so flows can model
    re-consent / re-delegation with ``Retry``/``Catch`` (paper §5.3) —
    matching on the error name selects the family, the code says *why*.
    """

    error_name = "AuthError"
    default_code = "auth_error"

    def __init__(
        self,
        message: str = "",
        *,
        code: str | None = None,
        cause: str | None = None,
    ):
        super().__init__(message, cause=cause)
        self.code = code or self.default_code

    def as_result(self) -> dict:
        return {"Error": self.error_name, "Cause": self.cause, "Code": self.code}


class ConsentRequired(AuthError):
    """The presented token lacks a consent for a required dependent scope."""

    error_name = "ConsentRequired"
    default_code = "consent_required"


class QuotaExceeded(AutomationError):
    """A tenant exceeded its admission quota (rate or concurrency)."""

    error_name = "QuotaExceeded"


class NotFound(AutomationError):
    """Unknown flow / run / queue / trigger / timer identifier."""

    error_name = "NotFound"


class Forbidden(AutomationError):
    """Authenticated but not authorized for the requested operation."""

    error_name = "Forbidden"


class QueueInvariantError(AutomationError):
    """Queue service invariant violation (bad receipt, double-ack...)."""

    error_name = "QueueInvariantError"


class NodeFailure(AutomationError):
    """A compute node / device was lost during an action (training fabric).

    Training flows route this through ``Catch`` into restore-and-reshard
    states — the elastic-scaling path.
    """

    error_name = "NodeFailure"


#: Errors that ``ErrorEquals: ["States.ALL"]`` matches.
WILDCARD = "States.ALL"


def error_matches(error_name: str, patterns: list[str]) -> bool:
    """ASL matching semantics: exact match or the States.ALL wildcard."""
    return WILDCARD in patterns or error_name in patterns
