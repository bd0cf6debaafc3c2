"""Globus automation services, reimplemented as an embeddable control plane.

The paper's four services — Flows, Queues, Triggers, Timers — plus the
action-provider API, the ASL-derived flow language, the authorization
delegation model, and a durable journaled engine.  This package is JAX-free;
the training fabric plugs in through action providers
(:mod:`repro.train.providers`).
"""

from .actions import ACTIVE, FAILED, SUCCEEDED, ActionProvider, ActionRegistry, ActionStatus
from .asl import Flow, parse as parse_flow
from .auth import AuthContext, AuthService, Caller, Identity, Tenant
from .clock import RealClock, VirtualClock
from .engine import (
    RUN_ACTIVE,
    RUN_CANCELLED,
    RUN_FAILED,
    RUN_SUCCEEDED,
    FlowEngine,
    PollingPolicy,
    Run,
    Scheduler,
)
from .errors import (
    ActionFailedException,
    ActionTimeout,
    AuthError,
    AutomationError,
    FlowValidationError,
    Forbidden,
    InputValidationError,
    NodeFailure,
    NotFound,
)
from .flows_service import FlowsService
from .journal import (
    Journal,
    TriggerImage,
    replay_triggers,
    segment_path,
)
from .queues import QueueService
from .admission import FairAdmission, StrideOrder, TokenBucket
from .shard_pool import EngineShardPool, PoolScheduler, shard_index
from .timers import TimerService
from .triggers import EventRouter, Trigger, TriggerConfig, TriggerService

__all__ = [
    "ACTIVE", "FAILED", "SUCCEEDED",
    "ActionProvider", "ActionRegistry", "ActionStatus",
    "Flow", "parse_flow",
    "AuthService", "AuthContext", "Caller", "Identity", "Tenant",
    "RealClock", "VirtualClock",
    "FairAdmission", "StrideOrder", "TokenBucket",
    "RUN_ACTIVE", "RUN_CANCELLED", "RUN_FAILED", "RUN_SUCCEEDED",
    "FlowEngine", "PollingPolicy", "Run", "Scheduler",
    "AutomationError", "ActionFailedException", "ActionTimeout", "AuthError",
    "FlowValidationError", "Forbidden", "InputValidationError", "NodeFailure",
    "NotFound",
    "FlowsService", "Journal", "QueueService", "TimerService",
    "EventRouter", "Trigger", "TriggerConfig", "TriggerService",
    "TriggerImage", "replay_triggers",
    "EngineShardPool", "PoolScheduler", "shard_index", "segment_path",
]
