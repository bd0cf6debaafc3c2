"""Built-in action providers (paper §4.5).

Echo, Transfer, Search, Email, User Selection, GenerateDOI, Compute (the
funcX analogue) — plus Sleep, the benchmarking workhorse used by the paper's
Figure 8 experiment ("a flow consisting of a single action that sleeps for a
specified period of time").

Training-fabric providers (Train/Checkpoint/Eval) live in
:mod:`repro.train.providers` so that :mod:`repro.core` stays JAX-free.
"""

from .echo import EchoProvider
from .sleep import SleepProvider
from .transfer import Endpoint, TransferProvider
from .compute import ComputeProvider
from .search import SearchProvider
from .email import EmailProvider
from .doi import DOIProvider
from .user_selection import UserSelectionProvider

__all__ = [
    "EchoProvider",
    "SleepProvider",
    "TransferProvider",
    "Endpoint",
    "ComputeProvider",
    "SearchProvider",
    "EmailProvider",
    "DOIProvider",
    "UserSelectionProvider",
    "builtin_registry",
]


def builtin_registry(clock=None, auth=None, workspace=None):
    """Construct an ActionRegistry with every built-in provider registered."""
    from ..actions import ActionRegistry

    registry = ActionRegistry()
    for cls in (
        EchoProvider,
        SleepProvider,
        SearchProvider,
        EmailProvider,
        DOIProvider,
        UserSelectionProvider,
        ComputeProvider,
    ):
        registry.register(cls(clock=clock, auth=auth))
    registry.register(TransferProvider(clock=clock, auth=auth, workspace=workspace))
    return registry
