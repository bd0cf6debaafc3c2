"""Compute action provider — the funcX analogue (paper §4.5).

"Request execution of a registered Python function on a remote computer":
functions are registered (-> ``function_id``), endpoints name executors, and
an action runs a function with arguments on an endpoint.

Execution modes per endpoint:

* ``inline``   — run during ``_start`` (deterministic; used with virtual
  clocks and for short functions);
* ``thread``   — run on the provider's worker pool; the action stays ACTIVE
  until the function returns (this is how JAX train steps run without
  blocking the engine's dispatcher).

A registered function may advertise a ``modeled_duration(args) -> seconds``
so that virtual-clock benchmarks account for compute time without burning
CPU (used by the Table 1 reproduction where Analyze took 7..2882 s).
"""

from __future__ import annotations

import secrets
import threading
from dataclasses import dataclass
from typing import Any, Callable

from ... import tracing as _tracing
from ..actions import FAILED, SUCCEEDED, ActionProvider, _Action
from ..auth import Identity
from ..errors import NodeFailure, NotFound


@dataclass
class ComputeFunction:
    function_id: str
    fn: Callable[..., Any]
    name: str = ""
    modeled_duration: Callable[[dict], float] | None = None


@dataclass
class ComputeEndpoint:
    endpoint_id: str
    name: str
    mode: str = "inline"  # "inline" | "thread"
    max_workers: int = 2


class ComputeProvider(ActionProvider):
    title = "Compute"
    subtitle = "Run a registered function on a compute endpoint (funcX analogue)"
    url = "ap://compute"
    scope_suffix = "compute"
    input_schema = {
        "type": "object",
        "properties": {
            "endpoint_id": {"type": "string"},
            "function_id": {"type": "string"},
            "kwargs": {"type": "object", "default": {}},
            "tasks": {
                "type": "array",
                "items": {
                    "type": "object",
                    "properties": {
                        "endpoint_id": {"type": "string"},
                        "function_id": {"type": "string"},
                        "kwargs": {"type": "object", "default": {}},
                    },
                    "required": ["endpoint_id", "function_id"],
                },
            },
        },
        "additionalProperties": True,
    }

    def __init__(self, clock=None, auth=None):
        super().__init__(clock=clock, auth=auth)
        self._functions: dict[str, ComputeFunction] = {}
        self._endpoints: dict[str, ComputeEndpoint] = {}
        self._reg_lock = threading.Lock()
        self._pools: dict[str, Any] = {}

    # -- registration ---------------------------------------------------------
    def register_function(
        self,
        fn: Callable[..., Any],
        name: str = "",
        modeled_duration: Callable[[dict], float] | None = None,
        function_id: str | None = None,
    ) -> str:
        fid = function_id or "fn-" + secrets.token_hex(6)
        with self._reg_lock:
            self._functions[fid] = ComputeFunction(
                fid, fn, name or getattr(fn, "__name__", "fn"), modeled_duration
            )
        return fid

    def register_endpoint(
        self, name: str, mode: str = "inline", max_workers: int = 2,
        endpoint_id: str | None = None,
    ) -> str:
        eid = endpoint_id or "ep-" + secrets.token_hex(6)
        with self._reg_lock:
            self._endpoints[eid] = ComputeEndpoint(eid, name, mode, max_workers)
        return eid

    def _function(self, fid: str) -> ComputeFunction:
        with self._reg_lock:
            f = self._functions.get(fid)
        if f is None:
            raise NotFound(f"unknown function {fid!r}")
        return f

    def _endpoint(self, eid: str) -> ComputeEndpoint:
        with self._reg_lock:
            ep = self._endpoints.get(eid)
        if ep is None:
            raise NotFound(f"unknown compute endpoint {eid!r}")
        return ep

    # -- the action --------------------------------------------------------------
    def _start(self, action: _Action, identity: Identity | None) -> None:
        tasks = action.body.get("tasks")
        if not tasks:
            tasks = [
                {
                    "endpoint_id": action.body["endpoint_id"],
                    "function_id": action.body["function_id"],
                    "kwargs": action.body.get("kwargs", {}),
                }
            ]
        # single-endpoint bundles (the paper notes client-instantiation cost
        # "is amortized if multiple functions are bundled in one request")
        endpoint = self._endpoint(tasks[0]["endpoint_id"])
        if endpoint.mode == "thread":
            self._run_threaded(action, endpoint, tasks)
        else:
            self._run_inline(action, endpoint, tasks)

    def _execute(self, tasks: list[dict]) -> tuple[list[Any], float]:
        results = []
        modeled = 0.0
        for t in tasks:
            f = self._function(t["function_id"])
            kwargs = t.get("kwargs", {})
            if f.modeled_duration is not None:
                modeled += float(f.modeled_duration(kwargs))
            with _tracing.span("compute.function", function=f.name):
                results.append(f.fn(**kwargs))
        return results, modeled

    def _run_inline(self, action: _Action, endpoint, tasks: list[dict]) -> None:
        try:
            results, modeled = self._execute(tasks)
        except NodeFailure as e:
            self._complete(
                action, FAILED, details={"error": str(e), "error_type": "NodeFailure"}
            )
            return
        except Exception as e:
            self._complete(
                action, FAILED, details={"error": f"{type(e).__name__}: {e}"}
            )
            return
        details = {"results": results, "endpoint": endpoint.name}
        if modeled > 0:
            action.details = details
            action.completes_at = self.clock.now() + modeled
            action.display_status = f"computing ({modeled:.1f}s modeled)"
        else:
            self._complete(action, SUCCEEDED, details=details)

    def _run_threaded(self, action: _Action, endpoint, tasks: list[dict]) -> None:
        from concurrent.futures import ThreadPoolExecutor

        with self._reg_lock:
            pool = self._pools.get(endpoint.endpoint_id)
            if pool is None:
                pool = self._pools[endpoint.endpoint_id] = ThreadPoolExecutor(
                    max_workers=endpoint.max_workers,
                    thread_name_prefix=f"compute-{endpoint.name}",
                )
        action.display_status = f"queued on {endpoint.name}"

        def work():
            try:
                results, _ = self._execute(tasks)
            except NodeFailure as e:
                self._complete(
                    action,
                    FAILED,
                    details={"error": str(e), "error_type": "NodeFailure"},
                )
            except Exception as e:
                self._complete(
                    action, FAILED, details={"error": f"{type(e).__name__}: {e}"}
                )
            else:
                self._complete(
                    action,
                    SUCCEEDED,
                    details={"results": results, "endpoint": endpoint.name},
                )

        pool.submit(work)
