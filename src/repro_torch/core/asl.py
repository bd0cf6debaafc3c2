"""The declarative flow-definition language (paper §4.2.1).

A flow definition is a JSON document extending the Amazon States Language:
``StartAt`` plus a map of named ``States``.  Five state types come from the
paper — four essentially unchanged from ASL (``Choice``, ``Pass``, ``Fail``,
``Wait``) plus ``Action`` which invokes an action provider.  We additionally
support ``Succeed`` (explicit normal termination), ``Retry`` clauses, and a
``Parallel`` state (branch fan-out/join) — the latter two are ASL-standard
extensions beyond the paper, used by the training flows for concurrent data
staging; they are validated and executed with ASL semantics.

A ``Map`` state provides *dynamic* data-parallel fan-out — the paper's
flagship flows (SSX, XPCS, §4) are all "for each new file: transfer,
analyze, catalog" over collections whose size is only known at run time,
which static ``Parallel`` branches cannot express.  ``ItemsPath`` selects
the item list from the Context, ``Iterator`` is the sub-flow applied to
each item, ``ItemSelector`` shapes each item's input, and
``MaxConcurrency`` bounds how many items run at once (a sliding admission
window — see docs/ARCHITECTURE.md invariant 8).

This module validates definitions at publish time (the paper's Flows service
"validates the flow definition and input schema" before deployment) and
compiles them to typed state objects the engine executes.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Any, Callable

from . import context as ctx
from . import jsonpath
from .errors import FlowValidationError, StateMachineError

STATE_TYPES = (
    "Action", "Pass", "Choice", "Wait", "Fail", "Succeed", "Parallel", "Map"
)

_NUMERIC = (int, float)


# --------------------------------------------------------------------------
# Choice rules
# --------------------------------------------------------------------------

_DATA_TESTS = {
    "StringEquals": lambda v, x: isinstance(v, str) and v == x,
    "StringLessThan": lambda v, x: isinstance(v, str) and v < x,
    "StringGreaterThan": lambda v, x: isinstance(v, str) and v > x,
    "StringLessThanEquals": lambda v, x: isinstance(v, str) and v <= x,
    "StringGreaterThanEquals": lambda v, x: isinstance(v, str) and v >= x,
    "StringMatches": lambda v, x: isinstance(v, str) and fnmatch.fnmatchcase(v, x),
    "NumericEquals": lambda v, x: _is_num(v) and v == x,
    "NumericLessThan": lambda v, x: _is_num(v) and v < x,
    "NumericGreaterThan": lambda v, x: _is_num(v) and v > x,
    "NumericLessThanEquals": lambda v, x: _is_num(v) and v <= x,
    "NumericGreaterThanEquals": lambda v, x: _is_num(v) and v >= x,
    "BooleanEquals": lambda v, x: isinstance(v, bool) and v == x,
    "IsNull": lambda v, x: (v is None) == x,
    "IsPresent": None,  # special-cased: tests path existence
    "IsNumeric": lambda v, x: _is_num(v) == x,
    "IsString": lambda v, x: isinstance(v, str) == x,
    "IsBoolean": lambda v, x: isinstance(v, bool) == x,
}


def _is_num(v: Any) -> bool:
    return isinstance(v, _NUMERIC) and not isinstance(v, bool)


_ABSENT = object()


@dataclass
class ChoiceRule:
    """One rule in a Choice state; either a data test or a combinator.

    ``asl.parse`` compiles every rule once into a reusable evaluator
    closure (selectors pre-parsed, test function pre-resolved); a rule
    built by hand compiles itself lazily on first :meth:`evaluate`.
    """

    next: str | None = None  # only on top-level rules
    variable: str | None = None
    test: str | None = None
    expected: Any = None
    combinator: str | None = None  # "And" | "Or" | "Not"
    children: list["ChoiceRule"] = field(default_factory=list)
    #: compiled evaluator (built by :meth:`compiled`; excluded from eq/repr)
    _eval: Callable[[Any], bool] | None = field(
        default=None, repr=False, compare=False
    )

    def compiled(self) -> Callable[[Any], bool]:
        fn = self._eval
        if fn is None:
            fn = self._eval = self._compile()
        return fn

    def _compile(self) -> Callable[[Any], bool]:
        if self.combinator == "And":
            parts = [c.compiled() for c in self.children]
            return lambda context: all(fn(context) for fn in parts)
        if self.combinator == "Or":
            parts = [c.compiled() for c in self.children]
            return lambda context: any(fn(context) for fn in parts)
        if self.combinator == "Not":
            child = self.children[0].compiled()
            return lambda context: not child(context)
        sel = jsonpath.compile_path(self.variable)
        expected = self.expected
        if self.test == "IsPresent":
            return lambda context: sel.exists(context) == expected
        if self.test.endswith("Path"):
            # "...Path" variants compare against another context location
            exp_sel = jsonpath.compile_path(expected)
            fn = _DATA_TESTS[self.test[:-4]]

            def eval_path(context: Any) -> bool:
                value = sel.get(context, default=_ABSENT)
                if value is _ABSENT:
                    return False
                return bool(fn(value, exp_sel.get(context)))

            return eval_path
        fn = _DATA_TESTS[self.test]

        def eval_data(context: Any) -> bool:
            value = sel.get(context, default=_ABSENT)
            if value is _ABSENT:
                return False
            return bool(fn(value, expected))

        return eval_data

    def evaluate(self, context: Any) -> bool:
        return self.compiled()(context)


def _parse_choice_rule(doc: dict, where: str, top: bool) -> ChoiceRule:
    if not isinstance(doc, dict):
        raise FlowValidationError(f"{where}: choice rule must be an object")
    nxt = doc.get("Next")
    if top and not isinstance(nxt, str):
        raise FlowValidationError(f"{where}: top-level choice rule needs Next")
    if not top and nxt is not None:
        raise FlowValidationError(f"{where}: nested choice rule may not have Next")
    for comb in ("And", "Or", "Not"):
        if comb in doc:
            sub = doc[comb]
            if comb == "Not":
                sub = [sub]
            if not isinstance(sub, list) or not sub:
                raise FlowValidationError(f"{where}: {comb} needs rule(s)")
            return ChoiceRule(
                next=nxt,
                combinator=comb,
                children=[
                    _parse_choice_rule(s, f"{where}/{comb}[{i}]", top=False)
                    for i, s in enumerate(sub)
                ],
            )
    variable = doc.get("Variable")
    if not isinstance(variable, str) or not variable.startswith("$"):
        raise FlowValidationError(f"{where}: Variable must be a JSONPath")
    tests = [
        k
        for k in doc
        if k in _DATA_TESTS or (k.endswith("Path") and k[:-4] in _DATA_TESTS)
    ]
    if len(tests) != 1:
        raise FlowValidationError(
            f"{where}: exactly one comparison operator required, got {tests}"
        )
    return ChoiceRule(next=nxt, variable=variable, test=tests[0], expected=doc[tests[0]])


# --------------------------------------------------------------------------
# States
# --------------------------------------------------------------------------


@dataclass
class RetryRule:
    error_equals: list[str]
    interval_seconds: float = 1.0
    max_attempts: int = 3
    backoff_rate: float = 2.0
    #: ceiling on the exponential backoff curve (None = uncapped)
    max_delay_seconds: float | None = None
    #: "NONE" (exact exponential delays) or "FULL" (each delay is drawn
    #: uniformly from [0, capped delay) — decorrelates the retry storms a
    #: mass provider outage would otherwise synchronize).  The draw is a
    #: deterministic hash of (run, state, attempt), so virtual-clock
    #: schedules replay identically.
    jitter_strategy: str = "NONE"


@dataclass
class CatchRule:
    error_equals: list[str]
    next: str
    result_path: str | None = None
    #: compiled ResultPath writer (lazy; excluded from eq/repr)
    _writer: Callable[[dict, Any], dict] | None = field(
        default=None, repr=False, compare=False
    )

    def write_result(self, context: dict, error_doc: Any) -> dict:
        fn = self._writer
        if fn is None:
            fn = self._writer = ctx.compile_result_writer(self.result_path)
        return fn(context, error_doc)


@dataclass
class State:
    name: str
    kind: str
    comment: str = ""
    next: str | None = None
    end: bool = False
    # Action
    action_url: str | None = None
    parameters: Any = None
    input_path: str | None = None
    result_path: str | None = None
    result: Any = None  # Pass only
    wait_time: float | None = None  # action timeout (paper: WaitTime)
    run_as: str | None = None
    exception_on_action_failure: bool = True
    retry: list[RetryRule] = field(default_factory=list)
    catch: list[CatchRule] = field(default_factory=list)
    # Choice
    choices: list[ChoiceRule] = field(default_factory=list)
    default: str | None = None
    # Wait
    seconds: float | None = None
    seconds_path: str | None = None
    # Fail
    error: str = "States.Error"
    cause: str = ""
    # Parallel
    branches: list["Flow"] = field(default_factory=list)
    # Map
    iterator: "Flow | None" = None
    items_path: str | None = None
    item_selector: Any = None
    max_concurrency: int = 0  # 0 = unbounded
    tolerated_failures: int = 0  # fail-fast by default

    # -- compiled execution plan (built once by asl.parse; lazily rebuilt
    # -- for hand-constructed states; excluded from eq/repr) ----------------
    _input_fn: Callable[[Any], Any] | None = field(
        default=None, repr=False, compare=False
    )
    _result_fn: Callable[[dict, Any], dict] | None = field(
        default=None, repr=False, compare=False
    )
    _seconds_sel: jsonpath.Selector | None = field(
        default=None, repr=False, compare=False
    )
    _items_sel: jsonpath.Selector | None = field(
        default=None, repr=False, compare=False
    )
    _item_fn: Callable[[Any, Any, int], dict] | None = field(
        default=None, repr=False, compare=False
    )

    def compile_plan(self) -> None:
        """Pre-compile every JSONPath/template this state touches.

        Called by ``asl.parse`` so the engine's per-transition hot path
        resolves selectors and closures instead of re-parsing strings.
        """
        self._input_fn = ctx.compile_state_input(self.input_path, self.parameters)
        self._result_fn = ctx.compile_result_writer(self.result_path)
        if self.seconds_path is not None:
            self._seconds_sel = jsonpath.compile_path(self.seconds_path)
        if self.kind == "Map":
            self._items_sel = jsonpath.compile_path(self.items_path or "$")
            self._item_fn = ctx.compile_item_selector(self.item_selector)
        for rule in self.choices:
            rule.compiled()
        for rule in self.catch:
            if rule._writer is None:
                rule._writer = ctx.compile_result_writer(rule.result_path)

    def input_for(self, context: Any) -> Any:
        """Effective state input (compiled InputPath + Parameters plan)."""
        fn = self._input_fn
        if fn is None:
            fn = self._input_fn = ctx.compile_state_input(
                self.input_path, self.parameters
            )
        return fn(context)

    def write_result(self, context: dict, result: Any) -> dict:
        """Apply this state's ResultPath to the Context (compiled writer)."""
        fn = self._result_fn
        if fn is None:
            fn = self._result_fn = ctx.compile_result_writer(self.result_path)
        return fn(context, result)

    def wait_seconds(self, context: Any) -> float:
        """Effective wait duration.

        A literal ``Seconds`` was validated at publish time; a
        ``SecondsPath`` resolves against the run context and can only be
        validated here, at run time — a non-numeric or negative value fails
        the state (States.Runtime), subject to its Retry/Catch clauses.
        """
        if self.seconds is not None:
            return float(self.seconds)
        sel = self._seconds_sel
        if sel is None:
            sel = self._seconds_sel = jsonpath.compile_path(self.seconds_path)
        value = sel.get(context)
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise StateMachineError(
                f"Wait {self.name}: SecondsPath {self.seconds_path!r} "
                f"resolved to {value!r}, not a number"
            )
        if value < 0:
            raise StateMachineError(
                f"Wait {self.name}: SecondsPath {self.seconds_path!r} "
                f"resolved to {value!r}, which is negative"
            )
        return float(value)

    # -- Map helpers (compiled ItemsPath / ItemSelector plans) ---------------
    def items_for(self, doc: Any) -> Any:
        """Resolve ``ItemsPath`` against the state's effective input."""
        sel = self._items_sel
        if sel is None:
            sel = self._items_sel = jsonpath.compile_path(self.items_path or "$")
        return sel.get(doc, default=None)

    def item_input(self, doc: Any, item: Any, index: int) -> dict:
        """Build one item's child-run input (compiled ItemSelector plan)."""
        fn = self._item_fn
        if fn is None:
            fn = self._item_fn = ctx.compile_item_selector(self.item_selector)
        return fn(doc, item, index)


@dataclass
class Flow:
    start_at: str
    states: dict[str, State]
    comment: str = ""
    definition: dict = field(default_factory=dict)

    def state(self, name: str) -> State:
        return self.states[name]


def _opt(doc: dict, key: str, types, where: str, default=None):
    value = doc.get(key, default)
    if value is not None and not isinstance(value, types):
        raise FlowValidationError(f"{where}: {key} must be {types}")
    return value


def _parse_catch(doc: dict, where: str) -> list[CatchRule]:
    """Shared Catch-clause parsing (Action / Parallel / Map states)."""
    rules: list[CatchRule] = []
    for i, c in enumerate(doc.get("Catch", []) or []):
        if not isinstance(c, dict) or "ErrorEquals" not in c or "Next" not in c:
            raise FlowValidationError(
                f"{where}/Catch[{i}]: needs ErrorEquals and Next"
            )
        rules.append(
            CatchRule(
                error_equals=list(c["ErrorEquals"]),
                next=c["Next"],
                result_path=c.get("ResultPath"),
            )
        )
    return rules


def _parse_retry(doc: dict, where: str) -> list[RetryRule]:
    """Shared Retry-clause parsing (Action / Map states)."""
    rules: list[RetryRule] = []
    for i, r in enumerate(doc.get("Retry", []) or []):
        if not isinstance(r, dict):
            raise FlowValidationError(f"{where}/Retry[{i}]: must be an object")
        max_delay = r.get("MaxDelaySeconds")
        if max_delay is not None:
            if isinstance(max_delay, bool) or not isinstance(
                max_delay, (int, float)
            ):
                raise FlowValidationError(
                    f"{where}/Retry[{i}]: MaxDelaySeconds must be a "
                    f"number, got {max_delay!r}"
                )
            max_delay = float(max_delay)
            if max_delay <= 0:
                raise FlowValidationError(
                    f"{where}/Retry[{i}]: MaxDelaySeconds must be > 0, "
                    f"got {max_delay}"
                )
        jitter = r.get("JitterStrategy", "NONE")
        if jitter not in ("NONE", "FULL"):
            raise FlowValidationError(
                f"{where}/Retry[{i}]: JitterStrategy must be "
                f"'NONE' or 'FULL', got {jitter!r}"
            )
        rules.append(
            RetryRule(
                error_equals=list(r.get("ErrorEquals", ["States.ALL"])),
                interval_seconds=float(r.get("IntervalSeconds", 1.0)),
                max_attempts=int(r.get("MaxAttempts", 3)),
                backoff_rate=float(r.get("BackoffRate", 2.0)),
                max_delay_seconds=max_delay,
                jitter_strategy=jitter,
            )
        )
    return rules


def _parse_state(name: str, doc: dict, where: str) -> State:
    if not isinstance(doc, dict):
        raise FlowValidationError(f"{where}: state must be an object")
    kind = doc.get("Type")
    if kind == "Task":  # ASL alias accepted for Action
        kind = "Action"
    if kind not in STATE_TYPES:
        raise FlowValidationError(f"{where}: unknown state Type {doc.get('Type')!r}")
    st = State(name=name, kind=kind, comment=_opt(doc, "Comment", str, where, "") or "")

    terminal = kind in ("Fail", "Succeed")
    st.next = _opt(doc, "Next", str, where)
    st.end = bool(doc.get("End", False))
    if terminal:
        if st.next or st.end:
            raise FlowValidationError(f"{where}: terminal state takes no Next/End")
    elif kind != "Choice":
        if bool(st.next) == bool(st.end):
            raise FlowValidationError(f"{where}: exactly one of Next/End required")

    if kind == "Action":
        st.action_url = _opt(doc, "ActionUrl", str, where) or _opt(
            doc, "Resource", str, where
        )
        if not st.action_url:
            raise FlowValidationError(f"{where}: Action state requires ActionUrl")
        st.parameters = doc.get("Parameters")
        st.input_path = _opt(doc, "InputPath", str, where)
        st.result_path = _opt(doc, "ResultPath", str, where)
        st.wait_time = _opt(doc, "WaitTime", _NUMERIC, where)
        st.run_as = _opt(doc, "RunAs", str, where)
        st.exception_on_action_failure = bool(
            doc.get("ExceptionOnActionFailure", True)
        )
        st.retry = _parse_retry(doc, where)
        st.catch = _parse_catch(doc, where)
    elif kind == "Pass":
        st.parameters = doc.get("Parameters")
        st.result = doc.get("Result")
        st.input_path = _opt(doc, "InputPath", str, where)
        st.result_path = _opt(doc, "ResultPath", str, where)
    elif kind == "Choice":
        rules = doc.get("Choices")
        if not isinstance(rules, list) or not rules:
            raise FlowValidationError(f"{where}: Choice requires Choices rules")
        st.choices = [
            _parse_choice_rule(r, f"{where}/Choices[{i}]", top=True)
            for i, r in enumerate(rules)
        ]
        st.default = _opt(doc, "Default", str, where)
        if st.next or st.end:
            raise FlowValidationError(f"{where}: Choice takes no Next/End")
    elif kind == "Wait":
        st.seconds = _opt(doc, "Seconds", _NUMERIC, where)
        # publish-time validation: a literal Seconds is fully known when the
        # flow is deployed, so a bad value must fail deployment, not the run
        if isinstance(st.seconds, bool):
            raise FlowValidationError(
                f"{where}: Seconds must be a number, not a boolean"
            )
        if st.seconds is not None and st.seconds < 0:
            raise FlowValidationError(f"{where}: Seconds must be >= 0")
        st.seconds_path = _opt(doc, "SecondsPath", str, where)
        if (st.seconds is None) == (st.seconds_path is None):
            raise FlowValidationError(
                f"{where}: Wait requires exactly one of Seconds/SecondsPath"
            )
        # a SecondsPath can only fail at run time (the context is unknown
        # here), so Wait supports Retry/Catch for that States.Runtime
        st.retry = _parse_retry(doc, where)
        st.catch = _parse_catch(doc, where)
    elif kind == "Fail":
        st.error = _opt(doc, "Error", str, where, "States.Error") or "States.Error"
        st.cause = _opt(doc, "Cause", str, where, "") or ""
    elif kind == "Parallel":
        branches = doc.get("Branches")
        if not isinstance(branches, list) or not branches:
            raise FlowValidationError(f"{where}: Parallel requires Branches")
        st.branches = [
            parse(b, where=f"{where}/Branches[{i}]") for i, b in enumerate(branches)
        ]
        st.result_path = _opt(doc, "ResultPath", str, where)
        st.parameters = doc.get("Parameters")
        st.catch = _parse_catch(doc, where)
    elif kind == "Map":
        iterator = doc.get("Iterator", doc.get("ItemProcessor"))
        if not isinstance(iterator, dict):
            raise FlowValidationError(f"{where}: Map requires an Iterator flow")
        st.iterator = parse(iterator, where=f"{where}/Iterator")
        st.items_path = _opt(doc, "ItemsPath", str, where, "$") or "$"
        if not st.items_path.startswith("$"):
            raise FlowValidationError(f"{where}: ItemsPath must be a JSONPath")
        st.input_path = _opt(doc, "InputPath", str, where)
        st.result_path = _opt(doc, "ResultPath", str, where)
        # ItemSelector shapes each item's input; "Parameters" is accepted as
        # the legacy ASL alias (it is NOT the Action-style state Parameters)
        st.item_selector = doc.get("ItemSelector", doc.get("Parameters"))
        mc = doc.get("MaxConcurrency", 0)
        if not isinstance(mc, int) or isinstance(mc, bool) or mc < 0:
            raise FlowValidationError(
                f"{where}: MaxConcurrency must be an integer >= 0 (0 = unbounded)"
            )
        st.max_concurrency = mc
        tol = doc.get("ToleratedFailureCount", 0)
        if not isinstance(tol, int) or isinstance(tol, bool) or tol < 0:
            raise FlowValidationError(
                f"{where}: ToleratedFailureCount must be an integer >= 0"
            )
        st.tolerated_failures = tol
        st.retry = _parse_retry(doc, where)
        st.catch = _parse_catch(doc, where)
    try:
        st.compile_plan()
    except jsonpath.JSONPathError as e:
        # a malformed path is a publish-time validation error, not a
        # run-time States.ParameterPathFailure
        raise FlowValidationError(f"{where}: {e}") from None
    return st


def parse(definition: dict, where: str = "flow") -> Flow:
    """Validate and compile a flow definition document."""
    if not isinstance(definition, dict):
        raise FlowValidationError(f"{where}: definition must be an object")
    start_at = definition.get("StartAt")
    states_doc = definition.get("States")
    if not isinstance(start_at, str):
        raise FlowValidationError(f"{where}: StartAt is required")
    if not isinstance(states_doc, dict) or not states_doc:
        raise FlowValidationError(f"{where}: States map is required")
    states = {
        name: _parse_state(name, doc, f"{where}/States/{name}")
        for name, doc in states_doc.items()
    }
    flow = Flow(
        start_at=start_at,
        states=states,
        comment=str(definition.get("Comment", "")),
        definition=definition,
    )
    _check_graph(flow, where)
    return flow


def _check_graph(flow: Flow, where: str) -> None:
    names = set(flow.states)
    if flow.start_at not in names:
        raise FlowValidationError(f"{where}: StartAt {flow.start_at!r} not in States")

    def targets(st: State) -> list[str]:
        out = []
        if st.next:
            out.append(st.next)
        out.extend(r.next for r in st.choices if r.next)
        if st.default:
            out.append(st.default)
        out.extend(c.next for c in st.catch)
        return out

    for st in flow.states.values():
        for t in targets(st):
            if t not in names:
                raise FlowValidationError(
                    f"{where}/States/{st.name}: transition to unknown state {t!r}"
                )
    # reachability (unreachable states are a validation error, like ASF)
    seen: set[str] = set()
    stack = [flow.start_at]
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(t for t in targets(flow.states[cur]) if t not in seen)
    unreachable = names - seen
    if unreachable:
        raise FlowValidationError(
            f"{where}: unreachable states: {sorted(unreachable)}"
        )


def action_urls(flow: Flow) -> list[str]:
    """All action-provider URLs a flow references (incl. Parallel branches).

    The Flows service uses this at publish time to register the flow's scope
    with each provider's scope as a *dependent scope* (paper §5.3.1).
    """
    urls: list[str] = []

    def walk(f: Flow) -> None:
        for st in f.states.values():
            if st.kind == "Action" and st.action_url not in urls:
                urls.append(st.action_url)
            for b in st.branches:
                walk(b)
            if st.iterator is not None:
                walk(st.iterator)

    walk(flow)
    return urls


def run_as_roles(flow: Flow) -> list[str]:
    """Distinct RunAs roles referenced by the flow (paper §4.2.1)."""
    roles: list[str] = []

    def walk(f: Flow) -> None:
        for st in f.states.values():
            if st.run_as and st.run_as not in roles:
                roles.append(st.run_as)
            for b in st.branches:
                walk(b)
            if st.iterator is not None:
                walk(st.iterator)

    walk(flow)
    return roles
