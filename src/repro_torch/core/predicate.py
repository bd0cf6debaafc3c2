"""Safe Python-like expression language for trigger predicates/transforms.

Paper §5.5: *"The predicate is a Boolean expression written in a Python-like
syntax that may evaluate any properties of the incoming message"* and the
action-input transformation uses the same syntax, e.g.::

    predicate : filename.endswith(".tiff") and size > 1024
    transform : number_of_files = len(files)

We parse with :mod:`ast` and enforce a strict whitelist — no attribute
access to dunders, no imports, no calls except whitelisted builtins and
whitelisted methods on str/list/dict values.

The expression is **compiled once** into a tree of closures
(:func:`compile_expr` → :class:`CompiledExpr`): the AST is walked a single
time at compile, every structural decision (operator lookup, constant
checks, dunder rejection, syntax whitelisting) is made then, and each
evaluation just calls the closure tree with the message's name bindings.
An :class:`EventRouter` evaluating a predicate per event therefore pays no
per-event ``ast`` traversal.  String entry points compile through an LRU
cache, so even uncompiled callers parse a given source at most once.
"""

from __future__ import annotations

import ast
from functools import lru_cache
from typing import Any, Callable, Mapping

from .errors import AutomationError


class PredicateError(AutomationError):
    error_name = "PredicateError"


_ALLOWED_BUILTINS: dict[str, Any] = {
    "len": len,
    "abs": abs,
    "min": min,
    "max": max,
    "sum": sum,
    "any": any,
    "all": all,
    "int": int,
    "float": float,
    "str": str,
    "bool": bool,
    "round": round,
    "sorted": sorted,
}

#: identity set for the call whitelist (functions are hashable)
_BUILTIN_VALUES = frozenset(id(fn) for fn in _ALLOWED_BUILTINS.values())

_ALLOWED_METHODS: dict[type, set[str]] = {
    str: {
        "endswith", "startswith", "lower", "upper", "strip", "lstrip",
        "rstrip", "split", "rsplit", "join", "replace", "find", "count",
        "format", "title", "zfill", "isdigit", "isalpha",
    },
    list: {"count", "index", "copy"},
    tuple: {"count", "index"},
    dict: {"get", "keys", "values", "items", "copy"},
}

_MAX_DEPTH = 64

_Env = Mapping[str, Any]
_Fn = Callable[[_Env], Any]


class CompiledExpr:
    """A compiled, reusable expression evaluator.

    Stateless and thread-safe: evaluation only reads the closure tree, so
    one compiled predicate serves every event (and every router thread)
    concurrently.
    """

    __slots__ = ("source", "_fn")

    def __init__(self, source: str, fn: _Fn):
        self.source = source
        self._fn = fn

    def __call__(self, names: _Env) -> Any:
        return self._fn(names)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CompiledExpr({self.source!r})"


# --------------------------------------------------------------------------
# the compiler: one AST walk -> a tree of closures
# --------------------------------------------------------------------------

_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Mod: lambda a, b: a % b,
    ast.Pow: lambda a, b: a ** b if abs(b) < 64 else _pow_guard(),
}

_CMPOPS = {
    ast.Eq: lambda a, b: a == b,
    ast.NotEq: lambda a, b: a != b,
    ast.Lt: lambda a, b: a < b,
    ast.LtE: lambda a, b: a <= b,
    ast.Gt: lambda a, b: a > b,
    ast.GtE: lambda a, b: a >= b,
    ast.In: lambda a, b: a in b,
    ast.NotIn: lambda a, b: a not in b,
    ast.Is: lambda a, b: a is b,
    ast.IsNot: lambda a, b: a is not b,
}


def _pow_guard():
    raise PredicateError("exponent too large")


def _compile_node(node: ast.AST, depth: int) -> _Fn:
    if depth > _MAX_DEPTH:
        raise PredicateError("expression too deeply nested")
    depth += 1

    if isinstance(node, ast.Expression):
        return _compile_node(node.body, depth)

    if isinstance(node, ast.Constant):
        value = node.value
        if isinstance(value, (str, int, float, bool, type(None))):
            return lambda env: value
        raise PredicateError(f"disallowed constant {value!r}")

    if isinstance(node, ast.Name):
        name = node.id
        builtin = _ALLOWED_BUILTINS.get(name)

        def load_name(env: _Env) -> Any:
            if name in env:
                return env[name]
            if builtin is not None:
                return builtin
            raise PredicateError(f"unknown name {name!r}")

        return load_name

    if isinstance(node, ast.List):
        parts = [_compile_node(e, depth) for e in node.elts]
        return lambda env: [fn(env) for fn in parts]

    if isinstance(node, ast.Tuple):
        parts = [_compile_node(e, depth) for e in node.elts]
        return lambda env: tuple(fn(env) for fn in parts)

    if isinstance(node, ast.Dict):
        pairs = [
            (_compile_node(k, depth), _compile_node(v, depth))
            for k, v in zip(node.keys, node.values)
        ]
        return lambda env: {k(env): v(env) for k, v in pairs}

    if isinstance(node, ast.Set):
        parts = [_compile_node(e, depth) for e in node.elts]
        return lambda env: {fn(env) for fn in parts}

    if isinstance(node, ast.BoolOp):
        parts = [_compile_node(v, depth) for v in node.values]
        if isinstance(node.op, ast.And):

            def eval_and(env: _Env) -> Any:
                result = True
                for fn in parts:
                    result = fn(env)
                    if not result:
                        return result
                return result

            return eval_and

        def eval_or(env: _Env) -> Any:
            result = False
            for fn in parts:
                result = fn(env)
                if result:
                    return result
            return result

        return eval_or

    if isinstance(node, ast.UnaryOp):
        operand = _compile_node(node.operand, depth)
        if isinstance(node.op, ast.Not):
            return lambda env: not operand(env)
        if isinstance(node.op, ast.USub):
            return lambda env: -operand(env)
        if isinstance(node.op, ast.UAdd):
            return lambda env: +operand(env)
        raise PredicateError("disallowed unary operator")

    if isinstance(node, ast.BinOp):
        fn = _BINOPS.get(type(node.op))
        if fn is None:
            raise PredicateError("disallowed binary operator")
        left = _compile_node(node.left, depth)
        right = _compile_node(node.right, depth)
        return lambda env: fn(left(env), right(env))

    if isinstance(node, ast.Compare):
        left = _compile_node(node.left, depth)
        chain = []
        for op, right_node in zip(node.ops, node.comparators):
            fn = _CMPOPS.get(type(op))
            if fn is None:
                raise PredicateError("disallowed comparison")
            chain.append((fn, _compile_node(right_node, depth)))

        def eval_compare(env: _Env) -> bool:
            value = left(env)
            for fn, right_fn in chain:
                right = right_fn(env)
                if not fn(value, right):
                    return False
                value = right
            return True

        return eval_compare

    if isinstance(node, ast.IfExp):
        test = _compile_node(node.test, depth)
        body = _compile_node(node.body, depth)
        orelse = _compile_node(node.orelse, depth)
        return lambda env: body(env) if test(env) else orelse(env)

    if isinstance(node, ast.Attribute):
        attr = node.attr
        if attr.startswith("_"):
            raise PredicateError(f"disallowed attribute {attr!r}")
        value_fn = _compile_node(node.value, depth)

        def load_attr(env: _Env) -> Any:
            obj = value_fn(env)
            if isinstance(obj, dict):
                # message properties are dicts; allow dotted access sugar
                if attr in obj:
                    return obj[attr]
            for typ, allowed in _ALLOWED_METHODS.items():
                if isinstance(obj, typ) and attr in allowed:
                    return getattr(obj, attr)
            raise PredicateError(
                f"attribute {attr!r} not allowed on {type(obj).__name__}"
            )

        return load_attr

    if isinstance(node, ast.Subscript):
        value_fn = _compile_node(node.value, depth)
        key_fn = _compile_node(node.slice, depth)

        def load_item(env: _Env) -> Any:
            try:
                return value_fn(env)[key_fn(env)]
            except (KeyError, IndexError, TypeError) as e:
                raise PredicateError(f"subscript failed: {e}") from None

        return load_item

    if isinstance(node, ast.Slice):
        lower = _compile_node(node.lower, depth) if node.lower else None
        upper = _compile_node(node.upper, depth) if node.upper else None
        step = _compile_node(node.step, depth) if node.step else None
        return lambda env: slice(
            lower(env) if lower else None,
            upper(env) if upper else None,
            step(env) if step else None,
        )

    if isinstance(node, ast.Call):
        if node.keywords:
            raise PredicateError("keyword arguments not allowed")
        func_fn = _compile_node(node.func, depth)
        arg_fns = [_compile_node(a, depth) for a in node.args]

        def call(env: _Env) -> Any:
            fn = func_fn(env)
            args = [a(env) for a in arg_fns]
            if id(fn) in _BUILTIN_VALUES:
                return fn(*args)
            # bound methods resolved by the Attribute whitelist
            if callable(fn) and getattr(fn, "__self__", None) is not None:
                return fn(*args)
            raise PredicateError("call of non-whitelisted function")

        return call

    raise PredicateError(f"disallowed syntax: {type(node).__name__}")


@lru_cache(maxsize=4096)
def _compile_cached(source: str) -> CompiledExpr:
    try:
        tree = ast.parse(source, mode="eval")
    except SyntaxError as e:
        raise PredicateError(f"syntax error in expression {source!r}: {e}") from None
    return CompiledExpr(source, _compile_node(tree, 0))


def compile_expr(source: str) -> CompiledExpr:
    """Compile an expression once into a reusable evaluator closure."""
    return _compile_cached(source)


def evaluate(source_or_expr: str | CompiledExpr | ast.Expression, names: _Env) -> Any:
    """Evaluate an expression against event/message properties."""
    if isinstance(source_or_expr, str):
        return _compile_cached(source_or_expr)(names)
    if isinstance(source_or_expr, CompiledExpr):
        return source_or_expr(names)
    if isinstance(source_or_expr, ast.Expression):
        # pre-compiled-AST callers from before the closure compiler
        return _compile_node(source_or_expr, 0)(names)
    raise PredicateError(f"not an expression: {source_or_expr!r}")


def matches(predicate: str | CompiledExpr | ast.Expression, message: _Env) -> bool:
    """Evaluate a trigger predicate; any error -> no match (event discarded)."""
    try:
        return bool(evaluate(predicate, message))
    except PredicateError:
        return False


def compile_transform(
    assignments: Mapping[str, str],
) -> Callable[[_Env], dict]:
    """Compile a transform's assignment expressions once (paper §5.5).

    Returns ``fn(message) -> action_input``.  A compile error propagates as
    :class:`PredicateError` — callers that must tolerate bad expressions
    per-message (the router's permanent-error disposition) fall back to
    :func:`transform`.
    """
    compiled = [
        (name, _compile_cached(expr)) for name, expr in assignments.items()
    ]
    return lambda message: {name: fn(message) for name, fn in compiled}


def transform(assignments: Mapping[str, str], message: _Env) -> dict:
    """Build an action input from a message (paper §5.5 transformation).

    ``assignments`` maps output parameter names to expressions over the
    message, e.g. ``{"number_of_files": "len(files)"}``.
    """
    out = {}
    for name, expr in assignments.items():
        out[name] = evaluate(expr, message)
    return out
