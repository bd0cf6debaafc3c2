"""Run Context handling (paper §4.2.2).

Each run of a flow has a *Context* — a JSON document initialized with the
run's input.  States read from it (``InputPath`` / ``Parameters`` with
JSONPath references) and write to it (``ResultPath``), and the final Context
is returned to whoever invoked the flow.

Parameter templates follow both conventions found in the paper's examples:

* ASL style — keys ending in ``.$`` take a JSONPath value that is resolved
  against the Context (``"tasks.$": "$.input.tasks"``);
* paper §4.2.1 style — plain string values with a ``$.`` prefix are treated
  as JSONPath references ("The prefix ``$.`` on these values signals that
  they should be treated as JSONPath references into the run Context").
  A value may opt out with a ``\\$`` escape.

Everything here comes in two tiers, like :mod:`repro.core.jsonpath`:

* :func:`compile_parameters` / :func:`compile_state_input` /
  :func:`compile_result_writer` walk a template **once** at flow-publish
  time and return closures the engine calls per transition — no per-event
  template walking, key-suffix checking, or path parsing on the hot path;
* :func:`evaluate_parameters` / :func:`state_input` / :func:`apply_result`
  keep the original document-at-a-time API (now thin wrappers that compile
  through the jsonpath LRU cache).
"""

from __future__ import annotations

import copy
from typing import Any, Callable

from . import jsonpath


# --------------------------------------------------------------------------
# compiled tier: template -> closure, built once per flow definition
# --------------------------------------------------------------------------

def compile_parameters(template: Any) -> Callable[[Any], Any]:
    """Compile a Parameters template into ``fn(context) -> document``.

    The template structure (dict shapes, ``.$`` suffixes, reference
    detection, escapes) is resolved at compile time; the returned closure
    only resolves selectors and deep-copies referenced values.
    """
    if isinstance(template, dict):
        fields: list[tuple[str, Callable[[Any], Any]]] = []
        for key, value in template.items():
            if isinstance(key, str) and key.endswith(".$"):
                if not jsonpath.is_reference(value):
                    raise jsonpath.JSONPathError(
                        f"parameter {key!r}: value must be a JSONPath, got {value!r}"
                    )
                sel = jsonpath.compile_path(value)
                fields.append(
                    (key[:-2], lambda ctx, s=sel: copy.deepcopy(s.get(ctx)))
                )
            else:
                fields.append((key, compile_parameters(value)))
        return lambda ctx: {name: fn(ctx) for name, fn in fields}
    if isinstance(template, list):
        parts = [compile_parameters(v) for v in template]
        return lambda ctx: [fn(ctx) for fn in parts]
    if isinstance(template, str):
        if template.startswith("\\$"):
            literal = template[1:]
            return lambda ctx: literal
        if jsonpath.is_reference(template):
            sel = jsonpath.compile_path(template)
            return lambda ctx: copy.deepcopy(sel.get(ctx))
    return lambda ctx: template


def compile_state_input(
    input_path: str | None, parameters: Any
) -> Callable[[Any], Any]:
    """Compile a state's (InputPath, Parameters) pair into ``fn(context)``.

    Mirrors :func:`state_input`: ``InputPath`` narrows the document,
    ``Parameters`` templates over it, and the effective input is always a
    deep copy so state execution cannot alias the run Context.
    """
    in_sel = jsonpath.compile_path(input_path) if input_path else None
    if parameters is not None:
        params = compile_parameters(parameters)
        if in_sel is None:
            return params
        return lambda ctx: params(in_sel.get(ctx))
    if in_sel is not None:
        return lambda ctx: copy.deepcopy(in_sel.get(ctx))
    return copy.deepcopy


def compile_item_selector(
    template: Any,
) -> Callable[[Any, Any, int], dict]:
    """Compile a Map state's ``ItemSelector`` into ``fn(doc, item, index)``.

    The template is evaluated against an *item scope* document::

        {"item": <the current item>, "index": <its position>,
         "context": <the Map state's effective input>}

    so templates reference ``$.item``, ``$.index``, and ``$.context.…``
    (the offline analogue of ASL's ``$$.Map.Item.Value`` context object,
    expressed in this repo's JSONPath subset).  Without a template the
    child input defaults to ``{"item": ..., "index": ...}`` — always a
    dict, because a run Context must be a JSON object.  A template result
    that is not a dict is wrapped the same way at evaluation time.
    """
    if template is None:
        return lambda doc, item, index: {
            "item": copy.deepcopy(item), "index": index
        }
    params = compile_parameters(template)

    def build(doc: Any, item: Any, index: int) -> dict:
        out = params({"item": item, "index": index, "context": doc})
        if not isinstance(out, dict):
            out = {"item": out, "index": index}
        return out

    return build


def compile_result_writer(
    result_path: str | None,
) -> Callable[[dict, Any], dict]:
    """Compile a ``ResultPath`` into ``fn(context, result) -> context``.

    Same semantics as :func:`apply_result`; the path (if any) is parsed
    once here instead of on every state completion.
    """
    if result_path is None:
        return lambda context, result: context
    if result_path == "$":
        return lambda context, result: (
            result if isinstance(result, dict) else {"result": result}
        )
    sel = jsonpath.compile_path(result_path)
    return lambda context, result: sel.put(context, result)


# --------------------------------------------------------------------------
# document-at-a-time tier: thin wrappers over the compiled tier, so there
# is exactly ONE implementation of the semantics (external callers pay a
# per-call template walk; JSONPath strings still hit the LRU cache)
# --------------------------------------------------------------------------

def evaluate_parameters(template: Any, context: Any) -> Any:
    """Instantiate a Parameters template against the Context."""
    return compile_parameters(template)(context)


def state_input(context: Any, input_path: str | None, parameters: Any) -> Any:
    """Compute a state's effective input document."""
    return compile_state_input(input_path, parameters)(context)


def apply_result(context: dict, result_path: str | None, result: Any) -> dict:
    """Write a state result into the Context per ``ResultPath`` semantics.

    * ``None``  — result replaces the whole Context **only for Pass states
      without a declared path in ASL**; flows here follow the paper's
      services, which default to *discarding* the result unless a
      ``ResultPath`` is given (the run Context is long-lived state, not a
      pipeline register).  Callers that want replacement pass ``"$"``.
    * ``"$"``   — result becomes the Context.
    * ``"$.x"`` — result is inserted at that path.
    """
    return compile_result_writer(result_path)(context, result)
