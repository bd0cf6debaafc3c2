"""JSON Schema subset validator (paper §4.2.3).

Every flow carries an input schema; the Flows service validates run input
against it before starting a run ("makes run-time failure due to improper
input less likely") and UIs render forms from it (Fig 3).  We implement the
JSON-Schema draft subset those schemas use:

``type`` (incl. unions), ``properties``, ``required``,
``additionalProperties``, ``items``, ``enum``, ``const``, ``minimum`` /
``maximum`` / ``exclusiveMinimum`` / ``exclusiveMaximum``, ``minLength`` /
``maxLength``, ``minItems`` / ``maxItems``, ``pattern``, ``format`` (ignored),
``default`` (applied), ``anyOf`` / ``allOf`` / ``oneOf``, ``$ref`` to
``#/definitions/...``.
"""

from __future__ import annotations

import re
from typing import Any

from .errors import FlowValidationError, InputValidationError

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "integer": int,
    "number": (int, float),
    "boolean": bool,
    "null": type(None),
}


class SchemaError(FlowValidationError):
    """The schema itself is malformed."""


class ValidationFailure(InputValidationError):
    """The instance does not conform to the schema."""

    def __init__(self, errors: list[str]):
        super().__init__("; ".join(errors))
        self.errors = errors


def check_schema(schema: Any, _path: str = "#") -> None:
    """Light structural validation of the schema document itself."""
    if schema is True or schema is False:
        return
    if not isinstance(schema, dict):
        raise SchemaError(f"{_path}: schema must be an object or boolean")
    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        for one in types:
            if one not in _TYPES:
                raise SchemaError(f"{_path}: unknown type {one!r}")
    for key in ("properties", "definitions"):
        sub = schema.get(key)
        if sub is not None:
            if not isinstance(sub, dict):
                raise SchemaError(f"{_path}/{key}: must be an object")
            for name, s in sub.items():
                check_schema(s, f"{_path}/{key}/{name}")
    for key in ("items", "additionalProperties"):
        if key in schema and not isinstance(schema[key], bool):
            check_schema(schema[key], f"{_path}/{key}")
    for key in ("anyOf", "allOf", "oneOf"):
        if key in schema:
            if not isinstance(schema[key], list) or not schema[key]:
                raise SchemaError(f"{_path}/{key}: must be a non-empty array")
            for i, s in enumerate(schema[key]):
                check_schema(s, f"{_path}/{key}/{i}")
    req = schema.get("required")
    if req is not None and (
        not isinstance(req, list) or not all(isinstance(r, str) for r in req)
    ):
        raise SchemaError(f"{_path}/required: must be an array of strings")
    if "pattern" in schema:
        try:
            re.compile(schema["pattern"])
        except re.error as e:
            raise SchemaError(f"{_path}/pattern: {e}") from None


def _type_ok(value: Any, t: str) -> bool:
    py = _TYPES[t]
    if t == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if t == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if t == "boolean":
        return isinstance(value, bool)
    return isinstance(value, py)


def _resolve_ref(ref: str, root: dict) -> Any:
    if not ref.startswith("#/"):
        raise SchemaError(f"unsupported $ref {ref!r}")
    cur: Any = root
    for part in ref[2:].split("/"):
        if not isinstance(cur, dict) or part not in cur:
            raise SchemaError(f"dangling $ref {ref!r}")
        cur = cur[part]
    return cur


def _validate(value: Any, schema: Any, root: dict, path: str, errors: list[str]) -> None:
    if schema is True or schema == {}:
        return
    if schema is False:
        errors.append(f"{path}: schema forbids any value")
        return
    if "$ref" in schema:
        _validate(value, _resolve_ref(schema["$ref"], root), root, path, errors)
        return

    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        if not any(_type_ok(value, one) for one in types):
            errors.append(f"{path}: expected type {t}, got {type(value).__name__}")
            return

    if "enum" in schema and value not in schema["enum"]:
        errors.append(f"{path}: {value!r} not in enum {schema['enum']}")
    if "const" in schema and value != schema["const"]:
        errors.append(f"{path}: expected const {schema['const']!r}")

    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            errors.append(f"{path}: {value} < minimum {schema['minimum']}")
        if "maximum" in schema and value > schema["maximum"]:
            errors.append(f"{path}: {value} > maximum {schema['maximum']}")
        if "exclusiveMinimum" in schema and value <= schema["exclusiveMinimum"]:
            errors.append(f"{path}: {value} <= exclusiveMinimum")
        if "exclusiveMaximum" in schema and value >= schema["exclusiveMaximum"]:
            errors.append(f"{path}: {value} >= exclusiveMaximum")

    if isinstance(value, str):
        if "minLength" in schema and len(value) < schema["minLength"]:
            errors.append(f"{path}: shorter than minLength {schema['minLength']}")
        if "maxLength" in schema and len(value) > schema["maxLength"]:
            errors.append(f"{path}: longer than maxLength {schema['maxLength']}")
        if "pattern" in schema and not re.search(schema["pattern"], value):
            errors.append(f"{path}: does not match pattern {schema['pattern']!r}")

    if isinstance(value, list):
        if "minItems" in schema and len(value) < schema["minItems"]:
            errors.append(f"{path}: fewer than minItems {schema['minItems']}")
        if "maxItems" in schema and len(value) > schema["maxItems"]:
            errors.append(f"{path}: more than maxItems {schema['maxItems']}")
        if "items" in schema:
            for i, item in enumerate(value):
                _validate(item, schema["items"], root, f"{path}[{i}]", errors)

    if isinstance(value, dict):
        props = schema.get("properties", {})
        for name, sub in props.items():
            if name in value:
                _validate(value[name], sub, root, f"{path}.{name}", errors)
        for name in schema.get("required", []):
            if name not in value:
                errors.append(f"{path}: missing required property {name!r}")
        ap = schema.get("additionalProperties", True)
        if ap is not True:
            extra = [k for k in value if k not in props]
            if ap is False and extra:
                errors.append(f"{path}: additional properties not allowed: {extra}")
            elif isinstance(ap, dict):
                for k in extra:
                    _validate(value[k], ap, root, f"{path}.{k}", errors)

    for key in ("allOf",):
        for sub in schema.get(key, []):
            _validate(value, sub, root, path, errors)
    if "anyOf" in schema:
        for sub in schema["anyOf"]:
            sub_err: list[str] = []
            _validate(value, sub, root, path, sub_err)
            if not sub_err:
                break
        else:
            errors.append(f"{path}: does not match anyOf")
    if "oneOf" in schema:
        hits = 0
        for sub in schema["oneOf"]:
            sub_err = []
            _validate(value, sub, root, path, sub_err)
            hits += not sub_err
        if hits != 1:
            errors.append(f"{path}: matches {hits} oneOf branches (need exactly 1)")


def apply_defaults(value: Any, schema: Any) -> Any:
    """Fill in ``default`` values for missing object properties (recursive)."""
    if not isinstance(schema, dict):
        return value
    if isinstance(value, dict):
        for name, sub in schema.get("properties", {}).items():
            if name not in value and isinstance(sub, dict) and "default" in sub:
                value[name] = sub["default"]
            elif name in value:
                value[name] = apply_defaults(value[name], sub)
    if isinstance(value, list) and "items" in schema:
        value = [apply_defaults(v, schema["items"]) for v in value]
    return value


def validate(value: Any, schema: Any) -> Any:
    """Validate ``value`` against ``schema``; returns value with defaults.

    Raises :class:`ValidationFailure` listing every violation.
    """
    root = schema if isinstance(schema, dict) else {}
    value = apply_defaults(value, schema)
    errors: list[str] = []
    _validate(value, schema, root, "$", errors)
    if errors:
        raise ValidationFailure(errors)
    return value
