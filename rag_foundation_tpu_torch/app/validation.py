"""Field coercion of the JAX app's pydantic models, without pydantic.

The JAX app validates its settings and request bodies with pydantic v2 in
lax mode (``app/config.py``, ``routes/auth_routes.py``,
``routes/stores.py``, ``routes/chat.py``). The card machine has no
pydantic, so the port coerces by hand: the same accepted inputs give the
same values, and a rejected one raises ``FieldError`` (a ``ValueError``,
as pydantic's ``ValidationError`` is) carrying pydantic's location and
message, which the routes put in their 422 ``detail``.

Lax mode, as pydantic applies it to JSON and environment values:

- ``str``: a string (bytes are decoded); nothing else.
- ``int``: an int or bool; a float without a fraction; a string of ASCII
  digits with single ``_`` separators and an optional all-zero fraction,
  surrounding whitespace stripped.
- ``float``: an int, bool or float; a string ``float()`` parses, ASCII only.
- ``bool``: a bool; 0/1 (int or float); the strings 0/1, off/on, f/t,
  false/true, n/y, no/yes in any case, not stripped.
- ``list``: a list, tuple or set, each item coerced; ``dict``: a dict.
"""

from __future__ import annotations

import math
import re

MISSING = object()

_INT_STR = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?")
_TRUE = frozenset(("1", "on", "t", "true", "y", "yes"))
_FALSE = frozenset(("0", "off", "f", "false", "n", "no"))


class FieldError(ValueError):
    """One rejected field: ``loc`` is pydantic's location tuple, ``msg``
    its message."""

    def __init__(self, loc: tuple, msg: str):
        super().__init__(f"{'.'.join(str(p) for p in loc)}: {msg}")
        self.loc = loc
        self.msg = msg


def to_str(v, loc: tuple) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, (bytes, bytearray)):
        try:
            return bytes(v).decode()
        except UnicodeDecodeError:
            raise FieldError(loc, "Input should be a valid string, unable "
                             "to parse raw data as a unicode string"
                             ) from None
    raise FieldError(loc, "Input should be a valid string")


def to_int(v, loc: tuple) -> int:
    if isinstance(v, int):            # bool included: True -> 1
        return int(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            raise FieldError(loc, "Input should be a finite number")
        if v != int(v):
            raise FieldError(loc, "Input should be a valid integer, got a "
                             "number with a fractional part")
        return int(v)
    if isinstance(v, (bytes, bytearray)):
        v = bytes(v).decode("utf-8", "replace")
    if isinstance(v, str):
        s = v.strip()
        if s.isascii() and _INT_STR.fullmatch(s):
            return int(s.split(".")[0])
        raise FieldError(loc, "Input should be a valid integer, unable to "
                         "parse string as an integer")
    raise FieldError(loc, "Input should be a valid integer")


def to_float(v, loc: tuple) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, (bytes, bytearray)):
        v = bytes(v).decode("utf-8", "replace")
    if isinstance(v, str):
        s = v.strip()
        if s.isascii():
            try:
                return float(s)
            except ValueError:
                pass
        raise FieldError(loc, "Input should be a valid number, unable to "
                         "parse string as a number")
    raise FieldError(loc, "Input should be a valid number")


def to_bool(v, loc: tuple) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        if v in (0, 1):
            return bool(v)
        if -2 ** 63 <= v < 2 ** 63:      # pydantic's machine integers
            raise FieldError(loc, "Input should be a valid boolean, unable "
                             "to interpret input")
        raise FieldError(loc, "Input should be a valid boolean")
    if isinstance(v, float):
        if v in (0.0, 1.0):
            return bool(v)
        raise FieldError(loc, "Input should be a valid boolean")
    if isinstance(v, (bytes, bytearray)):
        v = bytes(v).decode("utf-8", "replace")
    if isinstance(v, str):
        s = v.lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise FieldError(loc, "Input should be a valid boolean, unable to "
                         "interpret input")
    raise FieldError(loc, "Input should be a valid boolean")


def to_list(v, loc: tuple, item) -> list:
    """A list whose items ``item(value, loc)`` coerces."""
    if not isinstance(v, (list, tuple, set, frozenset)):
        raise FieldError(loc, "Input should be a valid list")
    return [item(x, loc + (i,)) for i, x in enumerate(v)]


def to_dict(v, loc: tuple, key=None, value=None) -> dict:
    if not isinstance(v, dict):
        raise FieldError(loc, "Input should be a valid dictionary")
    out = {}
    for k, x in v.items():
        k2 = key(k, loc + (k, "[key]")) if key else k
        out[k2] = value(x, loc + (k,)) if value else x
    return out


def optional(coerce):
    """``X | None``: None passes, anything else is coerced as X."""
    def run(v, loc):
        return None if v is None else coerce(v, loc)
    return run


def list_of(item):
    def run(v, loc):
        return to_list(v, loc, item)
    return run


def dict_of(key, value):
    def run(v, loc):
        return to_dict(v, loc, key, value)
    return run


def parse_fields(payload: dict, spec: dict
                 ) -> tuple[dict, list[FieldError]]:
    """Coerce ``payload`` field by field in ``spec`` order (name ->
    (coerce, default or MISSING)); unknown keys are ignored, as pydantic
    ignores extra fields. Returns (values, errors): a field that is
    missing without a default, or that its coercion rejects, adds its
    error (``Field required`` for a missing one)."""
    values, errors = {}, []
    for name, (coerce, default) in spec.items():
        if name not in payload:
            if default is MISSING:
                errors.append(FieldError((name,), "Field required"))
            else:
                values[name] = default
            continue
        try:
            values[name] = coerce(payload[name], (name,))
        except FieldError as e:
            errors.append(e)
    return values, errors
