"""Single-slot value-keyed memo, shared by every hot-path parse/aggregate
cache (pod specs, chip assignments, telemetry aggregates).

The slot lives on the owning object as ``(key, value)`` under ``attr``; a
changed key recomputes. The slot write is a single attribute assignment
(atomic under the GIL), so readers never see a torn ``(key, value)`` pair —
but the memo cannot protect ``compute`` itself: if another thread mutates the
underlying data without changing the key, the memo pins whatever ``compute``
observed. Publishers must therefore replace-and-rekey (publish a fresh object
or bump the key), never mutate shared state in place.
"""

from __future__ import annotations

from typing import Any, Callable, TypeVar

T = TypeVar("T")


def memo(obj: Any, attr: str, key: Any, compute: Callable[[], T]) -> T:
    cached = getattr(obj, attr, None)
    if cached is not None and cached[0] == key:
        return cached[1]
    value = compute()
    setattr(obj, attr, (key, value))
    return value
