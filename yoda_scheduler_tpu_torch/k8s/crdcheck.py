"""A custom resource against its CRD's structural schema, as a real
apiserver judges a write.

The apiserver validates a custom resource against the version's
``openAPIV3Schema`` before it stores it: a value of the wrong type or
outside an ``enum`` is refused (422 Invalid), and a field the schema does
not declare is pruned, so a reader never sees it. ``check_cr`` returns one
line for each such fault (an undeclared field counts as one: what the
writer meant to store is lost). The fake API server stores whatever it is
sent, so the tests and ``chip_smoke.py`` hold the port's CRs to its CRD
through this module.

Only what the port's CRD uses is understood: ``type`` (object, array,
string, integer, number), ``enum``, ``properties`` and ``items``; any
other type raises. ``apiVersion``, ``kind`` and ``metadata`` are the
apiserver's own at the top level.
"""

from __future__ import annotations

from pathlib import Path

# the port's TpuNodeMetrics CRD (its own copy, deploy/crd-tpunodemetrics.yaml)
PORT_CRD = Path(__file__).resolve().parent.parent / "deploy" / "crd-tpunodemetrics.yaml"

VERSION = "v1"  # the CRD's one served version
_TOP_LEVEL = ("apiVersion", "kind", "metadata")


def load_crd(path=PORT_CRD) -> dict:
    """The CustomResourceDefinition document of a YAML file."""
    import yaml

    with open(path) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    (crd,) = [d for d in docs if d.get("kind") == "CustomResourceDefinition"]
    return crd


def crd_version(crd: dict) -> dict:
    (v,) = [v for v in crd["spec"]["versions"] if v["name"] == VERSION]
    return v


def schema_of(crd: dict) -> dict:
    return crd_version(crd)["schema"]["openAPIV3Schema"]


def _type_ok(value, want: str) -> bool:
    if want == "object":
        return isinstance(value, dict)
    if want == "array":
        return isinstance(value, (list, tuple))
    if want == "string":
        return isinstance(value, str)
    if want == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if want == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    raise ValueError(f"schema type {want!r} is not understood")


def check(value, schema: dict, path: str = "") -> list[str]:
    """Every fault of `value` against `schema`, one line each, named by
    its path (``.status.chips[0].power_w``)."""
    want = schema.get("type")
    if want is not None and not _type_ok(value, want):
        return [f"{path or '.'}: {type(value).__name__} {value!r} is not of type {want}"]
    faults = []
    if "enum" in schema and value not in schema["enum"]:
        faults.append(f"{path or '.'}: {value!r} is not one of {schema['enum']}")
    if isinstance(value, dict):
        props = schema.get("properties", {})
        for key, item in value.items():
            if key in props:
                faults += check(item, props[key], f"{path}.{key}")
            else:
                faults.append(f"{path}.{key}: not declared (pruned)")
    elif isinstance(value, (list, tuple)) and "items" in schema:
        for i, item in enumerate(value):
            faults += check(item, schema["items"], f"{path}[{i}]")
    return faults


def check_cr(cr: dict, crd: dict) -> list[str]:
    """Every fault of the custom resource `cr` against the CRD `crd`."""
    body = {k: v for k, v in cr.items() if k not in _TOP_LEVEL}
    return check(body, schema_of(crd))


def has_status_subresource(crd: dict) -> bool:
    """With the status subresource on, the apiserver ignores `status` in a
    write to the main resource: only a write to ``/status`` sets it."""
    return "status" in (crd_version(crd).get("subresources") or {})
