"""Kubernetes resource-quantity parsing (the subset schedulers need).

The reference's embedded kube-scheduler ran NodeResourcesFit by default:
every pod's container cpu/memory requests were checked against node
allocatable. This module parses the two quantity grammars that feature
needs — cpu into millicores, memory into bytes — from the formats the API
emits: plain integers/decimals, the cpu "m" suffix, binary suffixes
(Ki Mi Gi Ti Pi), and decimal suffixes (k M G T P). Scientific notation
(rare in manifests) is accepted via float parsing. Malformed values
return None; callers decide whether that's a lint error (cli validate)
or an ignored request (the scheduler must not crash on cache content)."""

from __future__ import annotations

_BINARY = {"Ki": 1024, "Mi": 1024 ** 2, "Gi": 1024 ** 3,
           "Ti": 1024 ** 4, "Pi": 1024 ** 5, "Ei": 1024 ** 6}
_DECIMAL = {"k": 10 ** 3, "M": 10 ** 6, "G": 10 ** 9,
            "T": 10 ** 12, "P": 10 ** 15, "E": 10 ** 18}


def parse_cpu_millis(v) -> int | None:
    """'500m' -> 500, '2' -> 2000, 1 -> 1000, '1.5' -> 1500."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return int(v * 1000) if v >= 0 else None
    if not isinstance(v, str) or not v:
        return None
    try:
        out = (int(float(v[:-1])) if v.endswith("m")
               else int(float(v) * 1000))
    except ValueError:
        return None
    # negative quantities are invalid in the API; letting one through
    # would SUBTRACT from a node's used-resource accounting
    return out if out >= 0 else None


def parse_memory_bytes(v) -> int | None:
    """'1Gi' -> 2**30, '512Mi' -> 512*2**20, '1G' -> 1e9, '100' -> 100.
    The apiserver also emits millibyte quantities ('1500m', HPA math);
    they floor to whole bytes. Negative quantities (API-invalid) return
    None — see parse_cpu_millis."""
    def guard(x):
        return x if x is None or x >= 0 else None

    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return guard(int(v))
    if not isinstance(v, str) or not v:
        return None
    for suffix, mult in _BINARY.items():
        if v.endswith(suffix):
            try:
                return guard(int(float(v[: -len(suffix)]) * mult))
            except ValueError:
                return None
    for suffix, mult in _DECIMAL.items():
        if v.endswith(suffix):
            try:
                return guard(int(float(v[: -len(suffix)]) * mult))
            except ValueError:
                return None
    if v.endswith("m"):  # millibytes
        try:
            return guard(int(float(v[:-1]) / 1000))
        except ValueError:
            return None
    try:
        return guard(int(float(v)))
    except ValueError:
        return None


def pod_requests(spec) -> tuple[int, int]:
    """(cpu millicores, memory bytes) a Pod spec requests: the sum over
    containers, floored by the max over initContainers (upstream effective-
    requests rule — an init container runs alone, so its requests bound
    the pod's from below). Unparseable entries count 0 (cli validate
    flags them)."""
    if not isinstance(spec, dict):
        return 0, 0

    def of(container) -> tuple[int, int]:
        if not isinstance(container, dict):
            return 0, 0
        req = ((container.get("resources") or {}).get("requests") or {}) \
            if isinstance(container.get("resources"), dict) else {}
        if not isinstance(req, dict):
            return 0, 0
        return (parse_cpu_millis(req.get("cpu")) or 0,
                parse_memory_bytes(req.get("memory")) or 0)

    containers = spec.get("containers")
    inits = spec.get("initContainers")
    cpu = mem = 0
    for c in (containers if isinstance(containers, list) else []):
        c_cpu, c_mem = of(c)
        cpu += c_cpu
        mem += c_mem
    for c in (inits if isinstance(inits, list) else []):
        c_cpu, c_mem = of(c)
        cpu = max(cpu, c_cpu)
        mem = max(mem, c_mem)
    return cpu, mem


def pod_host_ports(spec) -> tuple:
    """(hostPort, protocol, hostIP) triples a Pod spec claims on its node
    (upstream NodePorts plugin inputs), across containers and
    initContainers. Protocol defaults to TCP, hostIP to "" (the wildcard
    address). Entries without hostPort claim nothing."""
    if not isinstance(spec, dict):
        return ()
    out = []
    for field in ("containers", "initContainers"):
        lst = spec.get(field)
        for c in (lst if isinstance(lst, list) else []):
            ports = c.get("ports") if isinstance(c, dict) else None
            for p in (ports if isinstance(ports, list) else []):
                if not isinstance(p, dict):
                    continue
                hp = p.get("hostPort")
                if isinstance(hp, int) and not isinstance(hp, bool) and hp > 0:
                    out.append((hp, p.get("protocol") or "TCP",
                                p.get("hostIP") or ""))
    return tuple(out)
