"""In-process Kubernetes API server over real localhost HTTP.

Serves exactly the surface the scheduler uses — list/watch with
resourceVersions and 410 compaction, pod create/delete/patch, the binding
subresource (with 409 on double-bind), TpuNodeMetrics CRs, and Lease CRUD
with resourceVersion conflict enforcement — so the wire tiers of the
engine bench (`bench.run_serve_scale`, `bench.run_serve_procs`) exercise
the REAL urllib transport end to end with zero injected transports. The
package's own copy of the repository's tests/fake_apiserver.py, so that
the bench runs where only the package is installed (the port's image).

Single-threaded state under one condition variable; watch streams are
served by ThreadingHTTPServer worker threads that block on the condition
until new events arrive.
"""

from __future__ import annotations

import bisect
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _key(obj: dict) -> str:
    m = obj.get("metadata", {})
    ns = m.get("namespace")
    return f"{ns}/{m['name']}" if ns else m["name"]


def _parse_label_selector(sel: str) -> list:
    """labelSelector terms the sharded reflectors use: equality
    (``k=v`` / ``k==v``) and set membership (``k in (a,b)``), comma-
    joined. Unsupported operators are ignored (match-all) — this is a
    test double, not a validator."""
    import re

    terms = []
    for part in re.split(r",(?![^(]*\))", sel or ""):
        part = part.strip()
        if not part:
            continue
        m = re.match(r"^(\S+)\s+in\s+\((.*)\)$", part)
        if m:
            terms.append((m.group(1),
                          {v.strip() for v in m.group(2).split(",")}))
            continue
        if "==" in part:
            k, v = part.split("==", 1)
        elif "=" in part and "!=" not in part:
            k, v = part.split("=", 1)
        else:
            continue
        terms.append((k.strip(), {v.strip()}))
    return terms


def _matches_selector(obj: dict, terms: list) -> bool:
    labels = obj.get("metadata", {}).get("labels") or {}
    return all(labels.get(k) in vs for k, vs in terms)


class FakeApiState:
    KINDS = ("pods", "nodes", "metrics", "poddisruptionbudgets",
             "workloads")

    def __init__(self):
        _lock = threading.RLock()
        self.cond = threading.Condition(_lock)
        # per-kind watcher parking, sharing the SAME lock as self.cond: a
        # pod event must wake only the pods watch thread — with a single
        # shared condition every bind MODIFIED woke the node/metrics/pdb
        # streams too, and at 1000-pod-burst rates those spurious GIL
        # handoffs were a measurable slice of the server's cost
        self.kind_conds = {k: threading.Condition(_lock)
                           for k in self.KINDS}
        self.rv = 0
        self.objects: dict[str, dict[str, dict]] = {k: {} for k in self.KINDS}
        self.events: dict[str, list[tuple[int, str, dict]]] = {
            k: [] for k in self.KINDS}
        self.compact_below: dict[str, int] = {k: 0 for k in self.KINDS}
        self.leases: dict[str, dict] = {}
        self.requests: list[tuple[str, str]] = []  # (method, path)
        self.bindings: list[dict] = []
        # core/v1 Events POSTed by the scheduler (FailedScheduling /
        # Scheduled — the kubectl-describe trail); tests read them via
        # GET /api/v1/events or the in-process list
        self.pod_events: list[dict] = []
        # fault injection: list of [path_substring, status, remaining_count,
        # method]; remaining_count None = until clear_faults() (scripted
        # error STORMS rather than a fixed number of failures)
        self.faults: list[list] = []
        # watch-stream cut epochs: cut_watches(kind) bumps the kind's
        # epoch and every in-flight watch of that kind ends its stream
        # (clean close — the client re-watches from its resourceVersion;
        # pair with compact() to force the 410 re-list path instead)
        self.watch_epochs: dict[str, int] = {k: 0 for k in self.KINDS}
        self.uid_seq = 0
        # bound-pod index: node name -> set of pod keys assigned there
        # (maintained by upsert/remove under self.cond). _bind_conflict's
        # chip-overlap check used to scan EVERY pod under the state lock
        # — O(all pods) per bind serialized the whole server once tens of
        # thousands of pods accumulated (the multiprocess serve bench
        # regime); with the index it scans only the target node's pods.
        self.pods_by_node: dict[str, set[str]] = {}
        self._pod_node: dict[str, str] = {}
        # graceful deletion: DELETE sets metadata.deletionTimestamp and
        # emits MODIFIED (the pod keeps running with its nodeName, as a real
        # kubelet does for terminationGracePeriodSeconds); the test then
        # calls finish_termination() to emit the final DELETED
        self.graceful_deletion = False
        # ValidatingAdmissionWebhook on pods/binding: when registered
        # (set_webhook), the binding handler POSTs an AdmissionReview to
        # the URL before applying; a denial is surfaced to the client with
        # the webhook's status code and the real apiserver's message shape
        # ('admission webhook "<name>" denied the request: ...'). An
        # unreachable webhook follows failure_policy: "Fail" -> 500 (the
        # recommended safety posture), "Ignore" -> the bind proceeds with
        # only the pod-level check.
        self.webhook: dict | None = None
        # vanilla-apiserver posture: skip the built-in chip/HBM/fence
        # battery on bindings (a conformant apiserver enforces only the
        # pod-level 409) — implied by registering a webhook; settable on
        # its own to demonstrate the unprotected hole
        self.vanilla_authority = False
        self.webhook_calls = 0
        self.webhook_denials = 0
        self.webhook_errors = 0
        # watch bookmarks (allowWatchBookmarks): opt-in server capability,
        # like the real feature gate — a parked watch emits a BOOKMARK at
        # the current resourceVersion so quiet clients resume past
        # compactions without the 410 -> full-relist path. Off by default
        # so the 410-path tests keep exercising exactly that path.
        self.bookmarks_enabled = False

    # ------------------------------------------------------------- mutation
    def _stamp(self, kind: str, obj: dict, typ: str) -> dict:
        self.rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self.rv)
        if not obj["metadata"].get("uid"):
            self.uid_seq += 1
            obj["metadata"]["uid"] = f"uid-{self.uid_seq}"
        # point-in-time copy + the wire line serialized ONCE at stamp
        # time (every watcher used to re-dumps() every event): events are
        # (rv, type, object_copy, wire_line)
        payload = json.dumps(obj)
        self.events[kind].append((
            self.rv, typ, json.loads(payload),
            f'{{"type": "{typ}", "object": {payload}}}\n'.encode()))
        return obj

    def upsert(self, kind: str, obj: dict, typ: str | None = None) -> dict:
        with self.cond:
            k = _key(obj)
            typ = typ or ("MODIFIED" if k in self.objects[kind] else "ADDED")
            obj = self._stamp(kind, obj, typ)
            self.objects[kind][k] = obj
            if kind == "pods":
                self._index_pod(k, obj)
            self.kind_conds[kind].notify_all()
            self.cond.notify_all()
            return obj

    def _index_pod(self, key: str, obj: dict) -> None:
        # caller holds self.cond
        node = obj.get("spec", {}).get("nodeName") or None
        prev = self._pod_node.get(key)
        if prev == node:
            return
        if prev is not None:
            self.pods_by_node.get(prev, set()).discard(key)
        if node is None:
            self._pod_node.pop(key, None)
        else:
            self._pod_node[key] = node
            self.pods_by_node.setdefault(node, set()).add(key)

    def remove(self, kind: str, key: str) -> dict | None:
        with self.cond:
            obj = self.objects[kind].pop(key, None)
            if obj is not None:
                if kind == "pods":
                    node = self._pod_node.pop(key, None)
                    if node is not None:
                        self.pods_by_node.get(node, set()).discard(key)
                self._stamp(kind, obj, "DELETED")
                self.kind_conds[kind].notify_all()
                self.cond.notify_all()
            return obj

    def compact(self, kind: str) -> None:
        """Forget watch history: watches from older resourceVersions now get
        410 Gone (etcd compaction)."""
        with self.cond:
            self.compact_below[kind] = self.rv
            self.events[kind].clear()
            self.kind_conds[kind].notify_all()
            self.cond.notify_all()

    def fail(self, path_substring: str, status: int,
             times: int | None = 1, method: str | None = None) -> None:
        """Inject `status` for the next `times` requests whose path contains
        `path_substring` (optionally only for one HTTP method).
        times=None keeps the fault active until clear_faults() — an
        error storm with a scripted end instead of a request budget."""
        with self.cond:
            self.faults.append([path_substring, status, times, method])

    def clear_faults(self, path_substring: str | None = None) -> None:
        """End injected faults (all of them, or those registered for
        `path_substring`) — the storm-recovery edge chaos tests script."""
        with self.cond:
            if path_substring is None:
                self.faults.clear()
            else:
                self.faults[:] = [f for f in self.faults
                                  if f[0] != path_substring]

    def set_webhook(self, url: str, failure_policy: str = "Fail",
                    timeout_s: float = 2.0,
                    ca_file: str | None = None) -> None:
        """Register a pods/binding validating webhook (the fake's
        ValidatingWebhookConfiguration). `ca_file` verifies an https
        callee (the caBundle analogue); an https URL without one is
        accepted unverified — test convenience only."""
        with self.cond:
            self.webhook = {"url": url, "failure_policy": failure_policy,
                            "timeout_s": timeout_s, "ca_file": ca_file}

    def clear_webhook(self) -> None:
        with self.cond:
            self.webhook = None

    def cut_watches(self, kind: str | None = None) -> None:
        """Force every in-flight watch stream of `kind` (default: all) to
        end — the mid-stream connection cut a flapping LB or restarting
        apiserver produces. Clients see a clean stream end and re-watch."""
        with self.cond:
            for k in (self.KINDS if kind is None else (kind,)):
                self.watch_epochs[k] += 1
                self.kind_conds[k].notify_all()
            self.cond.notify_all()

    # ------------------------------------------------------------- helpers
    def add_pdb(self, name: str, match_labels: dict, min_available: int,
                namespace: str = "default") -> None:
        self.upsert("poddisruptionbudgets", {
            "metadata": {"name": name, "namespace": namespace},
            "spec": {"selector": {"matchLabels": dict(match_labels)},
                     "minAvailable": min_available},
        })

    def add_node(self, name: str, labels: dict | None = None,
                 taints: list | None = None,
                 allocatable: dict | None = None,
                 unschedulable: bool = False) -> None:
        obj: dict = {"metadata": {"name": name}}
        if labels:
            obj["metadata"]["labels"] = dict(labels)
        if taints:
            obj.setdefault("spec", {})["taints"] = list(taints)
        if unschedulable:
            obj.setdefault("spec", {})["unschedulable"] = True
        if allocatable:
            obj["status"] = {"allocatable": dict(allocatable)}
        self.upsert("nodes", obj)

    def add_pod(self, manifest: dict) -> dict:
        manifest.setdefault("metadata", {}).setdefault("namespace", "default")
        manifest.setdefault("status", {"phase": "Pending"})
        return self.upsert("pods", manifest)

    def add_workload(self, manifest: dict) -> dict:
        manifest.setdefault("metadata", {}).setdefault(
            "namespace", "default")
        return self.upsert("workloads", manifest)

    def put_metrics(self, cr: dict) -> None:
        cr.setdefault("metadata", {"name": cr.get("metadata", {}).get("name")})
        self.upsert("metrics", cr)

    def pod(self, name: str, namespace: str = "default") -> dict | None:
        with self.cond:
            return self.objects["pods"].get(f"{namespace}/{name}")

    def finish_termination(self, key: str) -> dict | None:
        """Complete a graceful deletion: the kubelet finished tearing the
        pod down, so the object actually disappears (DELETED event)."""
        return self.remove("pods", key)


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 so ordinary JSON responses (which carry Content-Length)
    # keep the connection alive — a real API server does, and the client
    # pools connections. Watch streams stay close-delimited: _watch sends
    # "Connection: close" explicitly (no Content-Length, no chunking)
    protocol_version = "HTTP/1.1"
    # NODELAY (socketserver reads this off the HANDLER class): keep-alive
    # clients make many small exchanges per connection; Nagle + delayed
    # ACK would stall each one ~40ms on loopback
    disable_nagle_algorithm = True
    state: FakeApiState = None  # set by make_server

    def log_message(self, *args):  # quiet
        pass

    # ------------------------------------------------------------ plumbing
    def _json(self, status: int, doc: dict) -> None:
        if getattr(self, "_ambiguous", False):
            return  # fault -1: the mutation applied, the response is lost
        raw = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _body(self) -> dict:
        return json.loads(self._raw_body) if self._raw_body else {}

    def _injected_fault(self, path: str, method: str) -> int | None:
        with self.state.cond:
            for f in self.state.faults:
                if (f[0] in path and (f[2] is None or f[2] > 0)
                        and (len(f) < 4 or f[3] is None or f[3] == method)):
                    if f[2] is not None:
                        f[2] -= 1
                    return f[1]
        return None

    def _route(self, method: str) -> None:
        s = self.state
        path = self.path
        # drain the request body EAGERLY: under HTTP/1.1 keep-alive an
        # unread body (e.g. a fault-injected early response to a PUT)
        # would be parsed as the next request's start line -> 400
        n = int(self.headers.get("Content-Length", 0) or 0)
        self._raw_body = self.rfile.read(n) if n else b""
        with s.cond:
            s.requests.append((method, path))
        # list-emptiness read is GIL-atomic; only take the state lock
        # again when a test actually armed fault injection (burst traffic
        # was paying two global-lock round-trips per request)
        fault = self._injected_fault(path, method) if s.faults else None
        if fault is not None and fault != -1:
            return self._json(fault, {"kind": "Status", "code": fault})
        base, _, query = path.partition("?")
        q = urllib.parse.parse_qs(query)
        if fault == -1:
            # AMBIGUOUS-failure injection: PROCESS the request fully,
            # then kill the connection without writing a response — the
            # client sees RemoteDisconnected after a mutation the server
            # applied (the lost-response case the bind recovery handles)
            self._ambiguous = True
        try:
            self._dispatch(method, base, q)
        except BrokenPipeError:
            pass
        finally:
            if getattr(self, "_ambiguous", False):
                self._ambiguous = False
                try:
                    self.connection.close()
                except OSError:
                    pass
                self.close_connection = True

    do_GET = lambda self: self._route("GET")
    do_POST = lambda self: self._route("POST")
    do_PUT = lambda self: self._route("PUT")
    do_DELETE = lambda self: self._route("DELETE")
    do_PATCH = lambda self: self._route("PATCH")

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, method: str, base: str, q: dict) -> None:
        s = self.state
        if base == "/version":
            return self._json(200, {"gitVersion": "v1.fake"})

        kind = None
        if base == "/api/v1/pods":
            kind = "pods"
        elif base == "/api/v1/nodes":
            kind = "nodes"
        elif base.startswith("/apis/metrics.yoda.tpu/") and base.endswith(
                "tpunodemetrics"):
            kind = "metrics"
        elif base == "/apis/policy/v1/poddisruptionbudgets":
            kind = "poddisruptionbudgets"
        elif base == "/apis/scheduling.yoda.tpu/v1/workloads":
            kind = "workloads"
        if kind is not None and method == "GET":
            if q.get("watch", ["false"])[0] == "true":
                return self._watch(kind, q)
            return self._list(kind, q)
        # TpuNodeMetrics item verbs + collection POST (the sniffer
        # publisher's create-or-update path, with the same optimistic
        # concurrency a real API server enforces)
        if "/tpunodemetrics" in base:
            return self._metrics_verb(method, base, kind)
        # Workload CRD verbs (workload-tier admission): collection POST,
        # namespaced item GET/DELETE, and the /status subresource PUT the
        # scheduler's condition write-back uses
        if "/workloads" in base:
            return self._workload_verb(method, base, kind)

        if base == "/api/v1/events" and method == "GET":
            with s.cond:
                items = list(s.pod_events)
                rv = s.rv
            return self._json(200, {"items": items,
                                    "metadata": {"resourceVersion": str(rv)}})
        if base.startswith("/api/v1/namespaces/"):
            parts = base.split("/")  # '', api, v1, namespaces, ns, pods, name[, sub]
            if len(parts) >= 6 and parts[5] == "events" \
                    and method == "POST":
                body = self._body()
                with s.cond:
                    s.pod_events.append(body)
                return self._json(201, body)
            if len(parts) >= 7 and parts[5] == "pods":
                ns, name = parts[4], parts[6]
                sub = parts[7] if len(parts) > 7 else None
                return self._pod_verb(method, ns, name, sub)

        if "/leases" in base:
            return self._lease_verb(method, base)
        if kind is not None and method == "POST" and kind == "pods":
            return self._json(201, s.add_pod(self._body()))
        if kind is not None and method == "POST" and kind == "nodes":
            # node create (capacity provisioner's wire path): the object
            # enters the SAME watch stream every other node uses, so a
            # scheduler reflector delivers it as an ordinary NODE_ADDED
            body = self._body()
            name = body.get("metadata", {}).get("name")
            if not name:
                return self._json(422, {"kind": "Status", "code": 422,
                                        "message": "node needs a name"})
            with s.cond:
                if name in s.objects["nodes"]:
                    return self._json(409, {
                        "kind": "Status", "code": 409, "reason":
                        "AlreadyExists",
                        "message": f'nodes "{name}" already exists'})
            return self._json(201, s.upsert("nodes", body))
        if base.startswith("/api/v1/nodes/"):
            name = base.split("/")[4]
            if method == "GET":
                with s.cond:
                    obj = s.objects["nodes"].get(name)
                if obj is None:
                    return self._json(404, {"kind": "Status", "code": 404})
                return self._json(200, obj)
            if method == "DELETE":
                gone = s.remove("nodes", name)
                if gone is None:
                    return self._json(404, {"kind": "Status", "code": 404})
                return self._json(200, gone)
            if method == "PATCH":
                # strategic-merge-lite, like the pod PATCH: shallow-merge
                # spec (cordon's unschedulable, taints) and
                # metadata.labels, then republish through upsert so the
                # change rides the ordinary node watch stream
                body = self._body()
                with s.cond:
                    obj = s.objects["nodes"].get(name)
                    if obj is None:
                        return self._json(404, {"kind": "Status",
                                                "code": 404})
                    obj = json.loads(json.dumps(obj))  # deep copy
                if "spec" in body:
                    obj.setdefault("spec", {}).update(body["spec"] or {})
                if "metadata" in body:
                    labels = (body["metadata"] or {}).get("labels")
                    if labels is not None:
                        obj.setdefault("metadata", {}).setdefault(
                            "labels", {}).update(labels)
                return self._json(200, s.upsert("nodes", obj))
        self._json(404, {"kind": "Status", "code": 404})

    # ----------------------------------------------------------- list/watch
    def _list(self, kind: str, q: dict) -> None:
        s = self.state
        with s.cond:
            items = list(s.objects[kind].values())
            rv = s.rv
        sel = q.get("labelSelector", [None])[0]
        if sel:
            terms = _parse_label_selector(sel)
            items = [i for i in items if _matches_selector(i, terms)]
        limit = int(q.get("limit", [0])[0] or 0)
        cont = q.get("continue", [None])[0]
        start = int(cont) if cont else 0
        meta: dict = {"resourceVersion": str(rv)}
        if limit and start + limit < len(items):
            meta["continue"] = str(start + limit)
            items = items[start:start + limit]
        elif limit:
            items = items[start:]
        self._json(200, {"items": items, "metadata": meta})

    def _watch(self, kind: str, q: dict) -> None:
        s = self.state
        sel = q.get("labelSelector", [None])[0]
        sel_terms = _parse_label_selector(sel) if sel else None
        from_rv = int(q.get("resourceVersion", ["0"])[0] or 0)
        timeout_s = float(q.get("timeoutSeconds", ["30"])[0])
        deadline = time.monotonic() + min(timeout_s, 30.0)
        # watch bookmarks: requested by the client AND enabled on the
        # server (the real feature-gate shape). A parked stream advances
        # the client's resourceVersion past writes of OTHER kinds, so a
        # quiet reflector survives compaction without the 410 re-list.
        bookmarks = (s.bookmarks_enabled
                     and q.get("allowWatchBookmarks",
                               ["false"])[0] == "true")

        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        # the stream has no Content-Length: it is delimited by the
        # connection closing, which HTTP/1.1 must announce
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()

        with s.cond:
            if from_rv and from_rv < s.compact_below[kind]:
                line = json.dumps({"type": "ERROR", "object": {
                    "kind": "Status", "code": 410,
                    "message": "too old resource version"}}) + "\n"
                self.wfile.write(line.encode())
                return
            epoch0 = s.watch_epochs[kind]
        last = from_rv
        # events are rv-ascending: bisect to the first undelivered one
        # instead of rescanning the whole log per wake-up (the rescan was
        # O(total events) per watcher per wake-up — during a 1000-pod
        # burst the fake server itself became the ingest bottleneck and
        # polluted the watch-lag measurement)
        rv_of = lambda e: e[0]  # noqa: E731
        while time.monotonic() < deadline:
            bm_rv = None
            with s.cond:
                if s.watch_epochs[kind] != epoch0:
                    return  # scripted stream cut: end mid-watch
                evs = s.events[kind]
                i = bisect.bisect_right(evs, last, key=rv_of)
                batch = evs[i:]
                if not batch:
                    # park on this kind's condition (shared lock with
                    # s.cond): only events of our own kind wake us
                    s.kind_conds[kind].wait(timeout=min(0.2, max(
                        deadline - time.monotonic(), 0.01)))
                    if s.watch_epochs[kind] != epoch0:
                        return  # cut fired while parked: die BEFORE
                        # delivering events published after the cut
                    evs = s.events[kind]
                    i = bisect.bisect_right(evs, last, key=rv_of)
                    batch = evs[i:]
                if not batch and bookmarks and s.rv > last:
                    bm_rv = s.rv  # quiet stream, global rv moved on
            if batch:
                lines = (b"".join(e[3] for e in batch)
                         if sel_terms is None else
                         b"".join(e[3] for e in batch
                                  if _matches_selector(e[2], sel_terms)))
                try:
                    # one write+flush per batch, pre-serialized lines
                    if lines:
                        self.wfile.write(lines)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return
                last = batch[-1][0]
            elif bm_rv is not None:
                line = json.dumps({"type": "BOOKMARK", "object": {
                    "kind": "Bookmark",
                    "metadata": {"resourceVersion": str(bm_rv)}}}) + "\n"
                try:
                    self.wfile.write(line.encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return
                last = bm_rv

    # -------------------------------------------------------- webhook call
    def _call_webhook(self, cfg: dict, ns: str, name: str,
                      body: dict):
        """POST an AdmissionReview v1 to the registered pods/binding
        webhook. Returns (allowed, code, message), or None when the
        webhook is unreachable/misbehaving (failurePolicy decides what
        that means). Never called with the state lock held."""
        import ssl
        import urllib.request

        s = self.state
        with s.cond:
            s.uid_seq += 1
            uid = f"review-{s.uid_seq}"
        review = {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {
                "uid": uid,
                "kind": {"group": "", "version": "v1", "kind": "Binding"},
                "resource": {"group": "", "version": "v1",
                             "resource": "pods"},
                "subResource": "binding",
                "namespace": ns, "name": name,
                "operation": "CREATE",
                "object": body,
            },
        }
        req = urllib.request.Request(
            cfg["url"], data=json.dumps(review).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        ctx = None
        if cfg["url"].startswith("https"):
            # caBundle analogue; absent = unverified (test convenience —
            # a real apiserver always verifies against the caBundle)
            ctx = (ssl.create_default_context(cafile=cfg["ca_file"])
                   if cfg.get("ca_file")
                   else ssl._create_unverified_context())
        try:
            with urllib.request.urlopen(
                    req, timeout=cfg.get("timeout_s", 2.0),
                    context=ctx) as resp:
                doc = json.loads(resp.read())
        except Exception:
            return None
        r = doc.get("response") or {}
        if r.get("uid") != uid:
            return None  # a response for some other review is no verdict
        status = r.get("status") or {}
        return (bool(r.get("allowed")), int(status.get("code") or 400),
                status.get("message", ""))

    # ------------------------------------------------------------ pod verbs
    def _bind_conflict(self, body: dict, pod: dict) -> str | None:
        """Server-side bind-time conflict semantics (caller holds
        state.cond; the already-bound-pod 409 is checked by the caller).
        Optimistic fleet commits are checked by the AUTHORITY, not just
        engine bookkeeping: an overlapping chip claim on the target node,
        a per-chip HBM claim past the chip's reported free HBM, or a
        stale fencing token (lease reassigned since the replica last
        renewed) all return a 409 message; None = the bind may proceed."""
        s = self.state
        node = body.get("target", {}).get("name", "")
        ann = body.get("metadata", {}).get("annotations", {}) or {}
        fence = ann.get("yoda.tpu/fence")
        if fence:
            try:
                lease_name, holder, epoch = fence.rsplit("/", 2)
            except ValueError:
                return f"malformed fencing token {fence!r}"
            lease = s.leases.get(lease_name)
            spec = (lease or {}).get("spec", {})
            if (lease is None or spec.get("holderIdentity") != holder
                    or str(spec.get("leaseTransitions", 0)) != epoch):
                return (f"stale fencing token {fence!r}: lease held by "
                        f"{spec.get('holderIdentity')!r} at transition "
                        f"{spec.get('leaseTransitions')}")
        claim = ann.get("tpu/assigned-chips", "")
        if not claim:
            return None
        claimed = {c for c in claim.split(";") if c}
        # by-node index: only pods already assigned to the TARGET node
        # can hold a conflicting chip claim (full-table scans here
        # serialized every bind behind O(all pods) work under the lock)
        for okey in s.pods_by_node.get(node, ()):
            other = s.objects["pods"].get(okey)
            if other is None:
                continue
            theirs = other.get("metadata", {}).get(
                "annotations", {}).get("tpu/assigned-chips", "")
            overlap = claimed & {c for c in theirs.split(";") if c}
            if overlap:
                return (f"chip claim conflict on {node}: {sorted(overlap)} "
                        f"already owned by {okey}")
        need_mb = int(pod.get("metadata", {}).get("labels", {}).get(
            "scv/memory", "0") or 0)
        if need_mb:
            cr = s.objects["metrics"].get(node)
            chips = (cr or {}).get("status", {}).get("chips", [])
            by_coord = {}
            for c in chips:
                coords = c.get("coords")
                if coords is not None:
                    by_coord[",".join(str(x) for x in coords)] = c
            for c in claimed:
                chip = by_coord.get(c)
                if chip is not None and need_mb > chip.get(
                        "hbm_free_mb", 1 << 60):
                    return (f"HBM oversubscription on {node}/{c}: need "
                            f"{need_mb}MB")
        return None

    def _pod_verb(self, method: str, ns: str, name: str, sub: str | None) -> None:
        s = self.state
        key = f"{ns}/{name}"
        if sub == "binding" and method == "POST":
            body = self._body()
            with s.cond:
                pod = s.objects["pods"].get(key)
                if pod is None:
                    return self._json(404, {"kind": "Status", "code": 404})
                if pod.get("spec", {}).get("nodeName"):
                    return self._json(409, {
                        "kind": "Status", "code": 409,
                        "message": f"pod {key} is already assigned to node "
                                   f"{pod['spec']['nodeName']}"})
                wh = dict(s.webhook) if s.webhook is not None else None
            if wh is not None:
                # call-out OUTSIDE the state lock: the webhook's claim
                # index is fed by watches of THIS server, and its fence
                # checks GET leases from it — holding s.cond here would
                # deadlock the very reads the verdict depends on
                verdict = self._call_webhook(wh, ns, name, body)
                with s.cond:
                    s.webhook_calls += 1
                if verdict is None:
                    with s.cond:
                        s.webhook_errors += 1
                    if wh["failure_policy"] != "Ignore":
                        return self._json(500, {
                            "kind": "Status", "code": 500,
                            "message": 'failed calling webhook '
                                       '"yoda-bind-authority.yoda.tpu": '
                                       'connection error (failurePolicy='
                                       'Fail)'})
                elif not verdict[0]:
                    with s.cond:
                        s.webhook_denials += 1
                    code = verdict[1] if 400 <= verdict[1] < 600 else 400
                    return self._json(code, {
                        "kind": "Status", "code": code,
                        "message": 'admission webhook "yoda-bind-'
                                   'authority.yoda.tpu" denied the '
                                   f'request: {verdict[2]}'})
            with s.cond:
                # re-validate under the lock: the call-out window is the
                # TOCTOU a real apiserver closes with storage-level
                # optimistic concurrency — a racing bind that landed
                # meanwhile must still 409
                pod = s.objects["pods"].get(key)
                if pod is None:
                    return self._json(404, {"kind": "Status", "code": 404})
                if pod.get("spec", {}).get("nodeName"):
                    return self._json(409, {
                        "kind": "Status", "code": 409,
                        "message": f"pod {key} is already assigned to node "
                                   f"{pod['spec']['nodeName']}"})
                if wh is None and not s.vanilla_authority:
                    # built-in authority battery, checked ATOMICALLY
                    # with the apply. With a webhook registered (or
                    # vanilla_authority set) the server behaves like a
                    # CONFORMANT apiserver instead: only the pod-level 409
                    # above — chip/fence checks belong to the webhook.
                    conflict = self._bind_conflict(body, pod)
                    if conflict is not None:
                        return self._json(409, {"kind": "Status",
                                                "code": 409,
                                                "message": conflict})
                s.bindings.append(body)
                pod.setdefault("spec", {})["nodeName"] = body["target"]["name"]
                # upstream parity (registry/core/pod assignPod): annotations
                # carried on the Binding's ObjectMeta are merged into the
                # pod, so a scheduler can publish its chip assignment in
                # the SAME write as the bind instead of a follow-up PATCH
                ann = body.get("metadata", {}).get("annotations")
                if ann:
                    pod.setdefault("metadata", {}).setdefault(
                        "annotations", {}).update(ann)
            s.upsert("pods", pod, "MODIFIED")
            return self._json(201, {})
        if method == "GET":
            with s.cond:
                pod = s.objects["pods"].get(key)
            if pod is None:
                return self._json(404, {"kind": "Status", "code": 404})
            return self._json(200, pod)
        if method == "DELETE":
            with s.cond:
                pod = s.objects["pods"].get(key)
                graceful = (s.graceful_deletion and pod is not None
                            and not pod["metadata"].get("deletionTimestamp"))
            if graceful:
                pod["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
                s.upsert("pods", pod, "MODIFIED")
                return self._json(200, {"kind": "Status", "code": 200})
            gone = s.remove("pods", key)
            code = 200 if gone is not None else 404
            return self._json(code, {"kind": "Status", "code": code})
        if method == "PATCH":
            body = self._body()
            with s.cond:
                pod = s.objects["pods"].get(key)
                if pod is None:
                    return self._json(404, {"kind": "Status", "code": 404})
                ann = body.get("metadata", {}).get("annotations", {})
                pod.setdefault("metadata", {}).setdefault(
                    "annotations", {}).update(ann)
            s.upsert("pods", pod, "MODIFIED")
            return self._json(200, pod)
        self._json(405, {"kind": "Status", "code": 405})

    # -------------------------------------------------------- metrics verbs
    def _metrics_verb(self, method: str, base: str, collection_kind) -> None:
        s = self.state
        if collection_kind == "metrics" and method == "POST":
            body = self._body()
            if body.get("metadata", {}).get("resourceVersion"):
                # real API servers reject creates carrying a resourceVersion
                return self._json(400, {
                    "kind": "Status", "code": 400,
                    "message": "resourceVersion should not be set on "
                               "objects to be created"})
            key = _key(body)
            with s.cond:
                if key in s.objects["metrics"]:
                    return self._json(409, {"kind": "Status", "code": 409,
                                            "message": "already exists"})
            s.upsert("metrics", body, "ADDED")
            return self._json(201, body)
        name = base.rsplit("/", 1)[-1]
        if method == "GET":
            with s.cond:
                cr = s.objects["metrics"].get(name)
            if cr is None:
                return self._json(404, {"kind": "Status", "code": 404})
            return self._json(200, cr)
        if method == "PUT":
            body = self._body()
            with s.cond:
                cur = s.objects["metrics"].get(name)
                if cur is None:
                    return self._json(404, {"kind": "Status", "code": 404})
                sent = body.get("metadata", {}).get("resourceVersion")
                if not sent:
                    return self._json(422, {
                        "kind": "Status", "code": 422,
                        "message": "resourceVersion: must be specified for "
                                   "an update"})
                if sent != cur["metadata"]["resourceVersion"]:
                    return self._json(409, {"kind": "Status", "code": 409,
                                            "message": "rv conflict"})
            s.upsert("metrics", body, "MODIFIED")
            return self._json(200, body)
        if method == "DELETE":
            gone = s.remove("metrics", name)
            code = 200 if gone is not None else 404
            return self._json(code, {"kind": "Status", "code": code})
        self._json(405, {"kind": "Status", "code": 405})

    # -------------------------------------------------------- workload verbs
    def _workload_verb(self, method: str, base: str, collection_kind) -> None:
        """Workload CRD (scheduling.yoda.tpu/v1): collection POST creates;
        /apis/scheduling.yoda.tpu/v1/namespaces/<ns>/workloads/<name>
        GET/DELETE; <...>/status PUT merges status (the scheduler's
        condition write-back — no resourceVersion fencing: last writer
        wins, like a controller-runtime status patch)."""
        s = self.state
        if collection_kind == "workloads" and method == "POST":
            body = self._body()
            body.setdefault("metadata", {}).setdefault(
                "namespace", "default")
            key = _key(body)
            with s.cond:  # re-entrant: upsert under the SAME hold, so
                # two racing POSTs of one key cannot both pass the
                # existence check and both 201
                if key in s.objects["workloads"]:
                    return self._json(409, {"kind": "Status", "code": 409,
                                            "message": "already exists"})
                s.upsert("workloads", body, "ADDED")
            return self._json(201, body)
        parts = base.split("/")
        # '', apis, group, v1, namespaces, ns, workloads, name[, status]
        if len(parts) < 8 or parts[4] != "namespaces":
            return self._json(404, {"kind": "Status", "code": 404})
        ns, name = parts[5], parts[7]
        sub = parts[8] if len(parts) > 8 else None
        key = f"{ns}/{name}"
        if method == "GET":
            with s.cond:
                cr = s.objects["workloads"].get(key)
            if cr is None:
                return self._json(404, {"kind": "Status", "code": 404})
            return self._json(200, cr)
        if method == "PUT" and sub == "status":
            body = self._body()
            with s.cond:  # upsert under the SAME hold: a racing
                # DELETE between check and write would otherwise be
                # resurrected by the status merge
                cur = s.objects["workloads"].get(key)
                if cur is None:
                    return self._json(404, {"kind": "Status", "code": 404})
                merged = dict(cur)
                merged["status"] = body.get("status", body)
                s.upsert("workloads", merged, "MODIFIED")
            return self._json(200, merged)
        if method == "DELETE":
            gone = s.remove("workloads", key)
            code = 200 if gone is not None else 404
            return self._json(code, {"kind": "Status", "code": code})
        self._json(405, {"kind": "Status", "code": 405})

    # ---------------------------------------------------------- lease verbs
    def _lease_verb(self, method: str, base: str) -> None:
        s = self.state
        name = base.rsplit("/", 1)[-1]
        if method == "GET":
            with s.cond:
                lease = s.leases.get(name)
            if lease is None:
                return self._json(404, {"kind": "Status", "code": 404})
            return self._json(200, lease)
        if method == "POST":
            body = self._body()
            name = body["metadata"]["name"]
            with s.cond:
                if name in s.leases:
                    return self._json(409, {"kind": "Status", "code": 409})
                s.rv += 1
                body["metadata"]["resourceVersion"] = str(s.rv)
                s.leases[name] = body
            return self._json(201, body)
        if method == "PUT":
            body = self._body()
            with s.cond:
                cur = s.leases.get(name)
                if cur is None:
                    return self._json(404, {"kind": "Status", "code": 404})
                # optimistic concurrency: stale resourceVersion = 409, the
                # exact mechanism two racing leader candidates are decided by
                sent = body.get("metadata", {}).get("resourceVersion")
                if sent != cur["metadata"]["resourceVersion"]:
                    return self._json(409, {
                        "kind": "Status", "code": 409,
                        "message": "resourceVersion conflict"})
                s.rv += 1
                body["metadata"]["resourceVersion"] = str(s.rv)
                s.leases[name] = body
            return self._json(200, body)
        self._json(405, {"kind": "Status", "code": 405})


class FakeApiServer:
    """Context manager: a live localhost API server + its state."""

    def __init__(self):
        self.state = FakeApiState()
        handler = type("Handler", (_Handler,), {"state": self.state})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        # end in-flight watch long-polls FIRST: a parked watch handler
        # thread otherwise lingers until its timeoutSeconds deadline
        # (up to 30s) after the last client dies — long enough to trip
        # a between-legs leak fence on handler threads that were always
        # going to exit
        self.state.cut_watches()
        self.httpd.shutdown()
        self.httpd.server_close()
        return False
