"""Bind-authority admission webhook: the chip/fence half of the conflict
battery, enforced at the API boundary of a VANILLA apiserver.

The sharded fleet (scheduler/fleet.py) commits binds optimistically and
leans on the AUTHORITY to 409 conflicting commits. Our fake authorities
(FakeCluster._check_bind, tests/fake_apiserver.py) check the full battery
— already-bound pod, chip-claim overlap, per-chip HBM, fencing epoch —
but a vanilla kube-apiserver natively enforces only the pod-level half:
the chip and fence annotations are opaque to it. This module ports the
chip/fence half to a real ``pods/binding`` ValidatingAdmissionWebhook so
the invariants hold against any conformant apiserver:

- ``ClaimIndex`` — the watch-fed view of who owns which chip: pod chip
  claims (the ``tpu/assigned-chips`` annotation that rides every Binding)
  and per-chip free HBM from the TpuNodeMetrics CRs.
- ``BindAuthority`` — the side-effect-free verdict function, operating on
  the same JSON wire shapes the apiserver POSTs: chip-claim overlap,
  per-chip HBM oversubscription, fencing-epoch staleness (the lease is
  read FRESH per fence-carrying bind — fences are exactly the check that
  must not be served from a stale cache). Denials carry **status code
  409** so the engine's existing conflict resolution (foreign-bind adopt
  / attempt-free local retry) applies verbatim.
- ``WebhookServer`` — the AdmissionReview v1 endpoint (stdlib HTTP(S);
  TLS via an ordinary cert/key pair, the same ssl plumbing KubeClient
  verifies against) plus ``/healthz``, ``/metrics``, ``/flightrecorder``.

Failure posture is explicit, twice over:

- the apiserver side: ``ValidatingWebhookConfiguration.failurePolicy``
  decides what happens when the webhook is UNREACHABLE (``Fail`` = binds
  500 until it returns — safety over availability, the recommended
  setting; ``Ignore`` = binds flow with only the pod-level 409, the
  documented unsafe-under-partition trade, see chaos.py WEBHOOK_DOWN);
- the webhook side: when its OWN claim index goes stale (watch feed dead
  past ``stale_after_s``), it degrades breaker-style instead of judging
  off rotten data — ``fail_open=False`` (default) denies with 503 until
  the feed recovers, ``fail_open=True`` allows-all (counted, and the
  flip is a flight-recorder trip kind).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .client import METRICS_PATH, Reflector
from .leaderelect import LEASE_PATH
from ..utils.obs import FlightRecorder, Metrics
from ..utils.pod import ASSIGNED_CHIPS_LABEL

log = logging.getLogger("yoda-tpu.webhook")

WEBHOOK_NAME = "yoda-bind-authority.yoda.tpu"
FENCE_ANNOTATION = "yoda.tpu/fence"
# the marker a real apiserver puts in front of every webhook denial; the
# engine side (core._is_authority_conflict, k8s/client.py) keys on it to
# route 400/403-coded denials through the 409 conflict path
DENIAL_MARKER = "denied the request"


def _pod_key(ns: str, name: str) -> str:
    return f"{ns}/{name}"


def _split_chips(raw: str) -> set[str]:
    """The wire chip-claim format: ';'-joined 'x,y,z' coordinate strings
    (utils.pod.format_assigned_chips). Compared as STRINGS, exactly like
    the fake apiserver — the webhook must agree with it bit for bit."""
    return {c for c in (raw or "").split(";") if c}


class ClaimIndex:
    """Thread-safe chip-claim + HBM view, fed by pod/metrics watch events
    (the webhook's informer cache). Tracks, per node, which chip is owned
    by which pod, and each chip's reported free HBM."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # pod key -> (node, frozenset(chip strs), scv/memory MB) — BOUND
        # pods only (the claim side)
        self._pods: dict[str, tuple[str, frozenset, int]] = {}
        # pod key -> scv/memory MB for EVERY non-terminal pod: the HBM
        # check needs the requirement of the pod being bound, which is
        # PENDING at admission time (a Binding carries no pod labels)
        self._mem: dict[str, int] = {}
        # node -> {chip str -> owning pod key}
        self._by_node: dict[str, dict[str, str]] = {}
        # node -> {chip str -> free HBM MB}
        self._hbm: dict[str, dict[str, int]] = {}
        # PROVISIONAL claims: chips of bindings this authority ALLOWED
        # whose confirming watch event has not landed yet. Admission is
        # synchronous but the index is watch-fed — without these, two
        # back-to-back conflicting bindings inside the watch-latency
        # window would both pass. An entry is superseded by the pod's
        # next watch event (truth either way) and expires after ttl as a
        # backstop for an admitted bind the apiserver then rejected
        # (recheck 409) with no pod event to clear it.
        # pod key -> (node, frozenset(chips), deadline)
        self._prov: dict[str, tuple[str, frozenset, float]] = {}

    # ----------------------------------------------------------- pod feed
    def _drop_locked(self, key: str) -> None:
        old = self._pods.pop(key, None)
        if old is None:
            return
        node_map = self._by_node.get(old[0])
        if node_map:
            for c in old[1]:
                if node_map.get(c) == key:
                    del node_map[c]

    def apply_pod(self, typ: str, obj: dict) -> None:
        meta = obj.get("metadata", {}) or {}
        key = _pod_key(meta.get("namespace", "default"), meta.get("name", ""))
        with self._lock:
            self._drop_locked(key)
            self._mem.pop(key, None)
            if typ == "DELETED":
                # the pod is gone: its provisional claim is moot
                self._prov.pop(key, None)
                return
            phase = (obj.get("status") or {}).get("phase", "")
            if phase in ("Succeeded", "Failed"):
                self._prov.pop(key, None)
                return  # terminal: claims nothing, needs nothing
            mem = int((meta.get("labels") or {}).get("scv/memory", "0")
                      or 0)
            if mem:
                self._mem[key] = mem
            node = (obj.get("spec") or {}).get("nodeName")
            if not node:
                # pending view: deliberately NOT clearing the provisional
                # claim — this may be a RELIST snapshot taken before the
                # admission we just allowed, and clearing on it would
                # reopen the watch-latency double-booking window. A bind
                # the apiserver ultimately rejected expires via the TTL.
                return
            # bound truth supersedes the provisional claim
            self._prov.pop(key, None)
            ann = meta.get("annotations") or {}
            chips = frozenset(_split_chips(ann.get(ASSIGNED_CHIPS_LABEL, "")))
            self._pods[key] = (node, chips, mem)
            node_map = self._by_node.setdefault(node, {})
            for c in chips:
                node_map[c] = key

    def replace_pods(self, items: list[dict]) -> None:
        """Full relist: build the fresh maps OFF TO THE SIDE and swap
        them in under one lock acquisition — a clear-then-repopulate
        would give concurrent admissions an empty claim index for the
        duration of every relist."""
        pods: dict[str, tuple[str, frozenset, int]] = {}
        by_node: dict[str, dict[str, str]] = {}
        mem_map: dict[str, int] = {}
        confirmed: set[str] = set()
        for obj in items:
            meta = obj.get("metadata", {}) or {}
            key = _pod_key(meta.get("namespace", "default"),
                           meta.get("name", ""))
            phase = (obj.get("status") or {}).get("phase", "")
            if phase in ("Succeeded", "Failed"):
                confirmed.add(key)  # terminal truth retires provisionals
                continue
            mem = int((meta.get("labels") or {}).get("scv/memory", "0")
                      or 0)
            if mem:
                mem_map[key] = mem
            node = (obj.get("spec") or {}).get("nodeName")
            if not node:
                continue  # pending view: provisional (if any) survives
            confirmed.add(key)
            ann = meta.get("annotations") or {}
            chips = frozenset(_split_chips(
                ann.get(ASSIGNED_CHIPS_LABEL, "")))
            pods[key] = (node, chips, mem)
            node_map = by_node.setdefault(node, {})
            for c in chips:
                node_map[c] = key
        with self._lock:
            self._pods = pods
            self._by_node = by_node
            self._mem = mem_map
            for key in confirmed:
                self._prov.pop(key, None)

    # ------------------------------------------------------- metrics feed
    def apply_metric(self, typ: str, obj: dict) -> None:
        node = (obj.get("metadata") or {}).get("name", "")
        if not node:
            return
        with self._lock:
            if typ == "DELETED":
                self._hbm.pop(node, None)
                return
            chips = (obj.get("status") or {}).get("chips", []) or []
            table: dict[str, int] = {}
            for c in chips:
                coords = c.get("coords")
                if coords is not None:
                    table[",".join(str(x) for x in coords)] = int(
                        c.get("hbm_free_mb", 1 << 60))
            self._hbm[node] = table

    def replace_metrics(self, items: list[dict]) -> None:
        fresh: dict[str, dict[str, int]] = {}
        for obj in items:
            node = (obj.get("metadata") or {}).get("name", "")
            if not node:
                continue
            table: dict[str, int] = {}
            for c in (obj.get("status") or {}).get("chips", []) or []:
                coords = c.get("coords")
                if coords is not None:
                    table[",".join(str(x) for x in coords)] = int(
                        c.get("hbm_free_mb", 1 << 60))
            fresh[node] = table
        with self._lock:  # one swap, never a half-empty HBM view
            self._hbm = fresh

    # ------------------------------------------------------------- queries
    def pod_memory_mb(self, key: str) -> int:
        with self._lock:
            return self._mem.get(key, 0)

    def provisional_claim(self, key: str, node: str, chips,
                          ttl_s: float = 30.0) -> None:
        """Record an ALLOWED binding's chips until the watch confirms it
        (see _prov)."""
        with self._lock:
            self._prov[key] = (node, frozenset(chips),
                               time.monotonic() + ttl_s)

    def _owner_locked(self, node: str, chip: str,
                      exclude: str) -> str | None:
        owner = self._by_node.get(node, {}).get(chip)
        if owner is not None and owner != exclude:
            return owner
        now = time.monotonic()
        for key, (pnode, pchips, deadline) in self._prov.items():
            if (pnode == node and chip in pchips and key != exclude
                    and deadline > now):
                return key
        return None

    def chip_owner(self, node: str, chip: str, exclude: str) -> str | None:
        """Owning pod of `node`/`chip`, ignoring `exclude` (a replayed
        bind of the SAME pod must not conflict with its own claim).
        Confirmed claims first, then unexpired provisional ones."""
        with self._lock:
            return self._owner_locked(node, chip, exclude)

    def check_and_claim(self, key: str, node: str, chips,
                        ttl_s: float = 30.0):
        """ATOMIC verdict + reservation: scan every requested chip for a
        confirmed/provisional owner and — only if all are free — record
        the provisional claim, under ONE lock acquisition. Two
        concurrent AdmissionReviews for the same chip (ThreadingHTTPServer
        runs one thread per connection) must serialize HERE; a check
        followed by a separate claim write would let both pass. Returns
        (conflicting chip, owner) or None on success."""
        with self._lock:
            for chip in sorted(chips):
                owner = self._owner_locked(node, chip, exclude=key)
                if owner is not None:
                    return chip, owner
            self._prov[key] = (node, frozenset(chips),
                               time.monotonic() + ttl_s)
            return None

    def chip_hbm_free(self, node: str, chip: str) -> int | None:
        with self._lock:
            table = self._hbm.get(node)
            return table.get(chip) if table is not None else None

    def stats(self) -> dict:
        with self._lock:
            return {"pods": len(self._pods),
                    "nodes_with_claims": len(self._by_node),
                    "nodes_with_metrics": len(self._hbm)}


class BindAuthority:
    """The verdict function + self-degradation state machine.

    ``check(binding)`` returns ``(allowed, code, message)``. Denials for
    genuine conflicts carry 409 (the engine's conflict path); fail-closed
    staleness denials carry 503 (retryable — the engine backs off and the
    bind succeeds once the index recovers)."""

    def __init__(self, index: ClaimIndex | None = None,
                 lease_get=None, fail_open: bool = False,
                 stale_after_s: float = 30.0, metrics: Metrics | None = None,
                 flight: FlightRecorder | None = None,
                 now=time.monotonic) -> None:
        self.index = index or ClaimIndex()
        # lease_get(name) -> lease dict | None. Fences are validated
        # against a FRESH read: the fencing epoch is exactly the check a
        # stale cache must never serve.
        self.lease_get = lease_get
        self.fail_open = bool(fail_open)
        self.stale_after_s = stale_after_s
        self.metrics = metrics or Metrics()
        self.flight = flight or FlightRecorder()
        self._now = now
        # BORN STALE: a freshly (re)started webhook has an EMPTY claim
        # index and must not judge binds off it — it stays in its
        # degradation posture until the feed's first successful list
        # calls touch(). (A restart racing a busy scheduler would
        # otherwise allow everything for up to stale_after_s.)
        self._last_fresh: float | None = None
        self._degraded = False
        self._lock = threading.Lock()

    # -------------------------------------------------------- feed health
    def touch(self) -> None:
        """The claim-index feed proved itself alive (a list replaced the
        cache, or a watch event applied). Called from the feed threads."""
        self._last_fresh = self._now()
        if self._degraded:
            with self._lock:
                if self._degraded:
                    self._degraded = False
                    self.metrics.set_gauge("webhook_index_stale", 0.0)
                    self.flight.record("webhook_fail_open",
                                       state="recovered",
                                       fail_open=self.fail_open)
                    log.warning("claim index fresh again: full validation "
                                "restored")

    def stale(self) -> bool:
        """Breaker-style degradation: the feed has not proven itself alive
        within stale_after_s — or has NEVER synced (cold start). The FLIP
        (either direction) is recorded once — a flapping feed reads as
        flip events, not one per admission."""
        is_stale = (self._last_fresh is None
                    or self._now() - self._last_fresh > self.stale_after_s)
        if is_stale and not self._degraded:
            with self._lock:
                if not self._degraded:
                    self._degraded = True
                    self.metrics.set_gauge("webhook_index_stale", 1.0)
                    # trip kind: the black box dumps (rate-limited) the
                    # moment the authority stops being able to judge
                    self.flight.record("webhook_fail_open",
                                       state="degraded",
                                       fail_open=self.fail_open)
                    log.warning(
                        "claim index stale (> %.1fs without feed "
                        "activity): %s", self.stale_after_s,
                        "allowing all binds (fail-open)" if self.fail_open
                        else "denying all binds (fail-closed)")
        return is_stale

    # ------------------------------------------------------------ verdict
    def _deny(self, reason: str, code: int, message: str):
        self.metrics.inc("webhook_denials_total", labels={"reason": reason})
        # webhook_deny is a trip kind: a denial is the authority actually
        # catching a would-be double-booking — worth a (rate-limited) dump
        self.flight.record("webhook_deny", reason=reason, message=message)
        return False, code, message

    def check(self, binding: dict) -> tuple[bool, int, str]:
        meta = binding.get("metadata", {}) or {}
        pod_key = _pod_key(meta.get("namespace", "default"),
                           meta.get("name", ""))
        node = (binding.get("target") or {}).get("name", "")
        ann = meta.get("annotations") or {}

        # fence FIRST: it is validated against a FRESH lease read, never
        # the index — so it stays enforced even while the index is stale
        # (a zombie replica's split-brain bind must bounce during
        # exactly the degraded window fencing exists for)
        fence = ann.get(FENCE_ANNOTATION)
        if fence:
            try:
                lease_name, holder, epoch = fence.rsplit("/", 2)
            except ValueError:
                return self._deny("malformed_fence", 409,
                                  f"malformed fencing token {fence!r}")
            lease = self.lease_get(lease_name) if self.lease_get else None
            spec = (lease or {}).get("spec", {}) or {}
            if (lease is None or spec.get("holderIdentity") != holder
                    or str(spec.get("leaseTransitions", 0)) != epoch):
                return self._deny(
                    "stale_fence", 409,
                    f"stale fencing token {fence!r}: lease held by "
                    f"{spec.get('holderIdentity')!r} at transition "
                    f"{spec.get('leaseTransitions')}")

        if self.stale():
            if self.fail_open:
                self.metrics.inc("webhook_fail_open_allows_total")
                return True, 200, "claim index stale; allowed (fail-open)"
            return self._deny(
                "index_stale", 503,
                f"claim index stale for > {self.stale_after_s:.0f}s and "
                "failOpen=false: denying until the watch feed recovers")

        claimed = _split_chips(ann.get(ASSIGNED_CHIPS_LABEL, ""))
        if not claimed:
            self.metrics.inc("webhook_allows_total")
            return True, 200, "no chip claim"

        # HBM is a read-only predicate on the requested chips: checked
        # BEFORE the claim is written, so a denial never leaves a
        # provisional reservation behind
        need_mb = self.index.pod_memory_mb(pod_key)
        if need_mb:
            for chip in sorted(claimed):
                free = self.index.chip_hbm_free(node, chip)
                if free is not None and need_mb > free:
                    return self._deny(
                        "hbm", 409,
                        f"HBM oversubscription on {node}/{chip}: need "
                        f"{need_mb}MB > free {free}MB")

        # chip overlap + provisional reservation, ATOMICALLY: concurrent
        # reviews (one apiserver thread each) for the same chip must
        # serialize inside the index, not between two lock acquisitions
        conflict = self.index.check_and_claim(pod_key, node, claimed)
        if conflict is not None:
            chip, owner = conflict
            return self._deny(
                "chip_claim", 409,
                f"chip claim conflict on {node}: {chip} already "
                f"owned by {owner}")
        self.metrics.inc("webhook_allows_total")
        return True, 200, "no conflict"

    # ------------------------------------------------- AdmissionReview v1
    def review(self, doc: dict) -> dict:
        """One AdmissionReview round: request in, response out. Malformed
        reviews are DENIED (400) — a validating webhook that allows what
        it cannot parse is no authority at all."""
        req = doc.get("request") or {}
        uid = req.get("uid", "")
        binding = req.get("object") or {}
        if not binding or binding.get("kind") not in (None, "Binding"):
            allowed, code, message = self._deny(
                "malformed_review", 400,
                f"expected a Binding object, got "
                f"{binding.get('kind')!r}")
        else:
            allowed, code, message = self.check(binding)
        resp: dict = {"uid": uid, "allowed": allowed}
        if not allowed:
            resp["status"] = {"code": code, "message": message,
                              "reason": "Conflict" if code == 409
                              else "ServiceUnavailable" if code == 503
                              else "BadRequest"}
        return {"apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview", "response": resp}


class WebhookServer:
    """The HTTP(S) surface + the watch feed. POST /validate speaks
    AdmissionReview v1; GET /healthz (also reports index freshness),
    /metrics, /flightrecorder mirror the scheduler's observability
    endpoints. TLS: pass cert/key paths (a ValidatingWebhookConfiguration
    requires an HTTPS callee; plain HTTP stays available for in-process
    tests and the fake apiserver)."""

    def __init__(self, authority: BindAuthority,
                 host: str = "0.0.0.0", port: int = 0,
                 certfile: str | None = None,
                 keyfile: str | None = None) -> None:
        self.authority = authority
        auth = authority

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # NODELAY: a response goes out as two writes (headers, then the
            # body); on a kept-alive connection, as an apiserver holds to
            # its webhooks, Nagle holds the body until the caller's delayed
            # ACK of the headers, ~40 ms a review on Linux
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet
                return

            def _send(self, status: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 (http.server API)
                n = int(self.headers.get("Content-Length", 0) or 0)
                raw = self.rfile.read(n) if n else b""
                if self.path not in ("/validate", "/"):
                    return self._send(404, b'{"error": "not found"}')
                try:
                    doc = json.loads(raw)
                except ValueError:
                    return self._send(400, b'{"error": "bad json"}')
                auth.metrics.inc("webhook_reviews_total")
                out = auth.review(doc)
                self._send(200, json.dumps(out).encode())

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    stale = auth.stale()
                    doc = {"ok": not stale, "stale": stale,
                           "fail_open": auth.fail_open,
                           **auth.index.stats()}
                    # readiness semantics: a stale fail-CLOSED webhook
                    # reports 503 so the Deployment's readinessProbe
                    # keeps it out of rotation (every verdict it could
                    # give is a deny anyway); fail-open keeps serving
                    return self._send(
                        503 if stale and not auth.fail_open else 200,
                        json.dumps(doc).encode())
                if self.path == "/metrics":
                    return self._send(
                        200, auth.metrics.render_prometheus().encode(),
                        "text/plain; version=0.0.4")
                if self.path == "/flightrecorder":
                    return self._send(
                        200, json.dumps(auth.flight.snapshot()).encode())
                self._send(404, b'{"error": "not found"}')

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.scheme = "http"
        if certfile:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True)
            self.scheme = "https"
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._feed_threads: list[threading.Thread] = []

    @property
    def url(self) -> str:
        return f"{self.scheme}://127.0.0.1:{self.port}/validate"

    def start(self) -> "WebhookServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="webhook")
        self._thread.start()
        return self

    # ------------------------------------------------------------ the feed
    def start_feed(self, client, relist_s: float = 10.0) -> None:
        """Feed the claim index from the apiserver: pod + TpuNodeMetrics
        reflectors (watch mode when the client can stream, poll re-lists
        otherwise), and a fresh lease GET per fence check. Every successful
        list/event stamps the authority's freshness — the staleness
        breaker is armed by exactly this feed going quiet."""
        auth = self.authority
        index = auth.index

        if auth.lease_get is None:
            def lease_get(name: str, _client=client):
                try:
                    return _client.request(
                        "GET", LEASE_PATH.format(ns="kube-system",
                                                 name=name),
                        timeout=3.0, retries=1)
                except Exception:
                    return None
            auth.lease_get = lease_get

        def on_pods_replace(items):
            index.replace_pods(items)
            auth.touch()

        def on_pod_event(typ, obj):
            index.apply_pod(typ, obj)
            auth.touch()

        def on_metrics_replace(items):
            index.replace_metrics(items)
            auth.touch()

        def on_metric_event(typ, obj):
            index.apply_metric(typ, obj)
            auth.touch()

        if client.can_stream:
            for path, rep, ev in (
                    ("/api/v1/pods", on_pods_replace, on_pod_event),
                    (METRICS_PATH, on_metrics_replace, on_metric_event)):
                r = Reflector(client, path, rep, ev, relist_s=relist_s,
                              metrics=auth.metrics)
                t = threading.Thread(target=r.run, args=(self._stop,),
                                     daemon=True,
                                     name=f"webhook-feed:{path}")
                self._feed_threads.append(t)
                t.start()
            return

        def poll():
            while not self._stop.is_set():
                try:
                    on_pods_replace(
                        client.list_all("/api/v1/pods").get("items", []))
                    on_metrics_replace(
                        client.list_all(METRICS_PATH).get("items", []))
                except Exception as e:
                    log.warning("claim-index poll failed: %s", e)
                self._stop.wait(relist_s)

        t = threading.Thread(target=poll, daemon=True, name="webhook-feed")
        self._feed_threads.append(t)
        t.start()

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        for t in self._feed_threads:
            t.join(timeout=2.0)
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def serve_webhook(client, port: int, certfile: str | None = None,
                  keyfile: str | None = None, fail_open: bool = False,
                  stale_after_s: float = 30.0, relist_s: float = 10.0,
                  host: str = "0.0.0.0") -> WebhookServer:
    """Build + start the full webhook (server + feed) against an
    apiserver client — the `yoda-tpu webhook` CLI entry point and the
    deploy/gpu-bind-authority-webhook.yaml container command."""
    auth = BindAuthority(fail_open=fail_open, stale_after_s=stale_after_s)
    server = WebhookServer(auth, host=host, port=port,
                           certfile=certfile, keyfile=keyfile)
    server.start()
    server.start_feed(client, relist_s=relist_s)
    log.info("bind-authority webhook on %s (fail_open=%s)",
             server.url, fail_open)
    return server
