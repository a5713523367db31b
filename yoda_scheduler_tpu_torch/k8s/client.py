"""Kubernetes API client + watch-cache cluster adapter (stdlib only, gated).

The reference talks to the API server through client-go/controller-runtime:
its hot path reads an informer-backed in-memory cache fed by WATCH streams
(reference pkg/yoda/scheduler.go:53-68), never a per-decision API roundtrip.
This module reproduces that architecture over urllib:

- `KubeClient` — the REST verbs with bounded retry/backoff on transient
  errors, 409-aware bind, and paginated lists (limit/continue).
- `watch()` — a streaming `watch=true` GET yielding newline-delimited
  events, with resourceVersion bookmarks.
- `Reflector` — the list+watch loop: one paginated LIST to seed the cache,
  then incremental WATCH events; a 410 Gone (compacted resourceVersion)
  triggers an immediate re-list, exactly the client-go reflector contract.
- `KubeCluster` — the cluster interface (scheduler/cluster.py contract)
  over three reflectors (nodes, pods, TpuNodeMetrics CRs). Falls back to
  periodic poll re-lists when the transport cannot stream (injected fake
  transports without a stream side).

Everything is injectable (`transport` + `stream_transport` callables) so
the full path is unit-testable without a cluster; `from_env` returns None
when no API server is reachable (the CLI then tells the user to use
`simulate`).
"""

from __future__ import annotations

import json
import logging
import os
import random
import ssl
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import deque

from ..scheduler.columnar import pool_of
from ..scheduler.framework import (
    ClusterEvent,
    NODE_ADDED,
    NODE_SPEC_CHANGED,
    POD_BOUND,
    POD_DELETED,
    POD_PENDING_ARRIVED,
)
from ..telemetry.schema import CRD_GROUP, CRD_PLURAL, CRD_VERSION, TpuNodeMetrics
from ..telemetry.store import TelemetryStore
from ..utils.obs import Metrics, SpanRing, span_sampled
from ..utils.changelog import ChangeLog
from ..utils.pod import ASSIGNED_CHIPS_LABEL, Pod, PodPhase, format_assigned_chips

log = logging.getLogger("yoda-tpu.k8s")

METRICS_PATH = f"/apis/{CRD_GROUP}/{CRD_VERSION}/{CRD_PLURAL}"
PDB_PATH = "/apis/policy/v1/poddisruptionbudgets"

# transient statuses worth retrying: throttled, server hiccups, gateway
_RETRYABLE = {429, 500, 502, 503, 504}


class ApiError(RuntimeError):
    """Non-2xx API response, carrying the status code for callers that
    branch on it (409 conflict, 410 gone, 404 absent)."""

    def __init__(self, method: str, path: str, status: int, body: bytes = b""):
        self.status = status
        self.body = body
        super().__init__(f"{method} {path} -> {status}: {body[:200]!r}")


def is_webhook_denial(e: Exception) -> bool:
    """A validating-admission-webhook DENIAL: the apiserver surfaces it
    with the webhook's status code (ours sets 409; third-party webhooks
    commonly 400/403) and the canonical 'admission webhook "..." denied
    the request' message. For the bind path a denial is an authority
    conflict verdict — it must take the 409 recovery protocol, never the
    wire-failure path (core._is_authority_conflict is the engine twin)."""
    status = getattr(e, "status", None)
    if status not in (400, 403, 409):
        return False
    text = getattr(e, "body", b"") or str(e).encode()
    if isinstance(text, str):
        text = text.encode()
    return b"denied the request" in text


class AmbiguousRequestError(ConnectionError):
    """A NON-IDEMPOTENT request (POST/PUT/DELETE) failed after it may
    already have been written to the server — the mutation may or may not
    have been applied. Never retried by request(): a replayed bind or
    lease POST whose first copy succeeded surfaces as a spurious 409.
    Callers see ApiError(status=0) and own the recovery
    (bind's 409 protocol; the watch cache self-heals the state)."""


class WatchExpired(Exception):
    """The watch resourceVersion was compacted away (410 Gone): the caller
    must re-list and start a fresh watch."""


class _NoCloseReader:
    """Buffered-reader proxy that ignores close(): successive pipelined
    HTTPResponse objects share ONE reader (each would otherwise close —
    and tear the buffer of — the stream the next response needs)."""

    __slots__ = ("_fp",)

    def __init__(self, fp) -> None:
        self._fp = fp

    def close(self) -> None:
        pass

    def flush(self) -> None:
        pass

    def __getattr__(self, name):
        return getattr(self._fp, name)


class _PipeReader:
    """Socket stand-in handed to http.client.HTTPResponse for pipelined
    response parsing: makefile() returns the SHARED no-close reader, so
    buffered bytes of the next response survive the previous response's
    teardown."""

    __slots__ = ("_reader",)

    def __init__(self, fp) -> None:
        self._reader = _NoCloseReader(fp)

    def makefile(self, *a, **kw):
        return self._reader


_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
_IN_CLUSTER_CA = f"{_SA_DIR}/ca.crt"


class KubeClient:
    def __init__(self, base_url: str, token: str | None = None,
                 ca_file: str | None = None, transport=None,
                 stream_transport=None, max_retries: int = 4,
                 retry_backoff_s: float = 0.25,
                 insecure_skip_tls_verify: bool = False,
                 ca_data: str | None = None) -> None:
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self._ctx = None
        self._tlocal = threading.local()  # keep-alive connection pool
        self._base_path = urllib.parse.urlsplit(self.base_url).path.rstrip("/")
        # open streaming responses; close_streams() unblocks reflector
        # threads parked in readline() so stop() doesn't wait on a socket
        # timeout (set add/discard are atomic under the GIL). _closing
        # marks the terminal shutdown so a stream that finishes OPENING
        # just after close_streams ran is shut down at registration
        # instead of blocking its reflector until the watch deadline.
        self._live_streams: set = set()
        self._closing = False
        if transport is not None:
            self._transport = transport
            # injected fakes stream only if they provide the stream side
            self._stream = stream_transport
        else:
            if base_url.startswith("https"):
                # VERIFY by default: an https API server is authenticated
                # against the given CA bundle, the in-cluster service-
                # account CA when present, or the system trust store —
                # never silently skipped (the old unverified default let
                # any MITM read the Bearer token). The explicit
                # --insecure-skip-tls-verify escape hatch remains for lab
                # clusters with self-signed certs and no CA at hand.
                if insecure_skip_tls_verify:
                    self._ctx = ssl._create_unverified_context()
                elif ca_data:
                    # kubeconfig certificate-authority-data (PEM, already
                    # base64-decoded by the caller)
                    self._ctx = ssl.create_default_context(cadata=ca_data)
                elif ca_file:
                    # an EXPLICIT CA that can't be loaded must fail loudly
                    # (kubectl behavior) — silently falling back to a
                    # different trust store would verify against a CA the
                    # operator never chose
                    self._ctx = ssl.create_default_context(cafile=ca_file)
                elif os.path.exists(_IN_CLUSTER_CA):
                    self._ctx = ssl.create_default_context(
                        cafile=_IN_CLUSTER_CA)
                else:
                    self._ctx = ssl.create_default_context()  # system roots
            self._transport = self._urllib_transport
            self._stream = stream_transport or self._urllib_stream

    @property
    def can_stream(self) -> bool:
        return self._stream is not None

    # ------------------------------------------------------------- transport
    def _mk_request(self, method: str, path: str, body: dict | None):
        req = urllib.request.Request(
            self.base_url + path, method=method,
            data=json.dumps(body).encode() if body is not None else None,
        )
        for k, v in self._headers(method, body).items():
            req.add_header(k, v)
        return req

    def _pooled_conn(self, timeout: float):
        """Thread-local keep-alive connection. urllib opens (and for TLS,
        handshakes) a fresh TCP connection per request — on the serve
        path that tax lands on every bind + annotation patch. Real API
        servers speak HTTP/1.1 with persistent connections; so does the
        in-process fake. Environment proxies (HTTPS_PROXY/NO_PROXY) are
        honoured like urllib does for the watch streams: https targets
        tunnel through CONNECT, http targets send absolute URIs."""
        import http.client

        conn = getattr(self._tlocal, "conn", None)
        if conn is None:
            u = urllib.parse.urlsplit(self.base_url)
            port = u.port or (443 if u.scheme == "https" else 80)
            proxy = urllib.request.getproxies().get(u.scheme)
            if proxy and urllib.request.proxy_bypass(u.hostname):
                proxy = None
            self._tlocal.abs_uri = False
            if proxy:
                pu = urllib.parse.urlsplit(proxy)
                pport = pu.port or (443 if pu.scheme == "https" else 80)
                if u.scheme == "https":
                    conn = http.client.HTTPSConnection(
                        pu.hostname, pport, timeout=timeout,
                        context=self._ctx)
                    conn.set_tunnel(u.hostname, port)
                else:
                    conn = http.client.HTTPConnection(
                        pu.hostname, pport, timeout=timeout)
                    self._tlocal.abs_uri = True
            elif u.scheme == "https":
                conn = http.client.HTTPSConnection(
                    u.hostname, port, timeout=timeout, context=self._ctx)
            else:
                conn = http.client.HTTPConnection(
                    u.hostname, port, timeout=timeout)
            self._tlocal.conn = conn
        conn.timeout = timeout
        if conn.sock is None:
            try:
                conn.connect()
            except BaseException:
                # a failed TLS handshake leaves conn.sock set to the
                # PLAIN socket — pooling it would make the next attempt
                # skip connect() and write the request (Bearer token
                # included) unencrypted to whatever killed the handshake
                self._drop_conn()
                raise
            # persistent small-request traffic: Nagle against delayed
            # ACKs adds ~40-200ms stalls per exchange on a reused
            # connection (fresh connections never lived long enough)
            import socket as _socket

            try:
                conn.sock.setsockopt(_socket.IPPROTO_TCP,
                                     _socket.TCP_NODELAY, 1)
            except OSError:
                pass  # non-TCP transports (unix-socket proxies)
        conn.sock.settimeout(timeout)
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._tlocal, "conn", None)
        if conn is not None:
            self._tlocal.conn = None
            try:
                conn.close()
            except Exception:
                pass

    def _headers(self, method: str, body: dict | None) -> dict:
        """Request headers, shared by the pooled transport and the urllib
        stream path so auth/content-type changes apply to both."""
        headers = {"Accept": "application/json"}
        if body is not None:
            # the API server rejects PATCH bodies that don't declare a
            # patch content type with 415
            headers["Content-Type"] = (
                "application/merge-patch+json" if method == "PATCH"
                else "application/json")
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        return headers

    def _urllib_transport(self, method: str, path: str, body: dict | None,
                          timeout: float):
        import http.client
        import ssl as _ssl

        data = json.dumps(body).encode() if body is not None else None
        headers = self._headers(method, body)
        # one silent reconnect: a pooled connection the server idled out
        # half-closes between requests (plain FIN or a TLS close_notify),
        # which is not a request failure and must not consume the
        # caller's retry budget. Only IDEMPOTENT requests (GET/HEAD, and
        # merge-PATCH whose replay converges) may be replayed on an
        # ambiguous failure — a RemoteDisconnected after a POST (bind,
        # eviction) can arrive AFTER the server fully processed the
        # mutation, and replaying it would surface a spurious 409 and a
        # wrong failed cycle. Non-idempotent methods retry
        # only on CannotSendRequest, which provably fires before the
        # request was written.
        idempotent = method in ("GET", "HEAD", "PATCH")
        for attempt in (0, 1):
            conn = self._pooled_conn(timeout)
            target = (self.base_url + path
                      if getattr(self._tlocal, "abs_uri", False)
                      else self._base_path + path)
            try:
                conn.request(method, target, body=data, headers=headers)
                r = conn.getresponse()
                raw = r.read()
            except (http.client.BadStatusLine,
                    http.client.RemoteDisconnected,
                    http.client.CannotSendRequest,
                    _ssl.SSLError,
                    ConnectionResetError, BrokenPipeError) as e:
                self._drop_conn()
                if idempotent or isinstance(e, http.client.CannotSendRequest):
                    if attempt:
                        raise ConnectionError(str(e)) from e
                    continue
                # non-idempotent + possibly-written: typed so request()
                # never burns its retry budget replaying the mutation
                raise AmbiguousRequestError(str(e)) from e
            except Exception:
                self._drop_conn()  # unknown state: never reuse
                raise
            if r.will_close:
                self._drop_conn()
            # redirects are REFUSED, never followed: auto-following would
            # replay the Authorization Bearer token to whatever Location
            # the server returned (possibly another host, possibly an
            # https->http downgrade). Kubernetes API endpoints do not
            # redirect; a 3xx here means a misconfigured ingress and
            # surfaces as ApiError(status) for the operator to fix. The
            # stream path refuses identically (_no_redirect_opener).
            return r.status, raw

    def _no_redirect_opener(self):
        """urllib opener that refuses redirects instead of following them
        with the Authorization header attached (same policy as the pooled
        REST transport)."""
        class _NoRedirect(urllib.request.HTTPRedirectHandler):
            def redirect_request(self, *a, **kw):
                return None  # urllib then raises HTTPError(3xx)

        handlers: list = [_NoRedirect()]
        if self._ctx is not None:
            handlers.append(urllib.request.HTTPSHandler(context=self._ctx))
        return urllib.request.build_opener(*handlers)

    def _urllib_stream(self, method: str, path: str, timeout: float):
        """Yield response lines from a streaming (watch) request. The HTTP
        status is checked before the first yield; non-2xx raises ApiError."""
        req = self._mk_request(method, path, None)
        try:
            resp = self._no_redirect_opener().open(req, timeout=timeout)
        except urllib.error.HTTPError as e:
            raise ApiError(method, path, e.code, e.read()) from None
        self._live_streams.add(resp)
        if self._closing:
            # shutdown raced this stream's open: close it NOW (nothing
            # has read from it yet, so no parked reader to unblock), or
            # the reflector blocks in readline() until the watch deadline
            self._live_streams.discard(resp)
            resp.close()
            return
        try:
            while True:
                line = resp.readline()
                if not line:
                    break  # server closed the stream (timeoutSeconds)
                yield line
        finally:
            self._live_streams.discard(resp)
            resp.close()

    def close_streams(self) -> None:
        """Force-close every live watch stream (shutdown path). A plain
        close() of the fd does NOT unblock a reader parked in recv() on
        Linux — shut the socket down first."""
        import socket as _socket

        self._closing = True

        for resp in list(self._live_streams):
            try:
                # the response's file object is either a BufferedReader
                # over a raw SocketIO (fp.raw._sock) or the SocketIO
                # itself (fp._sock) depending on how the stream was
                # opened — dig through both shapes
                fp = getattr(resp, "fp", None)
                raw = getattr(fp, "raw", fp)
                sock = getattr(raw, "_sock", None)
                if sock is not None:
                    sock.shutdown(_socket.SHUT_RDWR)
            except Exception:
                pass
            try:
                resp.close()
            except Exception:
                pass

    def request(self, method: str, path: str, body: dict | None = None,
                timeout: float = 10.0, retries: int | None = None) -> dict:
        """One API call with bounded retry/backoff on transient failures
        (connection errors, 429, 5xx). Non-retryable statuses raise
        ApiError immediately. Mutating verbs are retried on failures that
        provably preceded the write (connection refused, timeout before
        send) — but an AMBIGUOUS failure on a non-idempotent verb (the
        connection died after the request may have reached the server) is
        never replayed: the mutation may have been applied, and a replay
        surfaces as a spurious 409 (bind/PUT conflicts surface as 409,
        which is NOT retried here either; see `bind` for the 409
        recovery protocol)."""
        retries = self.max_retries if retries is None else retries
        backoff = self.retry_backoff_s
        attempt = 0
        while True:
            try:
                status, raw = self._transport(method, path, body, timeout)
            except AmbiguousRequestError as e:
                raise ApiError(method, path, 0, str(e).encode()) from e
            except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as e:
                if attempt >= retries:
                    raise ApiError(method, path, 0, str(e).encode()) from e
                attempt += 1
                time.sleep(backoff)
                backoff *= 2
                continue
            if status >= 300:
                if status in _RETRYABLE and attempt < retries:
                    attempt += 1
                    time.sleep(backoff)
                    backoff *= 2
                    continue
                raise ApiError(method, path, status, raw)
            return json.loads(raw) if raw else {}

    # ------------------------------------------------------------ finding us
    @classmethod
    def _candidates_from_env(cls, kubeconfig: str | None = None,
                             apiserver: str | None = None,
                             insecure_skip_tls_verify: bool = False
                             ) -> "list[KubeClient]":
        """Candidate clients in probe order: explicit --apiserver,
        in-cluster service account (token + mounted CA), kubeconfig
        (honouring its certificate-authority path and
        insecure-skip-tls-verify flag). Split from from_env so the
        construction — TLS wiring included — is unit-testable without a
        reachable cluster."""
        candidates: list[KubeClient] = []
        if apiserver:
            candidates.append(cls(
                apiserver,
                insecure_skip_tls_verify=insecure_skip_tls_verify))
        if os.path.exists(f"{_SA_DIR}/token"):
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if host:
                with open(f"{_SA_DIR}/token") as f:
                    token = f.read()
                candidates.append(cls(
                    f"https://{host}:{port}", token=token,
                    # the SA CA is a DISCOVERED default, not an operator
                    # choice: absent (token-only mounts) falls through to
                    # the system roots instead of raising
                    ca_file=(_IN_CLUSTER_CA
                             if os.path.exists(_IN_CLUSTER_CA) else None),
                    insecure_skip_tls_verify=insecure_skip_tls_verify))
        cfg_path = kubeconfig or os.environ.get(
            "KUBECONFIG", os.path.expanduser("~/.kube/config"))
        if os.path.exists(cfg_path):
            try:
                import base64

                import yaml

                with open(cfg_path) as f:
                    doc = yaml.safe_load(f)
                cl = doc["clusters"][0]["cluster"]
                # inline CA (kind/minikube/GKE kubeconfigs embed the PEM
                # as base64 certificate-authority-data)
                ca_data = cl.get("certificate-authority-data")
                if ca_data:
                    ca_data = base64.b64decode(ca_data).decode()
                # a relative certificate-authority path resolves against
                # the kubeconfig's own directory, as kubectl does
                ca_file = cl.get("certificate-authority")
                if ca_file and not os.path.isabs(ca_file):
                    ca_file = os.path.join(
                        os.path.dirname(os.path.abspath(cfg_path)), ca_file)
                candidates.append(cls(
                    cl["server"],
                    ca_file=ca_file,
                    ca_data=ca_data,
                    insecure_skip_tls_verify=(
                        insecure_skip_tls_verify
                        or bool(cl.get("insecure-skip-tls-verify")))))
            except Exception as e:
                # a malformed kubeconfig (or an unloadable explicit CA)
                # drops this candidate — say why instead of leaving only
                # a generic "no reachable API server" downstream
                log.warning("kubeconfig %s unusable: %s", cfg_path, e)
        return candidates

    @classmethod
    def from_env(cls, kubeconfig: str | None = None,
                 apiserver: str | None = None,
                 insecure_skip_tls_verify: bool = False
                 ) -> "KubeClient | None":
        """In-cluster service account, explicit --apiserver, or kubeconfig;
        None when nothing is reachable. https endpoints are certificate-
        verified (CA file / in-cluster CA / system roots) unless
        `insecure_skip_tls_verify` opts out."""
        for c in cls._candidates_from_env(kubeconfig, apiserver,
                                          insecure_skip_tls_verify):
            try:
                c.request("GET", "/version", timeout=3.0, retries=0)
                return c
            except Exception as e:
                log.debug("api server %s unreachable: %s", c.base_url, e)
        return None

    # ------------------------------------------------------------ list/watch
    def list_all(self, path: str, limit: int = 500,
                 timeout: float = 30.0) -> dict:
        """Paginated LIST (limit + continue tokens): items merged, the final
        page's resourceVersion kept — large clusters must not be fetched as
        one giant response."""
        items: list[dict] = []
        cont = None
        while True:
            sep = "&" if "?" in path else "?"
            q = f"{path}{sep}limit={limit}"
            if cont:
                q += "&continue=" + urllib.parse.quote(cont)
            doc = self.request("GET", q, timeout=timeout)
            items.extend(doc.get("items", []))
            cont = doc.get("metadata", {}).get("continue")
            if not cont:
                doc["items"] = items
                return doc

    def watch(self, path: str, resource_version: str | None = None,
              timeout_s: float = 120.0):
        """Yield watch events ({"type": ..., "object": ...}) from a
        streaming GET. Returns normally when the server ends the stream
        (timeoutSeconds rotation — caller re-watches from its last seen
        resourceVersion); raises WatchExpired on 410 Gone."""
        if self._stream is None:
            raise RuntimeError("transport cannot stream; use poll resync")
        sep = "&" if "?" in path else "?"
        q = (f"{path}{sep}watch=true&allowWatchBookmarks=true"
             f"&timeoutSeconds={int(timeout_s)}")
        if resource_version is not None:
            q += f"&resourceVersion={urllib.parse.quote(str(resource_version))}"
        try:
            lines = self._stream("GET", q, timeout_s + 10.0)
            for line in lines:
                if not line.strip():
                    continue
                ev = json.loads(line)
                if ev.get("type") == "ERROR":
                    code = ev.get("object", {}).get("code")
                    if code == 410:
                        raise WatchExpired(path)
                    raise ApiError("WATCH", path, code or 0,
                                   json.dumps(ev.get("object", {})).encode())
                yield ev
        except ApiError as e:
            if e.status == 410:
                raise WatchExpired(path) from None
            raise

    # ----------------------------------------------------------------- verbs
    def list_metrics(self) -> list[TpuNodeMetrics]:
        doc = self.list_all(METRICS_PATH)
        return [TpuNodeMetrics.from_cr(item) for item in doc.get("items", [])]

    # Workload CRD (workload-tier admission, scheduler/workload.py)
    def list_workloads(self) -> list[dict]:
        from ..scheduler.workload import WORKLOADS_PATH

        return self.list_all(WORKLOADS_PATH).get("items", [])

    def create_workload(self, cr: dict) -> dict:
        from ..scheduler.workload import WORKLOADS_PATH

        return self.request("POST", WORKLOADS_PATH, cr)

    def delete_workload(self, namespace: str, name: str) -> None:
        from ..scheduler.workload import WORKLOAD_GROUP, WORKLOAD_VERSION

        self.request(
            "DELETE",
            f"/apis/{WORKLOAD_GROUP}/{WORKLOAD_VERSION}/namespaces/"
            f"{namespace}/workloads/{name}")

    def update_workload_status(self, namespace: str, name: str,
                               status: dict) -> None:
        """PUT the Workload /status subresource (the admission tier's
        condition write-back). Best-effort like post_event: a vanished
        CR (404) is not an error — the workload was deleted."""
        from ..scheduler.workload import WORKLOAD_GROUP, WORKLOAD_VERSION

        try:
            self.request(
                "PUT",
                f"/apis/{WORKLOAD_GROUP}/{WORKLOAD_VERSION}/namespaces/"
                f"{namespace}/workloads/{name}/status",
                {"status": status})
        except ApiError as e:
            if e.status != 404:
                raise

    def get_pod(self, namespace: str, name: str) -> dict | None:
        try:
            return self.request(
                "GET", f"/api/v1/namespaces/{namespace}/pods/{name}")
        except ApiError as e:
            if e.status == 404:
                return None
            raise

    def post_event(self, namespace: str, body: dict) -> None:
        """POST a core/v1 Event (FailedScheduling / Scheduled — the
        operator-facing trail kubectl describe pod shows). Best-effort
        observability: callers run it off the hot path and swallow
        failures; an event must never cost a bind."""
        self.request("POST", f"/api/v1/namespaces/{namespace}/events", body)

    def bind(self, pod: Pod, node: str,
             assigned_chips: list | None = None, fence=None) -> None:
        """POST the binding subresource. A 409 means the pod is already
        assigned — possibly by OUR earlier attempt whose response was lost
        (the retry path re-POSTs). Recover by reading the pod back: bound to
        our target = success; bound elsewhere = genuine conflict, raised.
        `fence` (a shard-lease fencing token, k8s/leaderelect.py) rides the
        Binding's annotations so the apiserver can reject a commit from a
        replica whose lease epoch went stale.

        An AMBIGUOUS wire failure (the connection died after the POST may
        have reached the server — surfaced by request() as ApiError(0)
        caused by AmbiguousRequestError) is resolved the same way: read the
        pod back. Bound to us = the POST landed (and the chip-assignment
        annotation landed WITH it — it rides the Binding's metadata, so a
        bind and its assignment publish atomically). Unbound = the POST
        provably never applied, so one replay is safe (a replay racing a
        still-in-flight original surfaces as 409 and converges through the
        409 recovery above)."""
        body = self._bind_body(pod, node, assigned_chips, fence)
        for replay in (False, True):
            try:
                self.request(
                    "POST",
                    f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}"
                    "/binding", body)
                break
            except ApiError as e:
                if self._bind_resolve(pod, node, body, e, replay):
                    break  # landed (our earlier POST / adopted replay)

    @staticmethod
    def _bind_body(pod: Pod, node: str, assigned_chips, fence) -> dict:
        body = {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": {"name": pod.name, "namespace": pod.namespace},
            "target": {"apiVersion": "v1", "kind": "Node", "name": node},
        }
        if assigned_chips:
            # ride the chip assignment on the Binding itself: the apiserver
            # merges Binding.metadata.annotations into the pod (upstream
            # assignPod semantics), saving the follow-up PATCH round-trip
            # (and its watch event) per bind — at serve scale the second
            # RPC was ~40% of the binder's critical path
            body["metadata"]["annotations"] = {
                ASSIGNED_CHIPS_LABEL: format_assigned_chips(assigned_chips)}
        if fence is not None:
            name, holder, epoch = fence
            body["metadata"].setdefault("annotations", {})[
                "yoda.tpu/fence"] = f"{name}/{holder}/{epoch}"
        return body

    def _bind_resolve(self, pod: Pod, node: str, body: dict,
                      e: ApiError, replayed: bool) -> bool:
        """Resolve a failed binding POST (the 409/ambiguous recovery
        protocol in `bind`'s docstring, shared with the pipelined wire).
        True = the bind is provably OURS on the server (treat as
        success); False = the POST provably never applied and one replay
        is permitted (only returned when `replayed` is False); raises
        on genuine conflicts/terminal failures."""
        ambiguous = (e.status == 0
                     and isinstance(e.__cause__, AmbiguousRequestError))
        # a webhook denial (400/403-coded) is a conflict verdict too:
        # resolve it through the same read-back protocol so the engine
        # sees the uniform 409 shape
        if e.status != 409 and not ambiguous and not is_webhook_denial(e):
            raise e
        # the confirm GET is the ONE read standing between an ambiguous
        # bind and a duplicate-bind window, so it gets extra storm
        # tolerance beyond get_pod's own retry budget: if it still
        # fails, the raise reaches the engine, whose bound_node_of
        # adoption resolves the pod once the watch cache catches up
        live = None
        for confirm_try in range(3):
            try:
                live = self.get_pod(pod.namespace, pod.name)
                break
            except ApiError as ge:
                # only WIRE-class failures (status 0) and server
                # brownouts are worth re-probing; a returned 4xx is
                # deterministic (e.g. RBAC) and re-sleeping on it would
                # stall the binder for nothing
                if confirm_try == 2 or ge.status not in (
                        0, 429, 500, 502, 503, 504):
                    raise
                time.sleep(self.retry_backoff_s * (2 ** confirm_try))
        bound_to = (live or {}).get("spec", {}).get("nodeName")
        if bound_to == node:
            # same node is NOT proof it was OUR bind: a foreign replica's
            # same-key win on the same node (fleet split-brain) also
            # reads nodeName == node. The chip annotation discriminates —
            # our own replay carried the identical assignment, a foreign
            # win carries theirs — and adopting a foreign assignment as
            # ours would overwrite the winner's chips in the cache and
            # double-book the physical chips they hold.
            want = body["metadata"].get("annotations", {}).get(
                ASSIGNED_CHIPS_LABEL)
            have = ((live or {}).get("metadata", {}).get(
                "annotations") or {}).get(ASSIGNED_CHIPS_LABEL)
            # absent `have` stays adoptable: every chip-claiming bind
            # attaches the annotation, so a foreign win shows up
            # present-and-different; absence just means a server/test
            # double that didn't echo annotations
            if want and have is not None and have != want:
                raise ApiError(
                    "POST", "binding(conflict)", 409,
                    f"pod bound to {bound_to!r} with a foreign "
                    f"chip assignment".encode()) from e
            log.info("bind %s -> %s: %s but already ours", pod.key,
                     node, "ambiguous" if ambiguous else "409")
            return True
        if bound_to or not ambiguous:
            # keep the authority's own reason (webhook denials carry the
            # conflicting chip/fence in the message) — the raw body, not
            # str(e), which truncates at 200
            reason = getattr(e, "body", b"") or str(e).encode()
            detail = (f"pod bound to {bound_to!r}".encode()
                      if bound_to else b"rejected: " + reason)
            raise ApiError("POST", "binding(conflict)", 409,
                           detail) from e
        if replayed:
            raise e  # unbound after a replayed POST: genuine failure
        log.info("bind %s -> %s: ambiguous failure, pod unbound; "
                 "replaying POST", pod.key, node)
        return False

    # -------------------------------------------------------- pipelined wire
    def _pipe_conn(self, timeout: float):
        """Dedicated per-thread pipelining connection: (socket, buffered
        reader). Separate from the ordinary pooled connection — pipelined
        traffic shares one persistent reader whose buffer must never be
        torn by http.client's one-request state machine."""
        import http.client

        pipe = getattr(self._tlocal, "pipe", None)
        if pipe is None:
            if urllib.request.getproxies().get(
                    urllib.parse.urlsplit(self.base_url).scheme):
                # pipelining through proxies is a compatibility minefield
                raise ConnectionError("pipelining unsupported via proxy")
            u = urllib.parse.urlsplit(self.base_url)
            port = u.port or (443 if u.scheme == "https" else 80)
            if u.scheme == "https":
                conn = http.client.HTTPSConnection(
                    u.hostname, port, timeout=timeout, context=self._ctx)
            else:
                conn = http.client.HTTPConnection(
                    u.hostname, port, timeout=timeout)
            conn.connect()
            import socket as _socket

            try:
                conn.sock.setsockopt(_socket.IPPROTO_TCP,
                                     _socket.TCP_NODELAY, 1)
            except OSError:
                pass
            pipe = (conn.sock, conn.sock.makefile("rb"))
            self._tlocal.pipe = pipe
        pipe[0].settimeout(timeout)
        return pipe

    def _drop_pipe(self) -> None:
        pipe = getattr(self._tlocal, "pipe", None)
        if pipe is not None:
            self._tlocal.pipe = None
            for part in pipe[::-1]:
                try:
                    part.close()
                except Exception:
                    pass

    def pipeline(self, reqs: list, timeout: float = 10.0) -> list:
        """True HTTP/1.1 pipelining: write every request back-to-back on
        one persistent connection, then read the responses in order.
        `reqs` is [(method, path, body | None), ...]; returns a
        position-aligned list of (status, raw_body) | ApiError. A
        transport failure marks the failed slot and every LATER one with
        an AmbiguousRequestError-caused ApiError(0) — those requests may
        or may not have been applied, exactly the ambiguity contract
        single-POST callers get — and callers own the per-item recovery.
        Never retries internally (a replayed non-idempotent request
        whose first copy landed surfaces as a spurious 409)."""
        import http.client

        sock, fp = self._pipe_conn(timeout)
        chunks = []
        host = urllib.parse.urlsplit(self.base_url).netloc
        for method, path, body in reqs:
            data = json.dumps(body).encode() if body is not None else b""
            lines = [f"{method} {self._base_path + path} HTTP/1.1",
                     f"Host: {host}", f"Content-Length: {len(data)}"]
            for k, v in self._headers(method, body).items():
                lines.append(f"{k}: {v}")
            chunks.append(("\r\n".join(lines) + "\r\n\r\n").encode()
                          + data)
        def _ambiguous(exc) -> ApiError:
            err = ApiError("PIPELINE", "(batch)", 0, str(exc).encode())
            err.__cause__ = AmbiguousRequestError(str(exc))
            return err

        try:
            sock.sendall(b"".join(chunks))
        except Exception as e:
            self._drop_pipe()
            return [_ambiguous(e)] * len(reqs)
        out: list = []
        reader = _PipeReader(fp)
        for i, (method, _path, _body) in enumerate(reqs):
            try:
                resp = http.client.HTTPResponse(reader, method=method)
                resp.begin()
                raw = resp.read()
                out.append((resp.status, raw))
                if resp.will_close:
                    # server ended the connection (Connection: close):
                    # later responses will never arrive
                    raise ConnectionError("server closed mid-pipeline")
            except Exception as e:
                self._drop_pipe()
                # keep every fully-received slot (a will_close response
                # was parsed before the raise); everything later is
                # ambiguous — it may or may not have been applied
                del out[i + 1:]
                while len(out) < len(reqs):
                    out.append(_ambiguous(e))
                break
        return out

    def bind_pipelined(self, items: list) -> list:
        """One pipelined wire round for a WINDOW of binds. `items` is
        [(pod, node, assigned_chips, fence), ...]; returns a position-
        aligned list of None (bound) | Exception (terminal failure),
        with every non-2xx/ambiguous slot resolved IN ORDER through the
        same 409/adopt read-back protocol the single-POST `bind` runs
        (_bind_resolve) — in-order conflict resolution, one replay for a
        provably-unapplied POST. Falls back to per-item `bind` when the
        transport cannot pipeline (proxied connections)."""
        reqs = []
        bodies = []
        for pod, node, chips, fence in items:
            body = self._bind_body(pod, node, chips, fence)
            bodies.append(body)
            reqs.append((
                "POST",
                f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}"
                "/binding", body))
        try:
            results = self.pipeline(reqs)
        except ConnectionError:
            results = None
        outcomes: list = []
        for i, (pod, node, chips, fence) in enumerate(items):
            if results is None:
                try:
                    self.bind(pod, node, chips, fence=fence)
                    outcomes.append(None)
                except Exception as e:
                    outcomes.append(e)
                continue
            res = results[i]
            try:
                if isinstance(res, Exception):
                    e = res
                else:
                    status, raw = res
                    if status < 300:
                        outcomes.append(None)
                        continue
                    if status in _RETRYABLE:
                        # transient brownout status (429/5xx): the
                        # server REJECTED this slot without applying it,
                        # so the ordinary single-POST path — and its
                        # bounded retry/backoff the raw pipeline write
                        # skips — owns the recovery, exactly as if the
                        # bind had never been pipelined
                        try:
                            self.bind(pod, node, chips, fence=fence)
                            outcomes.append(None)
                        except Exception as e2:
                            outcomes.append(e2)
                        continue
                    e = ApiError("POST", reqs[i][1], status, raw)
                if self._bind_resolve(pod, node, bodies[i], e, False):
                    outcomes.append(None)
                    continue
                # provably unapplied: the one permitted replay, as an
                # ordinary retried request (it also restores 429/5xx
                # retry coverage the raw pipeline write skips)
                try:
                    self.request("POST", reqs[i][1], bodies[i])
                    outcomes.append(None)
                except ApiError as e2:
                    outcomes.append(
                        None if self._bind_resolve(pod, node, bodies[i],
                                                   e2, True) else e2)
            except Exception as final:
                outcomes.append(final)
        return outcomes

    def evict(self, pod: Pod) -> None:
        try:
            self.request(
                "DELETE",
                f"/api/v1/namespaces/{pod.namespace}/pods/{pod.name}")
        except ApiError as e:
            if e.status != 404:  # already gone = evicted
                raise

    def iter_pods(self, limit: int = 500, timeout: float = 30.0):
        """Yield every non-terminal Pod, PAGE BY PAGE (limit + continue
        tokens) — the restart-reconciliation read. A generator, not a
        merged list: Scheduler.reconcile consumes it incrementally, so a
        50k-pod restart holds one page in memory, and a single-page read
        (the old shape) can never silently reconcile only the first 500
        pods of a large cluster."""
        cont = None
        while True:
            q = f"/api/v1/pods?limit={limit}"
            if cont:
                q += "&continue=" + urllib.parse.quote(cont)
            doc = self.request("GET", q, timeout=timeout)
            for item in doc.get("items", []):
                p = _pod_from_api(item)
                if p is not None:
                    yield p
            cont = doc.get("metadata", {}).get("continue")
            if not cont:
                return

    def list_bound_pods(self) -> dict[str, list[Pod]]:
        """Every pod holding a node — any phase except terminal. Filtering on
        phase=Running would make bound-but-ContainerCreating pods invisible
        for a resync window and their chips would be double-allocated."""
        doc = self.list_all("/api/v1/pods")
        by_node: dict[str, list[Pod]] = {}
        for item in doc.get("items", []):
            p = _pod_from_api(item)
            if p is not None and p.node:
                by_node.setdefault(p.node, []).append(p)
        return by_node

    def list_nodes(self) -> list[str]:
        doc = self.list_all("/api/v1/nodes")
        return [i["metadata"]["name"] for i in doc.get("items", [])]

    def create_node(self, name: str, labels: dict | None = None,
                    taints: list | None = None) -> dict:
        """POST a node object (the capacity provisioner's wire path —
        on a real cluster the cloud provider's node controller does
        this; against the fake apiserver the provisioner's WireBackend
        is the controller). The scheduler itself never consumes the
        response: the node comes back through the ordinary reflector
        watch like any other membership change."""
        obj: dict = {"apiVersion": "v1", "kind": "Node",
                     "metadata": {"name": name}}
        if labels:
            obj["metadata"]["labels"] = dict(labels)
        if taints:
            obj["spec"] = {"taints": list(taints)}
        return self.request("POST", "/api/v1/nodes", obj)

    def delete_node(self, name: str) -> None:
        """DELETE a node; 404 tolerated (already gone — releases are
        idempotent by construction)."""
        try:
            self.request("DELETE", f"/api/v1/nodes/{name}")
        except ApiError as e:
            if e.status != 404:
                raise

    def cordon_node(self, name: str, on: bool = True) -> dict:
        """PATCH spec.unschedulable — kubectl cordon/uncordon. The
        two-phase scale-down drain (capacity/provisioner.py) marks a
        release candidate unschedulable through this before waiting out
        its pods; the flag comes back through the reflector watch and
        the admission plugin (NodeUnschedulable) starts filtering the
        node fleet-wide, not just on the cordoning replica."""
        return self.request("PATCH", f"/api/v1/nodes/{name}",
                            {"spec": {"unschedulable": bool(on)}})


def _pod_from_api(item: dict) -> Pod | None:
    """API pod object -> Pod, or None for terminal phases. Chip assignment
    travels as an annotation on real clusters; surface it as the label the
    allocator reads."""
    phase = item.get("status", {}).get("phase", "Pending")
    if phase in ("Succeeded", "Failed"):
        return None
    p = Pod.from_manifest(item)
    ann = item.get("metadata", {}).get("annotations", {})
    if ASSIGNED_CHIPS_LABEL in ann:
        p.labels[ASSIGNED_CHIPS_LABEL] = ann[ASSIGNED_CHIPS_LABEL]
    if p.node:
        p.phase = PodPhase.BOUND
    return p


def _node_meta_from_api(item: dict) -> tuple[dict, tuple, tuple | None, bool]:
    """Node object -> (metadata.labels, spec.taints, status.allocatable as
    (cpu millicores, memory bytes) or None, spec.unschedulable) for the
    admission plugin (plugins/admission.py). Taints normalised to plain
    dicts; unschedulable is kubectl cordon's flag (upstream
    NodeUnschedulable — checked directly, not only via the auto-added
    node.kubernetes.io/unschedulable taint, which the node controller may
    lag on or omit)."""
    from ..utils.quantity import parse_cpu_millis, parse_memory_bytes

    spec = item.get("spec", {}) or {}
    labels = dict(item.get("metadata", {}).get("labels", {}) or {})
    taints = tuple(
        {
            "key": t.get("key", ""),
            "value": t.get("value", ""),
            "effect": t.get("effect", ""),
        }
        for t in spec.get("taints", []) or []
    )
    alloc_raw = (item.get("status") or {}).get("allocatable")
    alloc = None
    if isinstance(alloc_raw, dict):
        cpu = parse_cpu_millis(alloc_raw.get("cpu"))
        mem = parse_memory_bytes(alloc_raw.get("memory"))
        if cpu is not None or mem is not None:
            alloc = (cpu if cpu is not None else 1 << 60,
                     mem if mem is not None else 1 << 60)
    return labels, taints, alloc, bool(spec.get("unschedulable"))


def _rv_of(obj: dict) -> str | None:
    return obj.get("metadata", {}).get("resourceVersion")


class Reflector:
    """client-go reflector semantics: LIST once (paginated) to replace the
    cache, then WATCH from the list's resourceVersion applying incremental
    events; on 410 Gone re-list immediately; on transport errors reconnect
    with bounded backoff; a full re-list every `relist_s` as a safety net
    against missed events (informer periodic resync)."""

    def __init__(self, client: KubeClient, path: str, on_replace, on_event,
                 relist_s: float = 300.0, watch_timeout_s: float = 60.0,
                 backoff_s: float = 0.5, max_backoff_s: float = 15.0,
                 optional: bool = False, on_absent=None, metrics=None,
                 rng=None, selector: str | None = None) -> None:
        self.client = client
        self.path = path
        # server-side labelSelector (sharded reflectors): appended to
        # every LIST and WATCH so the apiserver filters at the source —
        # the replica's socket never carries foreign-pool objects.
        # set_selector() rotates it; the running watch loop picks the
        # change up at its next re-list (bounded by watch_timeout_s).
        self.selector = selector
        self.on_replace = on_replace
        self.on_event = on_event
        # storm observability (utils.obs.Metrics, optional): re-lists,
        # 410 expiries, and watch errors as counters — an apiserver storm
        # shows up as a counter slope instead of staying silent in logs
        self.metrics = metrics
        # jitter source for the error/410 backoffs: N reflector replicas
        # (multi-profile deployments, restarts after an outage) must not
        # re-list in lockstep the instant the server recovers — the
        # synchronized stampede is its own second outage. Injectable for
        # deterministic tests.
        self._rng = rng or random.Random()
        # on_absent(bool): notified when an optional resource transitions
        # between served and denied/missing, so the cache owner can expose
        # "absent" (unknown) rather than "empty" (known) — the two have
        # opposite semantics for negative selectors (DoesNotExist/NotIn)
        self.on_absent = on_absent
        self.relist_s = relist_s
        self.watch_timeout_s = watch_timeout_s
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.last_list_at = 0.0
        # per-phase ingest attribution (serve_scale bench): time blocked
        # on the watch stream (socket read + JSON decode, the generator
        # pull) vs time applying events to the cache. Plain int adds on
        # the reflector's own thread; readers tolerate torn reads.
        self.read_ns = 0
        self.apply_ns = 0
        self.events = 0
        # optional resources (namespaces without RBAC, API groups the
        # control plane lacks): a 403/404 LIST counts as synced-empty
        # instead of blocking wait_synced forever; retried on the relist
        # interval in case the resource appears later
        self.optional = optional
        self.absent = False

    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

    def _jittered(self, delay: float) -> float:
        """Spread a backoff wait over [0.5, 1.5)x, capped at
        max_backoff_s — decorrelates replicas without ever exceeding the
        configured ceiling."""
        return min(delay * (0.5 + self._rng.random()), self.max_backoff_s)

    def _sel_path(self) -> str:
        if not self.selector:
            return self.path
        sep = "&" if "?" in self.path else "?"
        return (f"{self.path}{sep}labelSelector="
                f"{urllib.parse.quote(self.selector)}")

    def set_selector(self, selector: str | None) -> None:
        """Rotate the server-side selector (shard-lease handover). The
        RUNNING watch keeps its old selector until its round ends (up to
        watch_timeout_s) — promptness comes from the caller's synchronous
        list_once() (set_owned_pools), which installs the new ownership's
        objects immediately; zeroing the deadline here covers callers
        that skip that list (the next loop turn re-lists)."""
        self.selector = selector
        self.last_list_at = 0.0

    def list_once(self) -> str | None:
        self._inc("reflector_relists_total")
        try:
            doc = self.client.list_all(self._sel_path())
        except ApiError as e:
            if self.optional and e.status in (403, 404):
                # denied/missing optional resource: do NOT install an empty
                # map — "no data" must stay distinguishable from "zero
                # objects" (an empty namespace map makes every
                # DoesNotExist selector match every namespace)
                self.last_list_at = time.monotonic()
                if not self.absent:
                    self.absent = True
                    if self.on_absent is not None:
                        self.on_absent(True)
                return None
            raise
        if self.absent:
            self.absent = False
            if self.on_absent is not None:
                self.on_absent(False)
        self.on_replace(doc.get("items", []))
        self.last_list_at = time.monotonic()
        return _rv_of(doc)

    def run(self, stop: threading.Event) -> None:
        backoff = self.backoff_s
        expired_streak = 0  # consecutive 410s since the last clean watch
        while not stop.is_set():
            try:
                rv = self.list_once()
                backoff = self.backoff_s
                if self.absent:
                    # optional resource the server doesn't serve: don't
                    # hammer it with doomed watches — re-probe at the
                    # relist cadence in case it appears later
                    stop.wait(self.relist_s)
                    continue
                while not stop.is_set():
                    if time.monotonic() - self.last_list_at > self.relist_s:
                        break  # periodic full resync
                    got_any = False
                    relist_due = False
                    t_mark = time.perf_counter_ns()
                    for ev in self.client.watch(
                            self._sel_path(), rv,
                            timeout_s=self.watch_timeout_s):
                        t_now = time.perf_counter_ns()
                        self.read_ns += t_now - t_mark
                        self.events += 1
                        got_any = True
                        obj = ev.get("object", {})
                        new_rv = _rv_of(obj)
                        if new_rv is not None:
                            rv = new_rv
                        if ev.get("type") == "BOOKMARK":
                            # rv already advanced above: the re-watch
                            # after rotation resumes from the bookmark
                            # instead of an event rv that compaction may
                            # have outrun (410 -> full re-list)
                            self._inc("reflector_bookmarks_total")
                            t_mark = time.perf_counter_ns()
                            continue
                        self.on_event(ev.get("type", ""), obj)
                        t_mark = time.perf_counter_ns()
                        self.apply_ns += t_mark - t_now
                        # a stream that always yields within its rotation
                        # must not defer the safety-net re-list forever:
                        # check the deadline per event, not per stream
                        if (time.monotonic() - self.last_list_at
                                > self.relist_s):
                            relist_due = True
                            break
                    expired_streak = 0  # full watch round without a 410
                    if relist_due or stop.is_set():
                        break
                    if not got_any:
                        # stream closed without events: normal rotation;
                        # tiny pause avoids hot-spinning a broken server
                        stop.wait(0.05)
            except WatchExpired:
                # re-list, but back off on a persistent 410 pathology so a
                # misbehaving server doesn't eat back-to-back full LISTs
                # (client-go rate-limits this path the same way); jittered
                # so restarted replicas don't re-list in lockstep
                self._inc("reflector_watch_expired_total")
                expired_streak += 1
                log.info("watch %s expired (410): re-listing", self.path)
                if expired_streak > 1:
                    stop.wait(self._jittered(
                        self.backoff_s * (2 ** min(expired_streak - 2, 32))))
                continue
            except Exception as e:
                if stop.is_set():
                    return  # shutdown closed our stream: not an error
                self._inc("reflector_watch_errors_total")
                log.warning("watch %s failed: %s; retrying in ~%.1fs",
                            self.path, e, backoff)
                stop.wait(self._jittered(backoff))
                backoff = min(backoff * 2, self.max_backoff_s)


class KubeCluster:
    """Cluster interface (scheduler/cluster.py contract) over a KubeClient:
    an informer-style watch cache over nodes, pods, and TpuNodeMetrics CRs.

    Watch mode (streaming transport): three Reflector threads feed the
    cache incrementally — scheduling decisions read memory, the API server
    sees O(changes) traffic, and staleness is bounded by event latency
    rather than a poll interval. Poll mode (non-streaming fakes): periodic
    full re-lists every `resync_s`.
    """

    def __init__(self, client: KubeClient, telemetry: TelemetryStore,
                 resync_s: float = 2.0, watch: bool | None = None,
                 relist_s: float = 300.0, metrics: Metrics | None = None,
                 bind_pipeline_window: int = 0,
                 owned_pools: "set[str] | None" = None,
                 pool_label: str | None = None) -> None:
        self.client = client
        self.telemetry = telemetry
        # windowed bind-wire pipelining (bindPipelineWindow knob): binder
        # workers drain up to this many queued binds per pass onto one
        # persistent connection (KubeClient.bind_pipelined), and the
        # event poster batches its POSTs the same way. 0 = the classic
        # one-POST-per-worker wire.
        self.bind_pipeline_window = max(int(bind_pipeline_window), 0)
        # sharded reflection (reflectorSharding): this replica ingests
        # only nodes of its OWNED pools (columnar.pool_of naming). Used
        # by SEPARATE-PROCESS fleet replicas, which construct their own
        # KubeCluster with their shard's pools (the in-process fleet
        # shares one watch cache and shards behind it via
        # fleet.ShardedOwnedView instead — see ARCHITECTURE.md). Nodes
        # filter both server-side — `pool_label` names the node label
        # carrying the pool, pushed as a labelSelector on the node
        # reflector's list/watch — and client-side (the guard that also
        # covers pods bound to foreign nodes and foreign TpuNodeMetrics,
        # which field selectors cannot express; pending pods always pass:
        # intake must see them). set_owned_pools hands watch ownership
        # over with the shard lease. None = full-cluster ingest.
        self._owned_pools = (set(owned_pools) if owned_pools is not None
                             else None)
        self._pool_label = pool_label
        # ingest observability shared by the reflectors: relists/410s/
        # watch errors land here so apiserver storms are visible as
        # counter slopes (ingest_stats surfaces them)
        self.metrics = metrics or Metrics()
        self.resync_s = resync_s
        self.watch_mode = client.can_stream if watch is None else watch
        self._lock = threading.RLock()
        self._nodes: set[str] = set()
        self._node_meta: dict[str, tuple] = {}  # name -> (labels, taints, allocatable, unschedulable)
        self._pdbs: tuple = ()                   # DisruptionBudget models
        self._namespaces: dict[str, dict] = {}   # ns -> metadata.labels
        # namespace source state: until the first successful LIST, and
        # whenever the LIST is denied (403/404), the namespace map is
        # ABSENT — namespace_labels_map() returns None so Snapshot
        # resolves namespaceSelectors conservatively (match nothing),
        # never "every namespace is known labelless"
        self._ns_synced = False
        self._ns_absent = False
        self._pods: dict[str, Pod] = {}          # key -> non-terminal pod
        self._by_node: dict[str, dict[str, Pod]] = {}  # node -> key -> pod
        self._pods_ver: dict[str, int] = {}      # node -> change counter
        # global change log + membership version for incremental snapshots
        # (same contract as FakeCluster/TelemetryStore)
        self._changes = ChangeLog()
        self._nodes_ver = 0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._reflectors: list[Reflector] = []
        # cluster-event subscribers (scheduler engines): the reflector
        # threads publish one framework.ClusterEvent per watch-cache
        # mutation, feeding the queues' event-driven requeue. Callbacks
        # run OUTSIDE self._lock, on whichever thread applied the change
        # (list append/iteration are GIL-atomic — same contract as
        # FakeCluster.subscribe)
        self._subscribers: list = []
        # serve-path attribution (ingest_stats): GC pause accounting via
        # gc callbacks (a collection stops EVERY thread — engine, binder
        # pool, reflectors — so its pauses explain ingest/bind tail
        # latency no per-phase timer can), and binder wire time
        self._gc_pauses = 0
        self._gc_pause_ns = 0
        self._gc_t0 = 0
        self._gc_cb_installed = False
        self.bind_wire_ns = 0
        self.bind_wire_n = 0
        # wire-side lifecycle spans (bind_wire RTT on the binder threads,
        # watch_confirm = bind dispatch -> watch-cache confirmation),
        # merged into /traces/export next to the engines' rings. The wire
        # path runs on real time, so spans here stamp time.time() — the
        # same timebase a real-clock engine's spans use. trace_sampling
        # mirrors the engine knob; _serve syncs it from the profile.
        self.spans = SpanRing(pid=1000)
        self.trace_sampling = 8
        # pod key -> wall time the bind was dispatched, consumed by the
        # confirming watch event (bounded; stale keys evict oldest)
        self._confirm_t0: dict[str, float] = {}
        # async binder state (see bind_async)
        self._bind_q: deque = deque()
        self._bind_event = threading.Event()
        self._bind_threads: list[threading.Thread] | None = None
        self._bind_inflight = 0
        # event-poster state (see post_event): one daemon thread drains
        # the bounded queue; producers (engine + binder threads) append
        # under self._lock
        self._event_q: deque = deque()
        self._event_event = threading.Event()
        self._event_thread: threading.Thread | None = None
        self._event_seen: dict = {}  # (pod key, reason) -> message
        self.events_posted = 0
        self.events_dropped = 0
        if self.watch_mode:
            self._reflectors = [
                Reflector(client, "/api/v1/nodes",
                          self._replace_nodes, self._node_event,
                          relist_s=relist_s, metrics=self.metrics,
                          selector=self._pool_selector()),
                Reflector(client, "/api/v1/pods",
                          self._replace_pods, self._pod_event,
                          relist_s=relist_s, metrics=self.metrics),
                Reflector(client, METRICS_PATH,
                          self._replace_metrics, self._metrics_event,
                          relist_s=relist_s, metrics=self.metrics),
                Reflector(client, PDB_PATH,
                          self._replace_pdbs, self._pdb_event,
                          relist_s=relist_s, metrics=self.metrics),
                Reflector(client, "/api/v1/namespaces",
                          self._replace_namespaces, self._namespace_event,
                          relist_s=relist_s, optional=True,
                          on_absent=self._namespace_absent,
                          metrics=self.metrics),
            ]

    # ------------------------------------------------------------ pod events
    def post_event(self, pod: Pod, reason: str, message: str,
                   type_: str = "Normal") -> None:
        """Queue a core/v1 Event for this pod (engine thread,
        non-blocking): FailedScheduling with the unschedulable reason the
        cycle trace carries, Scheduled on bind — what `kubectl describe
        pod` surfaces to the operator. A dedicated daemon thread POSTs;
        repeats of the same (pod, reason, message) are deduplicated
        client-side (the apiserver would aggregate them anyway, and an
        unschedulable pod retries for minutes), and a full queue drops
        the event (counted) rather than stall scheduling."""
        # uid in the key: a deleted-and-recreated pod (same name, new
        # incarnation — the serve loop schedules it afresh) must get its
        # own event trail even when the verdict text repeats
        key = (pod.key, pod.k8s_uid, reason)
        with self._lock:
            # callers include binder threads (_async_bind_succeeded), not
            # just the engine — the seen-map, queue cap, counters, and
            # thread creation all need the cluster lock
            if self._event_seen.get(key) == message:
                return  # same verdict as last time: no new information
            if len(self._event_q) >= 1024:
                # dropped events are NOT recorded as seen: the pod's next
                # identical verdict gets another chance once the queue
                # drains
                self.events_dropped += 1
                return
            self._event_seen[key] = message
            while len(self._event_seen) > 4096:
                self._event_seen.pop(next(iter(self._event_seen)))
            self._event_q.append((key, pod.namespace, pod.name,
                                  pod.k8s_uid, reason, message, type_))
            if self._event_thread is None:
                self._event_thread = threading.Thread(
                    target=self._event_loop, daemon=True, name="eventer")
                self._event_thread.start()
        self._event_event.set()

    def _event_loop(self) -> None:
        seq = 0
        while not self._stop.is_set():
            self._event_event.wait(timeout=0.5)
            self._event_event.clear()
            # re-read per wake: the knob may land after this thread spawns
            window = max(self.bind_pipeline_window, 1)
            while True:
                drained = []
                while len(drained) < max(window, 1):
                    try:
                        drained.append(self._event_q.popleft())
                    except IndexError:
                        break
                if not drained:
                    break
                reqs = []
                keys = []
                for key, ns, name, uid, reason, message, type_ in drained:
                    seq += 1
                    body = {
                        "apiVersion": "v1", "kind": "Event",
                        "metadata": {
                            "name": f"{name}.{seq:x}.{id(self):x}",
                            "namespace": ns},
                        "involvedObject": {"kind": "Pod", "name": name,
                                           "namespace": ns, "uid": uid},
                        "reason": reason, "message": message[:1024],
                        "type": type_, "count": 1,
                        "source": {"component": "yoda-tpu-scheduler"},
                    }
                    keys.append(key)
                    reqs.append((f"/api/v1/namespaces/{ns}/events", body))
                results = None
                if window > 1 and len(reqs) > 1:
                    # batched Event posting: the whole drain rides one
                    # pipelined wire round instead of a round-trip per
                    # event (events are best-effort, so an ambiguous
                    # slot just counts as dropped and un-records its
                    # dedup verdict)
                    try:
                        results = self.client.pipeline(
                            [("POST", path, body)
                             for path, body in reqs])
                    except Exception:
                        results = None
                for i, (path, body) in enumerate(reqs):
                    try:
                        if results is not None:
                            res = results[i]
                            if isinstance(res, Exception):
                                raise res
                            status, raw = res
                            if status >= 300:
                                raise ApiError("POST", path, status, raw)
                        else:
                            self.client.post_event(
                                body["metadata"]["namespace"], body)
                        with self._lock:
                            self.events_posted += 1
                    except Exception:
                        # best-effort: an apiserver brownout must not
                        # spin this thread hot or back-pressure the
                        # engine — but un-record the verdict so the
                        # pod's NEXT identical retry re-posts instead of
                        # being deduplicated against an event that never
                        # landed
                        with self._lock:
                            self.events_dropped += 1
                            self._event_seen.pop(keys[i], None)

    # ------------------------------------------------------ sharded reflection
    def _pool_selector(self) -> str | None:
        """Server-side labelSelector for the node reflector, when a pool
        label is configured: `<label> in (p1,p2,...)`."""
        if self._owned_pools is None or not self._pool_label:
            return None
        pools = ",".join(sorted(self._owned_pools)) or "__none__"
        return f"{self._pool_label} in ({pools})"

    def _pool_ok(self, node: str | None) -> bool:
        """Does this node belong to an owned pool? (True when sharding
        is off or the name is unknown/None.)"""
        if self._owned_pools is None or node is None:
            return True
        return pool_of(node) in self._owned_pools

    def set_owned_pools(self, pools: "set[str]") -> None:
        """Shard-lease handover: replace the owned pool set. Foreign
        nodes/pods/metrics are purged from the cache NOW (their shard's
        new owner serves them); newly-owned pools arrive with the forced
        re-list the selector rotation triggers (bounded by the watch
        rotation). Bumps the membership version so engine memos rebuild."""
        self._owned_pools = set(pools)
        with self._lock:
            gone = [n for n in self._nodes
                    if pool_of(n) not in self._owned_pools]
            for n in gone:
                self._nodes.discard(n)
                self._node_meta.pop(n, None)
                self._bump(n)
                for key in list(self._by_node.get(n, {})):
                    self._pods.pop(key, None)
                self._by_node.pop(n, None)
            self._nodes_ver += 1
        for n in gone:
            self.telemetry.delete(n)
        sel = self._pool_selector()
        for r in self._reflectors:
            if r.path == "/api/v1/nodes":
                r.set_selector(sel)
            elif r.path in ("/api/v1/pods", METRICS_PATH):
                r.last_list_at = 0.0  # client-side filtered: just re-list
            else:
                continue
            # prompt handover: one synchronous LIST installs the new
            # ownership's objects NOW instead of waiting out the current
            # watch rotation (the reflector thread's own forced re-list
            # then resumes watching from the fresh resourceVersion; a
            # concurrent event apply interleaves exactly like the
            # periodic resync always has). Best-effort — a brownout here
            # just leaves the handover to the rotation.
            try:
                r.list_once()
            except Exception:
                pass

    # --------------------------------------------------------- cluster events
    def subscribe(self, cb) -> None:
        """Register a cluster-event callback (cb(ClusterEvent)). Callbacks
        must be cheap and thread-safe — they run on the reflector/binder
        thread that applied the mutation, never under self._lock."""
        self._subscribers.append(cb)

    def _publish(self, events) -> None:
        if not events or not self._subscribers:
            return
        for cb in list(self._subscribers):
            for ev in events:
                cb(ev)

    # ----------------------------------------------------- watch-cache apply
    def _bump(self, node: str | None) -> None:
        if node:
            self._pods_ver[node] = self._pods_ver.get(node, 0) + 1
            self._changes.record(node)

    @property
    def nodes_version(self) -> int:
        return self._nodes_ver

    @property
    def pods_global_version(self) -> int:
        return self._changes.version

    def changes_since(self, version: int) -> tuple[int, set[str] | None]:
        """(current version, nodes whose pod set changed after `version`);
        None when the log was trimmed past it (full rebuild)."""
        with self._lock:
            return self._changes.changes_since(version)

    def _replace_nodes(self, items: list[dict]) -> None:
        if self._owned_pools is not None:
            items = [i for i in items
                     if self._pool_ok(i["metadata"]["name"])]
        names = {i["metadata"]["name"] for i in items}
        metas = {i["metadata"]["name"]: _node_meta_from_api(i) for i in items}
        events: list[ClusterEvent] = []
        with self._lock:
            if names != self._nodes:
                self._nodes_ver += 1
                for n in names ^ self._nodes:
                    self._bump(n)
                events.extend(ClusterEvent(NODE_ADDED, node=n)
                              for n in names - self._nodes)
            # a label/taint edit must invalidate the node's cached NodeInfo
            # and filter verdicts even though membership is unchanged
            for n, meta in metas.items():
                if self._node_meta.get(n, ({}, (), None, False)) != meta:
                    self._bump(n)
                    if n in self._nodes:
                        events.append(ClusterEvent(NODE_SPEC_CHANGED, node=n))
            self._nodes = names
            self._node_meta = metas
        self._publish(events)

    def _node_event(self, typ: str, obj: dict) -> None:
        name = obj.get("metadata", {}).get("name")
        if not name or not self._pool_ok(name):
            return
        events: list[ClusterEvent] = []
        with self._lock:
            if typ == "DELETED":
                if name in self._nodes:
                    self._nodes_ver += 1
                self._nodes.discard(name)
                self._node_meta.pop(name, None)
                self._bump(name)
            else:
                fresh = name not in self._nodes
                if fresh:
                    self._nodes_ver += 1
                    self._bump(name)
                    events.append(ClusterEvent(NODE_ADDED, node=name))
                self._nodes.add(name)
                meta = _node_meta_from_api(obj)
                if self._node_meta.get(name, ({}, (), None, False)) != meta:
                    self._node_meta[name] = meta
                    self._bump(name)
                    if not fresh:
                        events.append(
                            ClusterEvent(NODE_SPEC_CHANGED, node=name))
        self._publish(events)

    def _set_pod(self, key: str, p: Pod) -> None:
        """Install/replace a pod record, maintaining the node index and
        per-node versions. Caller holds the lock."""
        old = self._pods.get(key)
        self._pods[key] = p
        if old is not None and old.node and old.node != p.node:
            self._by_node.get(old.node, {}).pop(key, None)
            self._bump(old.node)
        if p.node:
            self._by_node.setdefault(p.node, {})[key] = p
        self._bump(p.node)

    def _drop_pod(self, key: str) -> None:
        old = self._pods.pop(key, None)
        if old is not None:
            if old.node:
                self._by_node.get(old.node, {}).pop(key, None)
            self._bump(old.node)

    def _replace_pods(self, items: list[dict]) -> None:
        fresh: dict[str, Pod] = {}
        for item in items:
            p = _pod_from_api(item)
            if p is not None and (p.node is None or self._pool_ok(p.node)):
                # sharded reflection: pods bound to foreign pools are the
                # bulk of the cache at scale and none of this replica's
                # business; PENDING pods always pass (intake needs them)
                fresh[p.key] = p
        events: list[ClusterEvent] = []
        with self._lock:
            # same guard as _pod_event: a relist snapshot served just before
            # our own bind landed must not resurrect the pod as unbound (its
            # chips would look free until the bind's watch event arrives)
            for key, old in self._pods.items():
                new = fresh.get(key)
                if new is not None and _stale_event(old, new):
                    fresh[key] = old
            # relist diff -> requeue events: bound pods that vanished freed
            # capacity, pods that appeared bound consumed it
            for key, old in self._pods.items():
                if old.node:
                    new = fresh.get(key)
                    if new is None or new.node != old.node:
                        events.append(ClusterEvent(
                            POD_DELETED, node=old.node,
                            gang=old.labels.get("tpu/gang-name")))
            for key, p in fresh.items():
                if p.node:
                    old = self._pods.get(key)
                    if old is None or old.node != p.node:
                        events.append(ClusterEvent(POD_BOUND, node=p.node))
            touched = {p.node for p in self._pods.values() if p.node}
            touched |= {p.node for p in fresh.values() if p.node}
            self._pods = fresh
            self._by_node = {}
            for key, p in fresh.items():
                if p.node:
                    self._by_node.setdefault(p.node, {})[key] = p
            for n in touched:
                self._bump(n)
        self._publish(events)

    def _pod_event(self, typ: str, obj: dict) -> None:
        meta = obj.get("metadata", {})
        key = f"{meta.get('namespace', 'default')}/{meta.get('name')}"
        events: list[ClusterEvent] = []
        with self._lock:
            old = self._pods.get(key)
            p = None if typ == "DELETED" else _pod_from_api(obj)
            if (p is not None and p.node is not None
                    and not self._pool_ok(p.node)):
                # bound into a foreign pool (another replica's win): out
                # of our view — drop any cached incarnation silently (its
                # departure frees nothing we own, so no capacity event)
                self._drop_pod(key)
                p = None
                old = None
            if p is None:  # deleted, or went terminal: drop from cache
                self._drop_pod(key)
                if old is not None and old.node:
                    # a bound pod left: its chips/ports/cpu are free — the
                    # capacity event parked pods wake on. The gang label
                    # rides along for the elastic controller's orphaned-
                    # growing-record retirement.
                    events.append(ClusterEvent(
                        POD_DELETED, node=old.node,
                        gang=old.labels.get("tpu/gang-name")))
            # events can arrive out of order with our own write-through bind
            # (we update the cache at bind time, the ADDED/MODIFIED event for
            # the pre-bind pod may still be in flight); keep the newer.
            elif old is None or not _stale_event(old, p):
                self._set_pod(key, p)
                if p.node:
                    # watch_confirm: the apiserver's own event now shows
                    # the bind we dispatched — close the span opened at
                    # dispatch (write-through set node immediately, so the
                    # POD_BOUND condition below never fires for our own
                    # binds; the confirm stamp is how dispatch->confirmed
                    # latency stays measurable)
                    t0 = self._confirm_t0.pop(key, None)
                    if t0 is not None:
                        nowt = time.time()
                        self.metrics.observe("watch_confirm_ms",
                                             (nowt - t0) * 1e3)
                        if span_sampled(key, self.trace_sampling):
                            self.spans.record("watch_confirm", key, t0,
                                              nowt, {"node": p.node})
                if p.node and (old is None or old.node != p.node):
                    events.append(ClusterEvent(POD_BOUND, node=p.node))
                elif old is None and not p.node:
                    # fresh pending pod: wake the serve loop's intake now
                    # instead of letting the arrival sit out a poll tick
                    events.append(ClusterEvent(POD_PENDING_ARRIVED))
        self._publish(events)

    def _apply_metrics(self, metrics: list[TpuNodeMetrics]) -> None:
        """Install a full metrics listing, pruning vanished nodes — shared
        by the watch path's replace and poll-mode resync so the two modes
        can't diverge on staleness behaviour."""
        seen = set()
        for m in metrics:
            if not self._pool_ok(m.node):
                continue
            seen.add(m.node)
            self.telemetry.put(m)
        for node in set(self.telemetry.nodes()) - seen:
            self.telemetry.delete(node)

    def _replace_pdbs(self, items: list[dict]) -> None:
        from ..utils.pdb import DisruptionBudget

        budgets = tuple(DisruptionBudget.from_manifest(i) for i in items)
        with self._lock:
            # set comparison: a relist returns API order while the event
            # path appends — same content must not bump the version
            if frozenset(budgets) != frozenset(self._pdbs):
                # allowance changes can unblock pods whose preemption had
                # no non-violating plan: invalidate via membership version
                # (same vector the unschedulable memo keys on)
                self._nodes_ver += 1
            self._pdbs = budgets

    def _pdb_event(self, typ: str, obj: dict) -> None:
        from ..utils.pdb import DisruptionBudget

        b = DisruptionBudget.from_manifest(obj)
        with self._lock:
            rest = tuple(p for p in self._pdbs
                         if (p.namespace, p.name) != (b.namespace, b.name))
            budgets = rest if typ == "DELETED" else rest + (b,)
            if frozenset(budgets) != frozenset(self._pdbs):
                self._nodes_ver += 1
            self._pdbs = budgets

    def disruption_budgets(self) -> tuple:
        with self._lock:
            return self._pdbs

    def _replace_namespaces(self, items: list[dict]) -> None:
        fresh = {
            i.get("metadata", {}).get("name", ""): dict(
                i.get("metadata", {}).get("labels") or {})
            for i in items if i.get("metadata", {}).get("name")
        }
        with self._lock:
            if fresh != self._namespaces or not self._ns_synced:
                # namespaceSelector verdicts can change anywhere:
                # invalidate via the membership version (like PDBs)
                self._nodes_ver += 1
            self._namespaces = fresh
            self._ns_synced = True

    def _namespace_absent(self, absent: bool) -> None:
        with self._lock:
            if self._ns_absent != absent:
                self._ns_absent = absent
                self._nodes_ver += 1  # selector verdicts flip cluster-wide

    def _namespace_event(self, typ: str, obj: dict) -> None:
        name = obj.get("metadata", {}).get("name")
        if not name:
            return
        labels = dict(obj.get("metadata", {}).get("labels") or {})
        with self._lock:
            if typ == "DELETED":
                if self._namespaces.pop(name, None) is not None:
                    self._nodes_ver += 1
            elif self._namespaces.get(name) != labels:
                self._namespaces[name] = labels
                self._nodes_ver += 1

    def namespace_labels_map(self) -> dict[str, dict] | None:
        """ns -> metadata.labels; None while the namespace LIST is denied
        or has never synced. None makes Snapshot._namespaces None, so
        namespaceSelectors match nothing (the documented conservative
        fallback) instead of treating every namespace as known-labelless,
        which would invert DoesNotExist/NotIn semantics."""
        with self._lock:
            if self._ns_absent or not self._ns_synced:
                return None
            return dict(self._namespaces)

    def _replace_metrics(self, items: list[dict]) -> None:
        self._apply_metrics([TpuNodeMetrics.from_cr(i) for i in items])

    def _metrics_event(self, typ: str, obj: dict) -> None:
        m = TpuNodeMetrics.from_cr(obj)
        if not self._pool_ok(m.node):
            return
        if typ == "DELETED":
            self.telemetry.delete(m.node)
        else:
            self.telemetry.put(m)

    # ------------------------------------------------------------ lifecycle
    def resync(self) -> None:
        """One full re-list of everything (poll mode / initial seed)."""
        node_doc = self.client.list_all("/api/v1/nodes")
        pod_doc = self.client.list_all("/api/v1/pods")
        metrics = self.client.list_metrics()
        # same replace path as the watch reflector: names + labels/taints,
        # with change-counter bumps on meta edits
        self._replace_nodes(node_doc.get("items", []))
        self._replace_pods(pod_doc.get("items", []))
        self._apply_metrics(metrics)
        try:
            pdb_doc = self.client.list_all(PDB_PATH)
        except ApiError:
            pdb_doc = {}  # control planes without the policy API group
        self._replace_pdbs(pdb_doc.get("items", []))
        try:
            ns_doc = self.client.list_all("/api/v1/namespaces")
        except ApiError as e:
            # RBAC without namespace list (403/404): mark the source
            # absent so selectors resolve conservatively (match nothing)
            # — never install an empty "known" map. A TRANSIENT error
            # (429/5xx brownout) keeps the last-good map instead, same
            # as the watch-mode Reflector.
            if e.status in (403, 404):
                self._namespace_absent(True)
        else:
            self._namespace_absent(False)
            self._replace_namespaces(ns_doc.get("items", []))

    def _gc_cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter_ns()
        elif self._gc_t0:
            self._gc_pauses += 1
            self._gc_pause_ns += time.perf_counter_ns() - self._gc_t0
            self._gc_t0 = 0

    def ingest_stats(self) -> dict:
        """Per-phase serve-path attribution: watch-stream read (socket +
        JSON decode) vs cache apply per reflector, binder wire time, and
        GC pauses — the data that explains a watch-ingest or binds/s gap
        between hosts (serve_scale bench emits this)."""
        import gc as _gc

        out: dict = {"reflectors": {}}
        for r in self._reflectors:
            out["reflectors"][r.path] = {
                "events": r.events,
                "read_ms": round(r.read_ns / 1e6, 2),
                "apply_ms": round(r.apply_ns / 1e6, 2),
            }
        out["bind_wire_ms"] = round(self.bind_wire_ns / 1e6, 2)
        out["bind_wire_n"] = self.bind_wire_n
        bw = self.metrics.histograms.get("bind_wire_ms")
        if bw is not None and bw.n:
            out["bind_wire_p50_ms"] = round(bw.quantile(0.5), 2)
            out["bind_wire_p99_ms"] = round(bw.quantile(0.99), 2)
        wc = self.metrics.histograms.get("watch_confirm_ms")
        if wc is not None and wc.n:
            out["watch_confirm_p50_ms"] = round(wc.quantile(0.5), 2)
            out["watch_confirm_p99_ms"] = round(wc.quantile(0.99), 2)
        # reflector storm counters (relists / 410 expiries / watch
        # errors): a brownout that only logged before now reads as a
        # slope an operator (and the serve bench) can see
        out["reflector_relists"] = self.metrics.counters.get(
            "reflector_relists_total", 0)
        out["reflector_watch_expired"] = self.metrics.counters.get(
            "reflector_watch_expired_total", 0)
        out["reflector_watch_errors"] = self.metrics.counters.get(
            "reflector_watch_errors_total", 0)
        out["gc_pauses"] = self._gc_pauses
        out["gc_pause_ms"] = round(self._gc_pause_ns / 1e6, 2)
        out["gc_enabled"] = _gc.isenabled()
        return out

    def start(self) -> None:
        import gc as _gc

        if not self._gc_cb_installed:
            self._gc_cb_installed = True
            _gc.callbacks.append(self._gc_cb)
        if self.watch_mode:
            # seeding is asynchronous (each reflector's first LIST runs on
            # its own thread); callers that need a populated cache block on
            # wait_synced()
            for r in self._reflectors:
                t = threading.Thread(target=r.run, args=(self._stop,),
                                     daemon=True,
                                     name=f"reflector:{r.path}")
                self._threads.append(t)
                t.start()
            return
        self.resync()

        def loop():
            while not self._stop.wait(self.resync_s):
                try:
                    self.resync()
                except Exception as e:
                    log.warning("resync failed: %s", e)

        t = threading.Thread(target=loop, daemon=True)
        self._threads.append(t)
        t.start()

    def wait_synced(self, timeout_s: float = 10.0) -> bool:
        """Block until the watch cache has completed its initial lists
        (controller-runtime WaitForCacheSync analogue)."""
        if not self.watch_mode:
            return True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(r.last_list_at > 0 for r in self._reflectors):
                return True
            if self._stop.wait(0.02):
                return False
        return False

    def stop(self) -> None:
        if self._gc_cb_installed:
            import gc as _gc

            self._gc_cb_installed = False
            try:
                _gc.callbacks.remove(self._gc_cb)
            except ValueError:
                pass
        # drain in-flight binds before tearing the transport down: a
        # dispatched bind the server never saw would strand its pod
        # Pending until its backoff retry or the next scheduler instance
        self.flush_binds(timeout=5.0)
        self._stop.set()
        self._bind_event.set()  # wake parked binder workers so they exit
        self._event_event.set()  # and the (daemon) event poster
        # unblock reflectors parked in readline() so they observe the stop
        # event now rather than at their socket timeout
        close = getattr(self.client, "close_streams", None)
        if close is not None:
            close()
        for t in self._threads + (self._bind_threads or []):
            t.join(timeout=2.0)

    # ---------------------------------------------------- cluster interface
    def node_names(self) -> list[str]:
        with self._lock:
            return sorted(self._nodes)

    def node_meta(self, name: str) -> tuple[dict[str, str], tuple]:
        """Node-object (metadata.labels, spec.taints) for the admission
        plugin; empty for unknown nodes."""
        with self._lock:
            return self._node_meta.get(name, ({}, (), None, False))[:2]

    def node_allocatable(self, name: str) -> tuple | None:
        """status.allocatable as (cpu millicores, memory bytes), or None
        when the node reports none (no cpu/mem constraint)."""
        with self._lock:
            meta = self._node_meta.get(name)
            return meta[2] if meta is not None else None

    def node_unschedulable(self, name: str) -> bool:
        """Node spec.unschedulable (kubectl cordon)."""
        with self._lock:
            meta = self._node_meta.get(name)
            return bool(meta[3]) if meta is not None else False

    def cordon_node(self, name: str, on: bool = True) -> None:
        """Cordon/uncordon through the API (capacity provisioner's
        two-phase scale-down). The PATCH's effect comes back through the
        node reflector like any other spec change — the local meta cache
        is NOT updated here, so the admission plugin flips exactly when
        the watch confirms, the same settle discipline as binds."""
        self.client.cordon_node(name, on)

    def pods_version(self, node: str) -> int:
        with self._lock:
            return self._pods_ver.get(node, 0)

    def pods_on(self, node: str) -> list[Pod]:
        # node-keyed index: snapshot() asks for every node every cycle, so
        # this must not scan the whole pod cache per node
        with self._lock:
            return list(self._by_node.get(node, {}).values())

    def pending_pods(self) -> list[Pod]:
        """Unbound, non-terminal, non-terminating pods from the watch cache
        — the serve loop's intake, replacing a per-poll LIST to the API
        server."""
        with self._lock:
            return [p for p in self._pods.values()
                    if p.node is None and not p.terminating]

    def pod_bound(self, key: str) -> bool:
        """Live check: does the cache hold `key` with a node assigned?
        (The serve loop's watch-confirmed-bind cleanup reads this per
        key instead of a snapshot so it can't race the binder rollback.)"""
        with self._lock:
            p = self._pods.get(key)
            return p is not None and p.node is not None

    def bound_node_of(self, key: str) -> str | None:
        """Node the cache holds `key` bound to, or None — the engine's
        ambiguous-bind adoption / restart reconciliation read (same
        contract as FakeCluster.bound_node_of). Cache truth here: by the
        time the engine asks (bind-failure drain, reconcile), the binder
        rollback or the confirming watch event has already settled the
        entry either way."""
        with self._lock:
            p = self._pods.get(key)
            return p.node if p is not None else None

    def known_pod_keys(self) -> set[str]:
        """Every pod key in the cache (any phase) — the serve loop checks
        tracked pods against this to notice external deletions."""
        with self._lock:
            return set(self._pods)

    def doomed_pod_keys(self) -> set[str]:
        """Keys of pods in graceful termination. A tracked (queued) pod
        that turns terminating was deleted externally mid-queue: the serve
        loop must forget it BEFORE the final DELETED event, or the engine
        binds a deleting pod from its stale queued object."""
        with self._lock:
            return {k for k, p in self._pods.items() if p.terminating}

    def _stamp_confirm(self, key: str) -> None:
        """Open the watch_confirm window for a dispatched bind (caller
        holds the lock). Bounded: keys whose confirming event never lands
        (rolled-back binds) evict oldest-first."""
        self._confirm_t0[key] = time.time()
        while len(self._confirm_t0) > 4096:
            self._confirm_t0.pop(next(iter(self._confirm_t0)))

    def bind(self, pod: Pod, node: str, assigned_chips=None,
             fence=None) -> None:
        self.client.bind(pod, node, assigned_chips, fence=fence)
        pod.node = node
        pod.phase = PodPhase.BOUND
        if assigned_chips:
            pod.labels[ASSIGNED_CHIPS_LABEL] = format_assigned_chips(assigned_chips)
        with self._lock:
            # write-through so the next cycle sees the bind without waiting
            # for the watch event (which will confirm it)
            self._set_pod(pod.key, pod)
            self._stamp_confirm(pod.key)

    # --------------------------------------------------------- async binding
    # Upstream kube-scheduler's model: the scheduling cycle is serial, the
    # bind RPC runs in its own goroutine — the engine moves to the next pod
    # while this one's POST is in flight. The cache is updated OPTIMISTICALLY
    # (the next cycle must see the chips claimed); a terminal wire failure
    # rolls the entry back (uid-guarded) and reports through on_fail, whose
    # owner (the engine) requeues the pod — the same recovery path a
    # post-Permit bind failure takes upstream.
    # sized for a GIL-bound process: past ~8 the workers contend with the
    # engine + reflector threads instead of overlapping wire waits
    # (measured on the serve_scale bench: 4 -> 8 cut dispatch->server
    # latency ~25%, 16 bought little more)
    _BIND_WORKERS = 8

    def bind_async(self, pod: Pod, node: str, assigned_chips=None,
                   on_fail=None, on_success=None, fence=None) -> None:
        pod.node = node
        pod.phase = PodPhase.BOUND
        if assigned_chips:
            pod.labels[ASSIGNED_CHIPS_LABEL] = format_assigned_chips(
                assigned_chips)
        with self._lock:
            self._set_pod(pod.key, pod)
            self._stamp_confirm(pod.key)
            if self._bind_threads is None:
                self._bind_threads = []
                for i in range(self._BIND_WORKERS):
                    t = threading.Thread(target=self._bind_loop, daemon=True,
                                         name=f"binder-{i}")
                    self._bind_threads.append(t)
                    t.start()
            self._bind_q.append((pod, node, assigned_chips, on_fail,
                                 on_success, fence))
            self._bind_inflight += 1
        self._bind_event.set()

    def _bind_loop(self) -> None:
        while True:
            self._bind_event.wait()
            # window re-read per drain round: the knob may be installed
            # after the worker threads started (the serve path sets it
            # from the profile config; a bind dispatched before that
            # must not freeze window=1 for the process lifetime)
            window = max(self.bind_pipeline_window, 1)
            while True:
                batch = []
                with self._lock:
                    while self._bind_q and len(batch) < window:
                        batch.append(self._bind_q.popleft())
                    if not batch:
                        if not self._stop.is_set():
                            # leave the event set during shutdown so every
                            # parked worker wakes and exits
                            self._bind_event.clear()
                        break
                if len(batch) > 1:
                    # windowed pipelining: one wire round for the whole
                    # batch, responses (and their 409/ambiguous recovery)
                    # resolved in order by KubeClient.bind_pipelined
                    t0 = time.perf_counter_ns()
                    w0 = time.time()
                    try:
                        outs = self.client.bind_pipelined(
                            [(p, n, c, f)
                             for p, n, c, _of, _os, f in batch])
                    except Exception as e:  # defensive: fail the window
                        outs = [e] * len(batch)
                    # wire attribution: the window shares one RTT —
                    # attribute the mean per bind (the aggregate
                    # bind_wire_ns stays exact)
                    per_ns = (time.perf_counter_ns() - t0) // len(batch)
                    for item, err in zip(batch, outs):
                        self._settle_bind(item, err, per_ns, w0)
                else:
                    item = batch[0]
                    pod, node, chips, _on_fail, _on_success, fence = item
                    t0 = time.perf_counter_ns()
                    w0 = time.time()
                    try:
                        self.client.bind(pod, node, chips, fence=fence)
                        err = None
                    except Exception as e:
                        err = e
                    self._settle_bind(item, err,
                                      time.perf_counter_ns() - t0, w0)
            if self._stop.is_set():
                return

    def _settle_bind(self, item, err, dt_ns: int, w0: float) -> None:
        """Post-wire bookkeeping for one dispatched bind — identical for
        the single-POST and pipelined paths: success metrics/spans and
        on_success, or the in-place optimistic-cache rollback and
        on_fail."""
        pod, node, chips, on_fail, on_success, fence = item
        try:
            if err is None:
                self.bind_wire_ns += dt_ns
                self.bind_wire_n += 1
                # per-bind wire attribution: RTT histogram + labeled
                # outcome counter + a bind_wire span for sampled pods
                # (the async twin of the engine's sync-path wire span)
                self.metrics.observe("bind_wire_ms", dt_ns / 1e6)
                self.metrics.inc("bind_wire_total",
                                 labels={"outcome": "ok"})
                if span_sampled(pod.key, self.trace_sampling):
                    self.spans.record("bind_wire", pod.key, w0,
                                      w0 + dt_ns / 1e9, {"node": node})
                if on_success is not None:
                    try:
                        on_success(pod, node)
                    except Exception:
                        log.exception("bind on_success handler failed")
                return
            e = err
            self.metrics.inc(
                "bind_wire_total",
                labels={"outcome": "conflict"
                        if getattr(e, "status", None) == 409
                        else "error"})
            # roll the optimistic entry back IN PLACE to Pending (the
            # cache object is the same one the serve loop's intake reads
            # — dropping it would hide the pod until the next relist):
            # chips read free again, intake sees it again. IDENTITY
            # guard: only the exact object bind_async installed is
            # reverted — if the watch already replaced it (a fresh bound
            # entry = the bind actually landed and this failure was the
            # lost response; or a new incarnation), the cache is
            # authoritative and nothing is rolled back or requeued (the
            # serve loop's watch-confirmed cleanup releases any stale
            # queue entry).
            rolled_back = False
            with self._lock:
                cur = self._pods.get(pod.key)
                if cur is pod and cur.node == node:
                    self._by_node.get(node, {}).pop(pod.key, None)
                    cur.node = None
                    cur.phase = PodPhase.PENDING
                    cur.labels.pop(ASSIGNED_CHIPS_LABEL, None)
                    self._bump(node)
                    # the bind never landed: a later rebind's
                    # watch_confirm must not measure from THIS dispatch
                    self._confirm_t0.pop(pod.key, None)
                    rolled_back = True
            log.warning("async bind %s -> %s failed: %s%s",
                        pod.key, node, e,
                        "" if rolled_back
                        else " (cache superseded; no rollback)")
            if rolled_back and on_fail is not None:
                try:
                    on_fail(pod, node, e)
                except Exception:
                    log.exception("bind on_fail handler failed")
        finally:
            with self._lock:
                self._bind_inflight -= 1

    def flush_binds(self, timeout: float = 10.0) -> bool:
        """Wait for dispatched binds to reach the server (shutdown,
        tests). Returns False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._bind_inflight == 0:
                    return True
            time.sleep(0.005)
        return False

    def evict(self, pod: Pod) -> None:
        self.client.evict(pod)
        # Write-through: mark this incarnation terminating rather than
        # dropping it. A real DELETE starts GRACEFUL termination — the pod
        # keeps running (and holding its chips) for up to
        # terminationGracePeriodSeconds, and its next MODIFIED event (now
        # carrying deletionTimestamp) would resurrect a dropped entry
        # anyway. Capacity frees when the DELETED event lands; meanwhile
        # the terminating flag blocks re-scheduling/re-eviction and keeps
        # a preemptor's nomination hold alive while its victims drain.
        pod.terminating = True
        with self._lock:
            cur = self._pods.get(pod.key)
            # uid guard: if the watch thread already applied DELETED(old) +
            # ADDED(new incarnation) before we got here, the cache entry is
            # a DIFFERENT pod that must not inherit the terminating mark
            # (_stale_event would then pin it terminating forever)
            if cur is not None and cur.k8s_uid == pod.k8s_uid:
                cur.terminating = True
                self._bump(cur.node)


def _stale_event(old: Pod, new: Pod) -> bool:
    """True when the incoming event is older than what we hold: our
    write-through bound (or terminating) version beats an in-flight
    pre-bind (or pre-delete) event for the same incarnation."""
    if old.k8s_uid != new.k8s_uid:
        return False
    if old.node is not None and new.node is None:
        return True
    return old.terminating and not new.terminating


class WorkloadFeed:
    """Workload CRD intake + status write-back for the serve loop
    (workloadAdmission knob): a Reflector on the workloads path feeds
    CR adds into the scheduler's admission tier (O(1) parked per CR —
    pods materialize only on admission), CR deletions withdraw, and the
    tier's condition changes flow back as /status PUTs from a dedicated
    writer thread (latest-wins per workload, bounded queue, never
    back-pressures the engine — the post_event discipline).

    On a WIRE backend the scheduler is also the workload's CONTROLLER:
    an admitted workload's pods must exist on the apiserver before any
    binding subresource POST can land, so materialization routes
    through `wire_materializer` — pod manifests (ownerReference'd to
    the Workload) POST from a dedicated creator thread and flow back
    through the ordinary pod watch into the scheduling queue, exactly
    like a Job controller's pods would. A withdraw deletes the
    UNBOUND members server-side (bound ones stay bound, the gang
    semantics).

    The workloads resource is OPTIONAL: a cluster without the CRD
    installed serves the classic pod-at-a-time intake untouched."""

    _QUEUE_CAP = 4096

    def __init__(self, client: KubeClient, sched, metrics=None) -> None:
        from ..scheduler.workload import WORKLOADS_PATH

        self.client = client
        self.sched = sched
        self.metrics = metrics
        self._seen: set[str] = set()  # keys handed to the scheduler
        self._status: dict[str, dict] = {}  # key -> latest status doc
        self._status_order: deque = deque()
        self._status_evt = threading.Event()
        # guards _status/_status_order consistency between the engine
        # thread's push and the writer thread's pop: a check-then-act
        # interleave could otherwise strand a key in _status with no
        # order entry, silencing that workload's write-back forever
        self._status_lock = threading.Lock()
        # pod create/delete work for the wire-materializer thread:
        # ("create", manifest) | ("delete", (namespace, name))
        self._pods_q: deque = deque()
        self._pods_evt = threading.Event()
        self._threads: list[threading.Thread] = []
        self.reflector = Reflector(client, WORKLOADS_PATH,
                                   self._replace, self._event,
                                   optional=True, metrics=metrics)

    # ----------------------------------------------------------- intake side
    def _submit(self, w) -> bool:
        target = getattr(self.sched, "submit_workload", None)
        if target is not None:
            return target(w)
        for e in self.sched.engines.values():  # multi-profile routing
            if e.submit_workload(w):
                return True
        return False

    def _withdraw(self, key: str, obj: dict | None = None) -> None:
        target = getattr(self.sched, "withdraw_workload", None)
        if target is not None:
            target(key, "workload CR deleted")
        else:
            for e in self.sched.engines.values():
                e.withdraw_workload(key, "workload CR deleted")
        # wire controller duty: the CR's pods were OURS to create, so
        # they are ours to clean up — unbound members delete, bound
        # ones stay (the creator thread checks bindings). When the
        # deletion was only observed as a re-list ABSENCE (no CR body),
        # the engines' resolved record still knows the shape.
        w = None
        if obj is not None:
            try:
                from ..scheduler.workload import Workload

                w = Workload.from_cr(obj)
            except (ValueError, KeyError):
                w = None
        if w is None:
            wl_of = getattr(self.sched, "workload_of", None)
            if wl_of is not None:
                w = wl_of(key)
            else:
                for e in getattr(self.sched, "engines", {}).values():
                    wa = e.workloads
                    w = wa.get(key) if wa is not None else None
                    if w is not None:
                        break
        if w is None:
            return
        # only an ADMITTED workload ever had pods created — a parked/
        # rejected one's delete fan-out would be members x replicas
        # useless get_pod round-trips against the apiserver. Prefer the
        # engine's live record for the state (the CR body may carry a
        # stale status snapshot).
        state = w.state
        wl_of = getattr(self.sched, "workload_of", None)
        live = (wl_of(key) if wl_of is not None else None)
        if live is None:
            for e in getattr(self.sched, "engines", {}).values():
                wa = e.workloads
                live = wa.get(key) if wa is not None else None
                if live is not None:
                    break
        if live is not None:
            state = live.state
        from ..scheduler.workload import ADMITTED, WITHDRAWN

        if state not in (ADMITTED, WITHDRAWN):
            return
        for pk in w.member_keys()[1]:
            ns, name = pk.split("/", 1)
            self._pods_q.append(("delete", (ns, name)))
        self._pods_evt.set()

    def _apply(self, typ: str, obj: dict) -> None:
        from ..scheduler.workload import Workload

        if typ == "DELETED":
            key = (f"{obj.get('metadata', {}).get('namespace', 'default')}"
                   f"/{obj.get('metadata', {}).get('name', '')}")
            if key in self._seen:
                self._seen.discard(key)
                self._withdraw(key, obj)
            return
        try:
            w = Workload.from_cr(obj)
        except (ValueError, KeyError) as e:
            log.warning("ignoring malformed Workload CR: %s", e)
            return
        if w.key in self._seen:
            return  # spec is immutable once parked; status echoes skip
        if self._submit(w):
            self._seen.add(w.key)

    def _replace(self, items: list) -> None:
        live = set()
        for item in items:
            md = item.get("metadata", {})
            live.add(f"{md.get('namespace', 'default')}/{md.get('name')}")
            self._apply("ADDED", item)
        for key in list(self._seen - live):
            # vanished between watches (compaction window): withdraw
            self._seen.discard(key)
            self._withdraw(key)

    def _event(self, typ: str, obj: dict) -> None:
        self._apply(typ, obj)

    # ------------------------------------------------- wire materialization
    def wire_materializer(self, pod: Pod) -> bool:
        """WorkloadAdmission.submit_pod on wire backends: engine-thread,
        never blocks. The pod manifest queues for the creator thread;
        the apiserver's watch then delivers it into the ordinary pod
        intake — the scheduler plays Job-controller for its own
        workloads, and the bind path stays untouched."""
        # no cap: dropping a create would leave an Admitted workload
        # permanently short of members with nothing to retry it. The
        # queue is bounded upstream by admission itself — only
        # capacity's worth of demand is ever admitted-but-unbound, so
        # the backlog here can never exceed the cluster's chip count
        # worth of small manifests.
        self._pods_q.append(("create", {
            "metadata": {
                "name": pod.name, "namespace": pod.namespace,
                "labels": dict(pod.labels),
                "ownerReferences": [{"kind": "Workload",
                                     "name": getattr(
                                         pod, "_workload_name", pod.name),
                                     "controller": True}],
            },
            "spec": {"schedulerName": pod.scheduler_name},
            "status": {"phase": "Pending"},
        }))
        self._pods_evt.set()
        return True

    def _pods_loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            if not self._pods_q:
                self._pods_evt.wait(timeout=0.2)
                self._pods_evt.clear()
                continue
            try:
                op, payload = self._pods_q.popleft()
            except IndexError:
                continue
            try:
                if op == "create":
                    try:
                        self.client.request("POST", "/api/v1/pods",
                                            payload)
                    except ApiError as e:
                        if e.status != 409:  # exists: idempotent re-admit
                            raise
                else:
                    ns, name = payload
                    cur = self.client.get_pod(ns, name)
                    if cur is None or cur.get("spec", {}).get("nodeName"):
                        continue  # gone, or bound: stays bound
                    # check-then-delete: a bind landing in this window
                    # still gets deleted — acceptable by construction,
                    # because on a real cluster the Workload CR's
                    # deletion garbage-collects ALL ownerReference'd
                    # member pods (bound included); the unbound check
                    # above is a best-effort courtesy, not a guarantee
                    self.client.request(
                        "DELETE",
                        f"/api/v1/namespaces/{ns}/pods/{name}")
            except Exception as e:
                log.warning("workload pod %s failed: %s", op, e)
                if self.metrics is not None:
                    self.metrics.inc("workload_pod_create_errors_total")

    # ----------------------------------------------------- status write-back
    def push_status(self, w) -> None:
        """WorkloadAdmission.status_sink: engine-thread, never blocks.
        Latest-wins per workload; past the cap the oldest un-written
        status is dropped (conditions are observability, not
        correctness)."""
        key = w.key
        doc = {"namespace": w.namespace, "name": w.name,
               "status": w.status()}
        with self._status_lock:
            fresh = key not in self._status
            if fresh and len(self._status_order) >= self._QUEUE_CAP:
                # latest wins: make room by dropping the OLDEST queued
                # write-back, never the fresh terminal state arriving
                old_key = self._status_order.popleft()
                self._status.pop(old_key, None)
                if self.metrics is not None:
                    self.metrics.inc("workload_status_dropped_total")
            self._status[key] = doc
            if fresh:
                self._status_order.append(key)
        self._status_evt.set()

    def _status_loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            if not self._status_order:
                self._status_evt.wait(timeout=0.2)
                self._status_evt.clear()
                continue
            with self._status_lock:
                try:
                    key = self._status_order.popleft()
                except IndexError:
                    continue
                doc = self._status.pop(key, None)
            if doc is None:
                continue
            try:
                self.client.update_workload_status(
                    doc["namespace"], doc["name"], doc["status"])
            except Exception as e:
                log.warning("workload status write-back failed for %s: %s",
                            key, e)
                if self.metrics is not None:
                    self.metrics.inc("workload_status_errors_total")

    def start(self, stop: threading.Event) -> None:
        for name, target in (("workload-reflector",
                              lambda: self.reflector.run(stop)),
                             ("workload-status",
                              lambda: self._status_loop(stop)),
                             ("workload-pods",
                              lambda: self._pods_loop(stop))):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)


def run_scheduler_against_cluster(client: KubeClient, profiles,
                                  metrics_port: int | None = 10251,
                                  leader_elect: bool = False,
                                  poll_s: float = 1.0,
                                  stop_event: threading.Event | None = None,
                                  proc_incarnation: int = 0) -> int:
    """The serve loop: leader-elect (optional), watch pending pods for
    EVERY configured profile, run scheduling cycles, bind through the API
    server. `profiles` is a list of (SchedulerConfig, enablement) pairs
    (cli.load_profiles)."""
    stop = stop_event or threading.Event()
    if leader_elect:
        from .leaderelect import LeaderElector

        elector = LeaderElector(client)
        elector.run_until_leader(stop)
        if stop.is_set():
            return 0

    telemetry = TelemetryStore()
    cluster = KubeCluster(client, telemetry)
    cluster.start()
    try:
        return _serve(client, cluster, profiles, metrics_port, poll_s, stop,
                      proc_incarnation=proc_incarnation)
    finally:
        cluster.stop()  # join reflector threads; no orphaned watchers


def _serve(client: KubeClient, cluster: KubeCluster, profiles,
           metrics_port, poll_s: float, stop: threading.Event,
           out: dict | None = None, proc_incarnation: int = 0) -> int:
    from ..scheduler.multi import MultiProfileScheduler

    cluster.wait_synced()
    # windowed bind pipelining (bindPipelineWindow): installed BEFORE
    # any scheduler exists — the binder/eventer threads also re-read it
    # per drain round, but nothing should ever dispatch against the
    # constructor default when a profile configured otherwise
    cluster.bind_pipeline_window = max(
        getattr(profiles[0][0], "bind_pipeline_window", 0), 0)
    cfg0 = profiles[0][0]
    # fleet_proc_index >= 0 is the opt-in (ProcessFleet always sets it;
    # a 1-process fleet still runs the slot architecture so the scaling
    # curve's procs=1 leg measures the same code it scales)
    proc_slot = (len(profiles) == 1 and cfg0.fleet_processes >= 1
                 and cfg0.fleet_proc_index >= 0)
    if proc_slot:
        # process fleet (fleetProcesses): THIS process serves exactly one
        # replica slot of an N-process fleet — FleetCoordinator keeps the
        # fleet-wide shard/lease/identity math while building only slot
        # fleet_proc_index. Intake below additionally partitions by
        # accepts(), so sibling processes never race for the same pod
        # (and the authority's 409 is the backstop if they ever do).
        from ..scheduler.fleet import FleetCoordinator

        sched = FleetCoordinator(cluster, cfg0, enabled=profiles[0][1],
                                 replicas=cfg0.fleet_processes,
                                 proc_index=cfg0.fleet_proc_index,
                                 proc_incarnation=proc_incarnation)
        sched.start(stop)
        log.info("process-fleet slot %d/%d serving (incarnation %d)",
                 cfg0.fleet_proc_index, cfg0.fleet_processes,
                 proc_incarnation)
    elif len(profiles) == 1 and cfg0.fleet_replicas > 1:
        # scheduler fleet: N engine replicas over the ONE shared watch
        # cache, each on its own thread, committing binds optimistically
        # (scheduler/fleet.py). Multi-profile configs keep the classic
        # co-hosted engines — a fleet is per-schedulerName.
        from ..scheduler.fleet import FleetCoordinator

        sched = FleetCoordinator(cluster, cfg0, enabled=profiles[0][1])
        sched.start(stop)
        log.info("scheduler fleet: %d replicas (%s mode)",
                 sched.n, sched.mode)
    else:
        sched = MultiProfileScheduler(cluster, profiles)
    if out is not None:
        # harnesses (bench.run_serve_scale) read engine metrics —
        # batched_binds_total et al. — after the drain
        out["sched"] = sched

    # the wire ring samples at the same rate the engines do, so a sampled
    # pod's tree is complete: queued/cycle (engine) + bind_wire/
    # watch_confirm (binder + reflector threads)
    cluster.trace_sampling = profiles[0][0].trace_sampling

    # workload-tier admission (scheduler/workload.py): a reflector on
    # the Workload CRD feeds the admission tier and the tier's condition
    # changes PUT back to /status — only when the knob asked for the
    # tier at all (engines without it refuse submissions)
    if any(e.workloads is not None for e in sched.engines.values()):
        wl_feed = WorkloadFeed(client, sched,
                               metrics=next(iter(
                                   sched.engines.values())).metrics)
        for e in sched.engines.values():
            if e.workloads is not None:
                e.workloads.status_sink = wl_feed.push_status
                # wire backend: admitted pods must EXIST on the
                # apiserver before any binding POST can land — the
                # materializer POSTs them and the pod watch delivers
                # them back through the ordinary intake (the scheduler
                # is the workload's controller; WorkloadFeed docstring)
                e.workloads.submit_pod = wl_feed.wire_materializer
        wl_feed.start(stop)
        log.info("workload admission tier serving (CRD list/watch + "
                 "pod materialization over the wire)")

    # restart reconciliation against CLUSTER truth, over the PAGINATED
    # pod read (iter_pods follows continue tokens): bound pods are
    # adopted as-is, pods stranded mid-bind by the previous incarnation
    # (stale chip annotation, no binding) are scrubbed and requeued now
    # instead of waiting out the intake's pending-only view
    recon = getattr(sched, "reconcile", None)
    if recon is not None:
        try:
            adopted, requeued = recon(client.iter_pods())
            if adopted or requeued:
                log.info("startup reconcile: adopted %d bound pods, "
                         "requeued %d stranded ones", adopted, requeued)
        except Exception as e:
            # best-effort: the watch intake still schedules everything
            # pending; reconcile only accelerates crash recovery
            log.warning("startup reconcile failed: %s", e)

    if metrics_port is not None:
        from ..utils.httpserv import serve

        serve(sched.metrics, sched.traces, host="0.0.0.0", port=metrics_port,
              spans=sched.spans, flight=sched.flight)

    # periodic defragmentation per profile that opts in
    # (descheduleIntervalSeconds > 0)
    from ..scheduler.deschedule import Descheduler

    if getattr(sched, "threaded", False):
        # fleet replicas run their cycles on their OWN threads: a
        # serve-thread descheduler would read live allocator/filter state
        # mid-mutation (and N per-replica copies would N-fold the
        # eviction pressure). Fleet-safe defragmentation exists now —
        # the ENGINE-thread DefragController (defragIntervalSeconds,
        # scheduler/elastic/defrag.py) runs inside each replica's cycle
        # loop gated on shard-0 ownership — so point operators at it.
        deschedulers = []
        if any(e.config.deschedule_interval_s > 0
               for e in sched.engines.values()):
            log.warning("descheduleIntervalSeconds is ignored with "
                        "fleetReplicas > 1 (the serve-thread pass is "
                        "not fleet-safe); use defragIntervalSeconds — "
                        "the engine-thread defrag controller is fleet-"
                        "aware (shard-0 owner only)")
    else:
        # an engine running the defrag controller owns migration for its
        # profile: a serve-thread pass beside it would keep a SECOND
        # cooldown book, so one pod could be moved twice per window
        if any(e.config.deschedule_interval_s > 0
               and e.config.defrag_interval_s > 0
               for e in sched.engines.values()):
            log.warning("descheduleIntervalSeconds is ignored where "
                        "defragIntervalSeconds is set (the engine-thread "
                        "defrag controller supersedes the serve-thread "
                        "pass; two passes would not share a cooldown "
                        "book)")
        deschedulers = [
            (Descheduler(e), e.config.deschedule_interval_s, [0.0])
            for e in sched.engines.values()
            if e.config.deschedule_interval_s > 0
            and e.config.defrag_interval_s <= 0
        ]

    # pod.key -> k8s uid of the incarnation we handled. A deleted pod
    # recreated under the same name arrives with a new uid and must be
    # scheduled afresh; entries for vanished pods are pruned every poll.
    seen: dict[str, str] = {}
    log.info("scheduler profiles %s serving against %s",
             list(sched.engines), client.base_url)
    # process-fleet intake partition: only pods that hash to THIS slot
    # (FleetCoordinator.accepts; identity-true for every other mode)
    accepts = getattr(sched, "accepts", None) or (lambda p: True)
    while not stop.is_set():
        try:
            pending = [p for p in cluster.pending_pods()
                       if sched.claims(p.scheduler_name) and accepts(p)]
            pending_keys = {p.key for p in pending}
            for pod in pending:
                if sched.tracks(pod.key):
                    seen[pod.key] = pod.k8s_uid
                    continue
                if seen.get(pod.key) == pod.k8s_uid:
                    # this incarnation was already handled (bound moments ago
                    # and the listing is stale, or permanently failed)
                    continue
                for e in sched.engines.values():
                    e.failed.pop(pod.key, None)  # new incarnation resets
                seen[pod.key] = pod.k8s_uid
                sched.submit(pod)
            known = cluster.known_pod_keys()
            doomed = cluster.doomed_pod_keys()
            for key in list(seen):
                if key not in pending_keys and not sched.tracks(key):
                    seen.pop(key, None)
                    for e in sched.engines.values():
                        e.failed.pop(key, None)
                elif (key not in known or key in doomed) and sched.tracks(key):
                    # the incarnation we handled vanished (external DELETE
                    # while queued/parked at Permit) or entered graceful
                    # termination: release its queue entry, reservation,
                    # and nomination hold — otherwise the hold subtracts
                    # capacity forever, or the engine binds a deleting pod
                    # from its stale queued object
                    sched.forget(key)
                    seen.pop(key, None)
                elif sched.tracks(key) and cluster.pod_bound(key):
                    # tracked but the cluster already shows it BOUND: an
                    # ambiguously-failed async bind actually landed (the
                    # response was lost, the watch confirmed the bind).
                    # Without this, the requeued entry re-binds into a
                    # permanent 409 loop. Ordering matters: tracks() is
                    # read BEFORE the live bound check — a binder-thread
                    # rollback flips the entry to Pending before it
                    # requeues, so a pod that reads tracked-then-bound
                    # here is genuinely bound, never a mid-rollback
                    # snapshot (a stale pending_keys set would race that).
                    sched.forget(key)
            for d, interval, last in deschedulers:
                now = time.time()
                if now - last[0] >= interval:
                    last[0] = now
                    plan = d.run_once()
                    if plan:
                        log.info("descheduled %d pods: %s",
                                 len(plan.victims), plan.reasons)
            # run every engine each pass (a generator inside any() would
            # short-circuit and starve later profiles behind a busy first);
            # isolate failures so one profile's persistent exception can't
            # starve its co-hosted profiles of cycles. Drain up to 64
            # cycles per intake pass: the intake bookkeeping above is
            # O(pending), so one-cycle-per-pass made a 1000-pod burst
            # O(pending^2) — new arrivals wait at most one batch, well
            # under the poll interval they'd wait anyway. Each run_one is
            # itself a BATCH cycle when the queue head has same-class
            # company (core.schedule_batch): wire-paced arrivals of one
            # equivalence class coalesce into a shared pass whenever the
            # intake let the queue deepen, reported as batched_binds_total
            idle = False
            if getattr(sched, "threaded", False):
                # fleet replicas run their own cycle threads; this loop
                # is intake-only and always sleeps on the wake event
                idle = True
            else:
                for _ in range(64):
                    outcomes = []
                    for name, e in sched.engines.items():
                        try:
                            outcomes.append(e.run_one())
                        except Exception as exc:
                            log.error("profile %s cycle error: %s", name, exc)
                            # None = "no progress": a persistently-throwing
                            # profile must not defeat the all-idle poll_s
                            # wait below, or the loop hot-spins re-listing
                            # the API server
                            outcomes.append(None)
                    if all(o is None for o in outcomes):
                        idle = True
                        break
                    if stop.is_set():
                        break
            if idle:
                # sleep until a cluster event / submission wakes an engine
                # (event-driven requeue sets sched.wake) — poll_s is now
                # only the intake fallback cadence, not the latency floor
                wake = getattr(sched, "wake", None)
                if wake is not None:
                    if wake.wait(poll_s):
                        wake.clear()
                else:
                    stop.wait(poll_s)
        except Exception as e:
            log.error("cycle error: %s", e)
            stop.wait(poll_s)
    return 0
