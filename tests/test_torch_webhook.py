"""The port's bind-authority webhook (yoda_scheduler_tpu_torch/k8s/webhook.py)
on GPU nodes, on the CPU.

First the port's BindAuthority against the JAX package's: one feed of pods
and TpuNodeMetrics CRs (two 8-card H100 SXM5 nodes, their CRs made by the
port's NVML sniffer over the fake NVML library of test_torch_telemetry.py,
so a card holds 81,559 MB), one lease table, and the same AdmissionReviews
through each package's own authority: every response (allowed, status code,
reason and message) must be equal, and so must the flight recorder's flips
and the counters each case reads. Then the port alone: its WebhookServer
over HTTP and HTTPS, the apiserver call-out through the port's fake API
server, the port's engine against a denial, and the webhook down."""

import copy
import importlib
import json
import shutil
import ssl
import subprocess
import urllib.error
import urllib.request

import pytest

from test_torch_telemetry import MIB, FakeCard, FakeNvml

from yoda_scheduler_tpu_torch.chaos import (
    FaultPlan, FaultWindow, VanillaAuthorityCluster, WEBHOOK_DOWN)
from yoda_scheduler_tpu_torch.k8s.client import ApiError, KubeClient, is_webhook_denial
from yoda_scheduler_tpu_torch.k8s.fake_apiserver import FakeApiServer
from yoda_scheduler_tpu_torch.k8s.webhook import BindAuthority, WebhookServer
from yoda_scheduler_tpu_torch.scheduler import FakeCluster, Scheduler, SchedulerConfig
from yoda_scheduler_tpu_torch.scheduler.core import FakeClock, default_profile
from yoda_scheduler_tpu_torch.telemetry import TelemetryStore, make_gpu_node, nvml, sniffer
from yoda_scheduler_tpu_torch.utils import Pod, PodPhase

PKGS = ("yoda_scheduler_tpu", "yoda_scheduler_tpu_torch")
NODES = ("h100-a", "h100-b")
CARD_FREE_MB = 81_023          # the fake card's free memory: 81,559 MB less 536 in use
BUSY_CARD = ("h100-b", "5,0,0")
BUSY_CARD_FREE_MB = 41_023     # that card also runs a job of 40,000 MB
LEASES = {"yoda-shard-0": {"spec": {"holderIdentity": "rep-a", "leaseTransitions": 3}},
          "yoda-shard-1": {"spec": {"holderIdentity": "rep-b", "leaseTransitions": 0}}}


# ----------------------------------------------------------------- the feed
def sniffed_crs() -> list[dict]:
    """Each GPU node's CR as the port's sniffer writes it, in its wire form
    (JSON: coordinates as lists)."""
    crs = []
    for node in NODES:
        cards = [FakeCard(uuid=f"GPU-{node}-{i}") for i in range(8)]
        if node == BUSY_CARD[0]:
            cards[5] = FakeCard(uuid=f"GPU-{node}-5", free=cards[5].free - 40_000 * MIB)
        devices = nvml.Nvml(FakeNvml(cards)).devices()
        cr = sniffer.local_node_metrics(node, devices=devices).to_cr()
        crs.append(json.loads(json.dumps(cr)))
    return crs


def bound_pod(name, node, chips="", mem=None, phase="Running"):
    obj = {"metadata": {"name": name, "namespace": "default"},
           "spec": {"nodeName": node}, "status": {"phase": phase}}
    if chips:
        obj["metadata"]["annotations"] = {"tpu/assigned-chips": chips}
    if mem is not None:
        obj["metadata"]["labels"] = {"scv/memory": str(mem)}
    return obj


def pending_pod(name, mem=None):
    obj = bound_pod(name, "", mem=mem, phase="Pending")
    del obj["spec"]["nodeName"]
    return obj


FEED_PODS = [
    bound_pod("train-0", "h100-a", "0,0,0;1,0,0;2,0,0;3,0,0", mem=60_000),
    bound_pod("serve-0", "h100-b", "0,0,0", mem=8_000),
    bound_pod("done-0", "h100-b", "1,0,0", phase="Succeeded"),
    pending_pod("hungry", mem=CARD_FREE_MB + 1),
    pending_pod("fits", mem=CARD_FREE_MB),
    pending_pod("mid", mem=50_000),
]


def binding(name, node, chips="", fence=None):
    b = {"apiVersion": "v1", "kind": "Binding",
         "metadata": {"name": name, "namespace": "default"},
         "target": {"apiVersion": "v1", "kind": "Node", "name": node}}
    ann = {}
    if chips:
        ann["tpu/assigned-chips"] = chips
    if fence:
        ann["yoda.tpu/fence"] = fence
    if ann:
        b["metadata"]["annotations"] = ann
    return b


def review_doc(obj, uid):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "object": obj}}


class Side:
    """One package's webhook, built from its own modules over the shared
    feed. `review` sends one AdmissionReview and returns its response with
    the verdict (allowed, code, message) the authority gave it: an allowed
    response carries no status, so its message is read off `check`."""

    def __init__(self, pkg: str) -> None:
        self.mod = importlib.import_module(f"{pkg}.k8s.webhook")
        self.uid = 0

    def authority(self, synced=True, **kw):
        kw.setdefault("stale_after_s", 1e9)
        auth = self.mod.BindAuthority(lease_get=copy.deepcopy(LEASES).get, **kw)
        auth.index.replace_pods(copy.deepcopy(FEED_PODS))
        auth.index.replace_metrics(sniffed_crs())
        if synced:
            auth.touch()  # the feed's first list landed
        check, auth.verdicts = auth.check, []
        auth.check = lambda b: auth.verdicts.append(check(b)) or auth.verdicts[-1]
        return auth

    def review(self, auth, obj):
        self.uid += 1
        n = len(auth.verdicts)
        resp = auth.review(review_doc(obj, f"u-{self.uid}"))["response"]
        if len(auth.verdicts) > n:
            return {**resp, "verdict": auth.verdicts[-1]}
        status = resp["status"]  # refused before `check`: a malformed review
        return {**resp, "verdict": (resp["allowed"], status["code"], status["message"])}


def verdict(resp):
    return tuple(resp["verdict"])


def flips(auth):
    return [e["state"] for e in auth.flight.snapshot() if e["kind"] == "webhook_fail_open"]


def denials(auth, reason):
    return auth.metrics.labeled_counter("webhook_denials_total", {"reason": reason})


# ------------------------------------------------------------- the cases
def case_no_claim(s):
    auth = s.authority()
    r = s.review(auth, binding("p", "h100-a"))
    assert verdict(r) == (True, 200, "no chip claim")
    return [r, auth.metrics.counters["webhook_allows_total"]]


def case_card_overlap(s):
    auth = s.authority()
    r = s.review(auth, binding("other", "h100-a", "3,0,0;4,0,0"))
    ok, code, msg = verdict(r)
    assert not ok and code == 409 and r["status"]["reason"] == "Conflict"
    assert msg == "chip claim conflict on h100-a: 3,0,0 already owned by default/train-0"
    return [r, denials(auth, "chip_claim"),
            [e["kind"] for e in auth.flight.snapshot()]]


def case_own_replayed_claim(s):
    auth = s.authority()
    r = s.review(auth, binding("train-0", "h100-a", "0,0,0;1,0,0;2,0,0;3,0,0"))
    assert verdict(r)[0]  # a replay of a bind must not fight its own claim
    return [r]


def case_disjoint_cards(s):
    auth = s.authority()
    # card 1 of h100-b belongs to a pod that finished: free again
    out = [s.review(auth, binding("other", "h100-a", "4,0,0;5,0,0;6,0,0;7,0,0")),
           s.review(auth, binding("again", "h100-b", "1,0,0"))]
    assert all(r["allowed"] for r in out)
    return out


def case_hbm_past_free(s):
    auth = s.authority()
    out = [s.review(auth, binding("hungry", "h100-a", "5,0,0")),
           s.review(auth, binding("fits", "h100-a", "5,0,0")),
           s.review(auth, binding("mid", *BUSY_CARD)),
           s.review(auth, binding("mid", "h100-b", "6,0,0"))]
    assert [r["allowed"] for r in out] == [False, True, False, True]
    assert out[0]["status"]["message"] == (
        f"HBM oversubscription on h100-a/5,0,0: need {CARD_FREE_MB + 1}MB > "
        f"free {CARD_FREE_MB}MB")
    assert out[2]["status"]["message"].endswith(f"free {BUSY_CARD_FREE_MB}MB")
    return out + [denials(auth, "hbm")]


def case_fence_against_fresh_lease(s):
    auth = s.authority()
    out = [s.review(auth, binding("p", "h100-a", "7,0,0", fence=f))
           for f in ("yoda-shard-0/rep-a/3", "yoda-shard-0/rep-a/2",
                     "yoda-shard-1/rep-a/0", "yoda-shard-9/rep-a/0", "garbage")]
    assert [verdict(r)[:2] for r in out] == [
        (True, 200), (False, 409), (False, 409), (False, 409), (False, 409)]
    assert "stale fencing token" in out[1]["status"]["message"]
    assert "malformed" in out[4]["status"]["message"]
    return out


def case_fail_closed_staleness(s):
    t = [0.0]
    auth = s.authority(synced=False, stale_after_s=10.0, now=lambda: t[0])
    out = [s.review(auth, binding("p", "h100-a"))]  # born stale: denied
    auth.touch()
    out.append(s.review(auth, binding("p", "h100-a")))
    t[0] = 20.0  # the feed went quiet past the limit
    out += [s.review(auth, binding("p", "h100-a")),
            s.review(auth, binding("p", "h100-a"))]
    stale_gauge = auth.metrics.gauges["webhook_index_stale"]
    auth.touch()
    out.append(s.review(auth, binding("q", "h100-a", "7,0,0")))
    assert [verdict(r)[:2] for r in out] == [
        (False, 503), (True, 200), (False, 503), (False, 503), (True, 200)]
    assert out[0]["status"]["reason"] == "ServiceUnavailable"
    assert flips(auth) == ["degraded", "recovered", "degraded", "recovered"]
    return out + [flips(auth), stale_gauge, auth.metrics.gauges["webhook_index_stale"],
                  denials(auth, "index_stale")]


def case_fail_open_staleness(s):
    t = [0.0]
    auth = s.authority(stale_after_s=10.0, fail_open=True, now=lambda: t[0])
    t[0] = 20.0
    r = s.review(auth, binding("other", "h100-a", "0,0,0"))  # a known conflict
    assert verdict(r) == (True, 200, "claim index stale; allowed (fail-open)")
    assert auth.metrics.counters["webhook_fail_open_allows_total"] == 1
    return [r, flips(auth), auth.metrics.counters["webhook_fail_open_allows_total"]]


def case_protocol_and_uid_echo(s):
    auth = s.authority()
    out = [auth.review(review_doc(binding("b", "h100-b", "0,0,0"), "uid-x")),
           auth.review(review_doc(binding("c", "h100-b"), "uid-y"))]
    out.append(auth.verdicts)
    assert out[0]["kind"] == "AdmissionReview"
    assert out[0]["apiVersion"] == "admission.k8s.io/v1"
    assert out[0]["response"]["uid"] == "uid-x" and not out[0]["response"]["allowed"]
    assert out[1]["response"] == {"uid": "uid-y", "allowed": True}
    return out


def case_malformed_review(s):
    auth = s.authority()
    out = [s.review(auth, {"kind": "Pod", "metadata": {"name": "p"}}),
           s.review(auth, None)]
    assert all(verdict(r)[:2] == (False, 400) for r in out)
    assert out[0]["status"]["reason"] == "BadRequest"
    return out + [denials(auth, "malformed_review")]


def case_provisional_claims(s):
    """Two conflicting bindings inside the watch-latency window: the first
    allow records a provisional claim, so the second is caught before any
    pod event arrives; a stale relist does not clear it, the pod's watch
    event replaces it with the confirmed claim, deletion frees the card."""
    auth = s.authority()
    idx = auth.index
    out = [s.review(auth, binding("a", "h100-b", "2,0,0")),
           s.review(auth, binding("b", "h100-b", "2,0,0"))]
    idx.apply_pod("ADDED", pending_pod("a"))  # a relist taken before the allow
    out.append(s.review(auth, binding("b", "h100-b", "2,0,0")))
    idx.apply_pod("MODIFIED", bound_pod("a", "h100-b", "2,0,0"))
    out.append(s.review(auth, binding("b", "h100-b", "2,0,0")))
    idx.apply_pod("DELETED", bound_pod("a", "h100-b", "2,0,0"))
    out.append(s.review(auth, binding("b", "h100-b", "2,0,0")))
    assert [r["allowed"] for r in out] == [True, False, False, False, True]
    assert out[1]["status"]["message"].endswith("already owned by default/a")
    return out


def case_provisional_claim_expires(s):
    auth = s.authority()
    auth.index.provisional_claim("default/a", "h100-b", {"3,0,0"}, ttl_s=-1.0)
    auth.index.provisional_claim("default/c", "h100-b", {"4,0,0"}, ttl_s=60.0)
    out = [s.review(auth, binding("b", "h100-b", "3,0,0")),
           s.review(auth, binding("d", "h100-b", "4,0,0"))]
    assert [r["allowed"] for r in out] == [True, False]
    return out


CASES = {name.removeprefix("case_"): fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_answers_every_review_as_the_jax_webhook(case):
    jax_side, port_side = (Side(pkg) for pkg in PKGS)
    assert CASES[case](port_side) == CASES[case](jax_side)


def test_feed_is_the_sniffed_h100_nodes():
    """The shared feed is what the parity cases claim: 8 cards a node, each
    81,559 MB, at coordinates x,0,0, the node's model h100-sxm5."""
    for cr in sniffed_crs():
        st = cr["status"]
        assert st["accelerator"] == "gpu" and st["tpu_generation"] == "h100-sxm5"
        assert [c["coords"] for c in st["chips"]] == [[i, 0, 0] for i in range(8)]
        assert {c["hbm_total_mb"] for c in st["chips"]} == {81_559}


# ------------------------------------------------------- HTTP(S) surface
def openssl_certs(folder) -> tuple[str, str, str]:
    """(ca.crt, tls.crt, tls.key) by the recipe of the webhook manifest's
    header (a CA, then a serving certificate it signs), the serving
    certificate's name being 127.0.0.1, where the tests reach it."""
    ca_key, ca, key, csr, crt, ext = (str(folder / n) for n in (
        "ca.key", "ca.crt", "tls.key", "tls.csr", "tls.crt", "san.ext"))
    (folder / "san.ext").write_text("subjectAltName=IP:127.0.0.1\n")
    for cmd in (
            ["req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "1",
             "-keyout", ca_key, "-out", ca, "-subj", "/CN=yoda-gpu-webhook-ca"],
            ["req", "-newkey", "rsa:2048", "-nodes", "-keyout", key, "-out", csr,
             "-subj", "/CN=127.0.0.1"],
            ["x509", "-req", "-in", csr, "-CA", ca, "-CAkey", ca_key, "-CAcreateserial",
             "-days", "1", "-out", crt, "-extfile", ext]):
        subprocess.run(["openssl", *cmd], check=True, capture_output=True, timeout=60)
    return ca, crt, key


needs_openssl = pytest.mark.skipif(shutil.which("openssl") is None,
                                   reason="openssl not available")


def post_review(url, obj, uid="u-http", ctx=None):
    req = urllib.request.Request(url, data=json.dumps(review_doc(obj, uid)).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=5.0, context=ctx) as resp:
        return json.loads(resp.read())


def port_authority():
    auth = BindAuthority(stale_after_s=1e9)
    auth.index.replace_pods(copy.deepcopy(FEED_PODS))
    auth.index.replace_metrics(sniffed_crs())
    auth.touch()
    return auth


def test_validate_healthz_metrics_over_http():
    server = WebhookServer(port_authority(), host="127.0.0.1").start()
    try:
        out = post_review(server.url, binding("b", "h100-a", "0,0,0"))
        assert out["response"]["uid"] == "u-http" and not out["response"]["allowed"]
        assert out["response"]["status"]["code"] == 409
        assert post_review(server.url, binding("c", "h100-a", "7,0,0"))["response"]["allowed"]
        base = server.url.rsplit("/", 1)[0]
        with urllib.request.urlopen(f"{base}/healthz", timeout=5.0) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["stale"] is False
        assert health["nodes_with_metrics"] == 2 and health["pods"] == 2
        with urllib.request.urlopen(f"{base}/metrics", timeout=5.0) as r:
            text = r.read().decode()
        assert 'webhook_denials_total{reason="chip_claim"} 1' in text
        assert "webhook_reviews_total 2" in text and "webhook_allows_total 1" in text
    finally:
        server.stop()


def test_reviews_on_one_kept_alive_connection_are_not_held_by_nagle():
    """An apiserver keeps its connection to a webhook alive. Each response
    is two writes (headers, body); with Nagle on the server's socket the
    body waits for the caller's delayed ACK, ~40 ms a review on Linux,
    against well under a millisecond with TCP_NODELAY."""
    import http.client
    import statistics
    import time

    server = WebhookServer(port_authority(), host="127.0.0.1").start()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    try:
        ms = []
        for i in range(20):
            body = json.dumps(review_doc(binding(f"p{i}", "h100-a"), f"u{i}"))
            t0 = time.perf_counter()
            conn.request("POST", "/validate", body, {"Content-Type": "application/json"})
            resp = json.loads(conn.getresponse().read())["response"]
            ms.append((time.perf_counter() - t0) * 1e3)
            assert resp == {"uid": f"u{i}", "allowed": True}
        assert statistics.median(ms) < 20.0, ms
    finally:
        conn.close()
        server.stop()


def test_healthz_is_503_while_a_fail_closed_index_is_stale():
    """The readiness probe keeps a cold webhook out of rotation until its
    feed's first list lands."""
    server = WebhookServer(BindAuthority(stale_after_s=30.0), host="127.0.0.1").start()
    try:
        base = server.url.rsplit("/", 1)[0]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/healthz", timeout=5.0)
        assert ei.value.code == 503
        server.authority.touch()
        with urllib.request.urlopen(f"{base}/healthz", timeout=5.0) as r:
            assert r.status == 200
    finally:
        server.stop()


@needs_openssl
def test_https_with_a_ca_signed_certificate(tmp_path):
    """The deploy posture: the apiserver verifies the webhook's serving
    certificate against caBundle (here ca.crt), and its call-out through
    the port's fake API server verifies against the same CA."""
    ca, crt, key = openssl_certs(tmp_path)
    auth = port_authority()
    server = WebhookServer(auth, host="127.0.0.1", certfile=crt, keyfile=key).start()
    try:
        assert server.url.startswith("https://")
        ctx = ssl.create_default_context(cafile=ca)
        out = post_review(server.url, binding("b", "h100-a", "1,0,0"), ctx=ctx)
        assert out["response"]["allowed"] is False
        with FakeApiServer() as api:
            api.state.add_node("h100-a")
            api.state.add_pod({"metadata": {"name": "p1", "namespace": "default"}})
            api.state.set_webhook(server.url, ca_file=ca)
            with pytest.raises(ApiError) as ei:
                KubeClient(api.url, max_retries=0).bind(Pod("p1"), "h100-a", [(2, 0, 0)])
            assert "denied the request" in str(ei.value)
            assert "already owned by default/train-0" in str(ei.value)
    finally:
        server.stop()


# --------------------------------------------- the fake apiserver call-out
@pytest.fixture
def callout():
    """The port's fake API server in its vanilla posture, the webhook
    registered, one GPU node whose card 0 a bound pod owns."""
    with FakeApiServer() as api:
        api.state.add_node("h100-a")
        for cr in sniffed_crs():
            api.state.put_metrics(cr)
        auth = port_authority()
        server = WebhookServer(auth, host="127.0.0.1").start()
        api.state.set_webhook(server.url)
        try:
            yield api, KubeClient(api.url, max_retries=0)
        finally:
            server.stop()


def test_denial_surfaces_in_the_real_apiservers_message_shape(callout):
    api, client = callout
    api.state.add_pod({"metadata": {"name": "loser", "namespace": "default"}})
    with pytest.raises(ApiError) as ei:
        client.bind(Pod("loser"), "h100-a", [(0, 0, 0)])
    assert ei.value.status == 409 and is_webhook_denial(ei.value)
    assert "denied the request" in str(ei.value)
    assert "chip claim conflict on h100-a: 0,0,0" in str(ei.value)
    assert api.state.webhook_denials == 1
    assert (api.state.pod("loser") or {}).get("spec", {}).get("nodeName") is None


def test_allowed_binding_lands_and_is_counted(callout):
    api, client = callout
    api.state.add_pod({"metadata": {"name": "ok", "namespace": "default"}})
    client.bind(Pod("ok"), "h100-a", [(4, 0, 0), (5, 0, 0)])
    pod = api.state.pod("ok")
    assert pod["spec"]["nodeName"] == "h100-a"
    assert pod["metadata"]["annotations"]["tpu/assigned-chips"] == "4,0,0;5,0,0"
    assert (api.state.webhook_calls, api.state.webhook_denials) == (1, 0)


@pytest.mark.parametrize("policy", ["Fail", "Ignore"])
def test_unreachable_webhook_follows_the_failure_policy(policy):
    with FakeApiServer() as api:
        api.state.add_node("h100-a")
        api.state.add_pod({"metadata": {"name": "p", "namespace": "default"}})
        api.state.set_webhook("http://127.0.0.1:1/validate", failure_policy=policy,
                              timeout_s=0.3)
        client = KubeClient(api.url, max_retries=0)
        if policy == "Fail":
            with pytest.raises(ApiError) as ei:
                client.bind(Pod("p"), "h100-a", [(0, 0, 0)])
            assert ei.value.status == 500 and "failed calling webhook" in str(ei.value)
            assert not is_webhook_denial(ei.value)  # an outage, not a verdict
            assert (api.state.pod("p") or {}).get("spec", {}).get("nodeName") is None
        else:
            client.bind(Pod("p"), "h100-a", [(0, 0, 0)])
            assert api.state.pod("p")["spec"]["nodeName"] == "h100-a"
            assert api.state.webhook_errors == 1


# ---------------------------------------------------- the engine's side
class DenyOnceCluster(FakeCluster):
    """A FakeCluster whose `deny_call`-th bind is refused with a webhook
    denial's shape (the apiserver's message, `status`); with `foreign` a
    competing bind of the same pod lands first, so the denial resolves as
    a foreign bind instead of a node-claim retry."""

    def __init__(self, telemetry, deny_call, status=400, foreign=None):
        super().__init__(telemetry)
        self.calls, self.deny_call, self.status, self.foreign = 0, deny_call, status, foreign

    def bind(self, pod, node, assigned_chips=None, fence=None):
        i, self.calls = self.calls, self.calls + 1
        if i == self.deny_call:
            if self.foreign is not None:
                winner = Pod(pod.name, namespace=pod.namespace, labels=dict(pod.labels))
                super().bind(winner, *self.foreign)
            raise ApiError("POST", f"binding/{pod.key}", self.status,
                           b'admission webhook "yoda-gpu-bind-authority.yoda.tpu" '
                           b'denied the request: chip claim conflict on g0')
        super().bind(pod, node, assigned_chips, fence=fence)


def gpu_store():
    store = TelemetryStore()
    for i in range(2):
        m = make_gpu_node(f"g{i}", cards=8, model="h100-sxm5")
        m.heartbeat = 0.0
        store.put(m)
    return store


def engine(cluster, clock, **kw):
    config = SchedulerConfig(telemetry_max_age_s=1e9, **kw)
    profile, _a, _g = default_profile(config)
    return Scheduler(cluster, config, profile=profile, clock=clock)


def gpu_pods(n):
    return [Pod(f"p{i}", labels={"tpu/accelerator": "gpu", "scv/number": "1",
                                 "scv/memory": "20000"}) for i in range(n)]


def drain(sched, pods, budget=200.0):
    clock = sched.clock
    while not all(p.phase in (PodPhase.BOUND, PodPhase.FAILED) for p in pods):
        assert clock.time() < budget, [(p.name, p.phase) for p in pods]
        if sched.run_one() is None:
            wake = sched.next_wake_at()
            assert wake is not None, "idle with unresolved pods"
            clock.advance(max(wake - clock.time(), 0.01))
        else:
            clock.advance(0.01)


@pytest.mark.parametrize("status", [400, 403, 409])
def test_denial_resolves_as_a_node_claim_conflict_attempt_free(status):
    clock = FakeClock()
    cluster = DenyOnceCluster(gpu_store(), deny_call=0, status=status)
    cluster.add_nodes_from_telemetry()
    sched = engine(cluster, clock)
    (pod,) = pods = gpu_pods(1)
    sched.submit(pod)
    drain(sched, pods)
    assert pod.phase == PodPhase.BOUND and pod.node in ("g0", "g1")
    c = sched.metrics.counters
    assert c["bind_conflicts_total"] == 1 and c["bind_conflict_retries_total"] == 1
    assert c.get("bind_errors_total", 0) == 0 and c.get("breaker_opens_total", 0) == 0
    assert c.get("pods_unschedulable_total", 0) == 0
    assert cluster.calls == 2  # denied once, retried once


def test_denial_with_a_foreign_winner_adopts_the_clusters_truth():
    clock = FakeClock()
    cluster = DenyOnceCluster(gpu_store(), deny_call=0, status=403,
                              foreign=("g1", [(6, 0, 0)]))
    cluster.add_nodes_from_telemetry()
    sched = engine(cluster, clock)
    (pod,) = pods = gpu_pods(1)
    sched.submit(pod)
    drain(sched, pods)
    assert pod.phase == PodPhase.BOUND and pod.node == "g1"  # the winner's node
    c = sched.metrics.counters
    assert c["foreign_bind_conflicts_total"] == 1
    assert c.get("bind_conflict_retries_total", 0) == 0
    assert cluster.calls == 1  # never replayed against the winner


# --------------------------------------------------- the webhook down
def down_plan():
    plan = FaultPlan(0, horizon_s=10.0)
    plan.windows = [FaultWindow(WEBHOOK_DOWN, 0.0, 3.0)]
    return plan


def test_webhook_down_fail_closed_defers_binds_and_never_trips_the_breaker():
    clock = FakeClock()
    cluster = VanillaAuthorityCluster(gpu_store(), plan=down_plan(), clock=clock,
                                      fail_open=False)
    cluster.add_nodes_from_telemetry()
    sched = engine(cluster, clock, breaker_threshold=3)
    pods = gpu_pods(4)
    for p in pods:
        sched.submit(p)
    drain(sched, pods)
    assert all(p.phase == PodPhase.BOUND for p in pods)
    c = sched.metrics.counters
    assert c.get("breaker_opens_total", 0) == 0  # a 500 is an answer: backoff
    assert c["bind_errors_total"] >= 1
    assert cluster.injected[WEBHOOK_DOWN] >= 1
    assert cluster.webhook_checked >= 4 and cluster.webhook_skipped == 0


def test_webhook_down_fail_open_lets_binds_through_and_counts_them():
    clock = FakeClock()
    cluster = VanillaAuthorityCluster(gpu_store(), plan=down_plan(), clock=clock,
                                      fail_open=True)
    cluster.add_nodes_from_telemetry()
    sched = engine(cluster, clock)
    cluster.flight = sched.flight
    pods = gpu_pods(4)
    for p in pods:
        sched.submit(p)
    drain(sched, pods)
    assert all(p.phase == PodPhase.BOUND for p in pods)
    assert cluster.webhook_skipped >= 1
    assert sched.metrics.counters.get("bind_errors_total", 0) == 0
    assert any(e["kind"] == "webhook_fail_open" for e in sched.flight.snapshot())
