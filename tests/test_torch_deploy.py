"""The port's deploy set (yoda_scheduler_tpu_torch/deploy/) holds together on
its own, on the CPU: the bind-authority webhook's manifest agrees with itself
and its command runs; every request the scheduler, the sniffer and the
webhook make is granted by the ClusterRole of the account their manifest
names; the port's TpuNodeMetrics CRD takes every CR the port writes (a
structural-schema check, as a real apiserver makes, which the fake API
server does not); the publisher never writes to a status subresource the
CRD does not have. Also the GPU serving example with admission."""

import contextlib
import copy
import json
import re
import ssl
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import pytest
import yaml

from test_torch_engine import Pkg, record
from test_torch_telemetry import MIB, FakeCard, FakeNvml
from test_torch_webhook import needs_openssl, openssl_certs

from yoda_scheduler_tpu_torch import cli
from yoda_scheduler_tpu_torch.k8s import crdcheck
from yoda_scheduler_tpu_torch.k8s.client import (ApiError, KubeClient,
                                                 run_scheduler_against_cluster)
from yoda_scheduler_tpu_torch.k8s.fake_apiserver import FakeApiServer
from yoda_scheduler_tpu_torch.k8s.webhook import BindAuthority, WebhookServer, serve_webhook
from yoda_scheduler_tpu_torch.telemetry import (make_gpu_node, make_tpu_node, make_v4_slice,
                                                nvml, sniffer)
from yoda_scheduler_tpu_torch.topology.generations import GENERATIONS
from yoda_scheduler_tpu_torch.topology.gpus import GPUS
from yoda_scheduler_tpu_torch.utils import Pod

ROOT = Path(__file__).resolve().parent.parent
DEPLOY = ROOT / "yoda_scheduler_tpu_torch" / "deploy"
WEBHOOK_YAML = DEPLOY / "gpu-bind-authority-webhook.yaml"
JAX_CRD = ROOT / "deploy" / "crd-tpunodemetrics.yaml"
EXAMPLE = ROOT / "yoda_scheduler_tpu_torch" / "example" / "serving-h100-with-admission.yaml"
LIMIT_S = 60.0  # the webhook process's time to answer /healthz


def docs(path) -> list[dict]:
    return [d for d in yaml.safe_load_all(Path(path).read_text()) if d]


def one(path, kind) -> dict:
    (doc,) = [d for d in docs(path) if d["kind"] == kind]
    return doc


def flag(args, name) -> str:
    (value,) = [a.split("=", 1)[1] for a in args if a.startswith(f"--{name}=")]
    return value


def pod_spec(deployment) -> dict:
    return deployment["spec"]["template"]["spec"]


def webhook_container() -> dict:
    (c,) = pod_spec(one(WEBHOOK_YAML, "Deployment"))["containers"]
    return c


# ------------------------------------------- (a) the manifest's own agreement
def test_webhook_manifest_ports_and_names_agree():
    dep, svc = one(WEBHOOK_YAML, "Deployment"), one(WEBHOOK_YAML, "Service")
    vwc = one(WEBHOOK_YAML, "ValidatingWebhookConfiguration")
    c = webhook_container()
    (port,) = c["ports"]
    (svc_port,) = svc["spec"]["ports"]
    assert svc_port["targetPort"] == port["containerPort"] == int(flag(c["args"], "port"))
    assert svc_port["port"] == 443  # an apiserver calls a webhook Service on 443
    probe = c["readinessProbe"]["httpGet"]
    assert (probe["path"], probe["port"], probe["scheme"]) == ("/healthz", port["containerPort"],
                                                               "HTTPS")
    labels = dep["spec"]["template"]["metadata"]["labels"]
    assert dep["spec"]["selector"]["matchLabels"] == svc["spec"]["selector"] == labels
    assert dep["spec"]["replicas"] == 1
    assert dep["metadata"]["namespace"] == svc["metadata"]["namespace"] == "kube-system"

    (hook,) = vwc["webhooks"]
    ref = hook["clientConfig"]["service"]
    assert (ref["name"], ref["namespace"]) == (svc["metadata"]["name"],
                                               svc["metadata"]["namespace"])
    # the route WebhookServer serves AdmissionReviews on
    server = WebhookServer(BindAuthority(), host="127.0.0.1").start()
    server.stop()
    assert ref["path"] == urllib.parse.urlparse(server.url).path == "/validate"
    assert hook["failurePolicy"] == "Fail" and hook["timeoutSeconds"] == 2
    assert hook["rules"] == [{"apiGroups": [""], "apiVersions": ["v1"],
                              "operations": ["CREATE"], "resources": ["pods/binding"]}]
    assert hook["admissionReviewVersions"] == ["v1"] and hook["sideEffects"] == "None"

    # the certificate: the recipe's CN and SAN are the Service's DNS name,
    # its secret is the one the Deployment mounts where the flags read it
    dns = f"{svc['metadata']['name']}.{svc['metadata']['namespace']}.svc"
    header = WEBHOOK_YAML.read_text().split("apiVersion:", 1)[0]
    assert re.findall(r'-subj "/CN=([^"]+)"', header)[1] == dns
    assert re.findall(r"subjectAltName=DNS:([\w.-]+)", header) == [dns]
    (secret,) = re.findall(r"create secret tls (\S+)", header)
    (vol,) = pod_spec(dep)["volumes"]
    (mount,) = c["volumeMounts"]
    assert vol["secret"]["secretName"] == secret and mount["name"] == vol["name"]
    for name, file in (("tls-cert", "tls.crt"), ("tls-key", "tls.key")):
        assert flag(c["args"], name) == f"{mount['mountPath']}/{file}"


def test_webhook_manifest_is_the_ports_and_apart_from_the_jax_one():
    c = webhook_container()
    assert c["image"] == "yoda-gpu-scheduler:0.1.0"
    assert c["command"] == ["python3", "-m", "yoda_scheduler_tpu_torch.cli"]
    assert c["args"][0] == "webhook"
    names = {d["metadata"]["name"] for d in docs(WEBHOOK_YAML)}
    assert names == {"yoda-gpu-bind-authority"}
    jax_names = {d["metadata"]["name"] for d in docs(ROOT / "deploy" /
                                                     "bind-authority-webhook.yaml")}
    assert not names & jax_names
    (hook,) = one(WEBHOOK_YAML, "ValidatingWebhookConfiguration")["webhooks"]
    assert hook["name"] == "yoda-gpu-bind-authority.yoda.tpu"
    # its account is one the port's RBAC creates
    accounts = {(d["metadata"]["name"], d["metadata"]["namespace"])
                for p in DEPLOY.glob("*.yaml") for d in docs(p) if d["kind"] == "ServiceAccount"}
    dep = one(WEBHOOK_YAML, "Deployment")
    assert (pod_spec(dep)["serviceAccountName"], dep["metadata"]["namespace"]) in accounts


def test_cli_webhook_parses_the_manifests_args():
    """argparse takes every flag: the command gets as far as looking for
    an API server (none answers on port 1) and returns 2 without a usage
    error (argparse's SystemExit)."""
    assert cli.main(webhook_container()["args"] + ["--apiserver=http://127.0.0.1:1"]) == 2


def test_the_three_docstrings_name_the_ports_manifest():
    pkg = ROOT / "yoda_scheduler_tpu_torch"
    for rel in ("cli.py", "k8s/webhook.py", "scheduler/config.py"):
        text = re.sub(r"-\n\s*#\s*", "-", (pkg / rel).read_text())  # rejoin a wrapped name
        assert "deploy/gpu-bind-authority-webhook.yaml" in text, rel
        assert "deploy/bind-authority-webhook.yaml" not in text, rel


# --------------------------------------------- (b) the manifest's command runs
def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gpu_cr(node, cards=8) -> dict:
    devices = nvml.Nvml(FakeNvml([FakeCard(uuid=f"GPU-{node}-{i}")
                                  for i in range(cards)])).devices()
    return json.loads(json.dumps(sniffer.local_node_metrics(node, devices=devices).to_cr()))


def add_gpu_node(api, node):
    api.state.add_node(node)
    api.state.put_metrics(gpu_cr(node))


@needs_openssl
def test_manifests_command_serves_https_and_denies_a_conflict(tmp_path):
    """The manifest's command and args, as its container runs them, with
    these substitutions only: the interpreter running this test for the
    image's `python3`, a free port for --port=8443, certificates made by
    openssl in tmp_path for /certs/tls.crt and /certs/tls.key, and
    --apiserver=<the port's fake API server> for the in-cluster account."""
    ca, crt, key = openssl_certs(tmp_path)
    c = webhook_container()
    port = free_port()
    subs = {"--port": str(port), "--tls-cert": crt, "--tls-key": key}
    args = [a if a.split("=")[0] not in subs else f"{a.split('=')[0]}={subs[a.split('=')[0]]}"
            for a in c["args"]]
    with FakeApiServer() as api:
        add_gpu_node(api, "h100-a")
        api.state.add_pod({"metadata": {"name": "owner", "namespace": "default",
                                        "annotations": {"tpu/assigned-chips": "0,0,0"}},
                           "spec": {"nodeName": "h100-a"}, "status": {"phase": "Running"}})
        for name in ("loser", "winner"):
            api.state.add_pod({"metadata": {"name": name, "namespace": "default"}})
        cmd = [sys.executable if c["command"][0] == "python3" else c["command"][0],
               *c["command"][1:], *args, f"--apiserver={api.url}"]
        proc = subprocess.Popen(cmd, cwd=str(ROOT), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            ctx = ssl.create_default_context(cafile=ca)
            base = f"https://127.0.0.1:{port}"
            deadline, health = time.monotonic() + LIMIT_S, None
            while health is None and time.monotonic() < deadline:
                assert proc.poll() is None, proc.communicate()[0]
                with contextlib.suppress(OSError):  # refused, or 503 until the feed lists
                    with urllib.request.urlopen(f"{base}/healthz", context=ctx,
                                                timeout=2.0) as r:
                        health = json.loads(r.read())
                if health is None:
                    time.sleep(0.1)
            assert health is not None and health["ok"] and health["nodes_with_metrics"] == 1
            api.state.set_webhook(f"{base}/validate", ca_file=ca)
            client = KubeClient(api.url, max_retries=0)
            with pytest.raises(ApiError) as ei:
                client.bind(Pod("loser"), "h100-a", [(0, 0, 0)])
            assert ei.value.status == 409 and "denied the request" in str(ei.value)
            assert "already owned by default/owner" in str(ei.value)
            client.bind(Pod("winner"), "h100-a", [(1, 0, 0)])
            assert api.state.pod("winner")["spec"]["nodeName"] == "h100-a"
            assert (api.state.webhook_calls, api.state.webhook_denials) == (2, 1)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)


# ------------------------------------------------ (c) RBAC against requests
def rbac_request(method: str, path: str):
    """(apiGroup, resource, verb) of one request to the API server, as
    the apiserver's authorizer sees it; None for a non-resource URL."""
    base, _, query = path.partition("?")
    parts = base.strip("/").split("/")
    if parts[0] == "api":
        group, rest = "", parts[2:]
    elif parts[0] == "apis":
        group, rest = parts[1], parts[3:]
    else:
        return None
    if rest[0] == "namespaces" and len(rest) >= 3:
        rest = rest[2:]
    resource = rest[0] + (f"/{rest[2]}" if len(rest) == 3 else "")
    item = len(rest) >= 2
    if method == "GET":
        watch = urllib.parse.parse_qs(query).get("watch") == ["true"]
        verb = "watch" if watch else "get" if item else "list"
    else:
        verb = {"POST": "create", "PUT": "update", "PATCH": "patch",
                "DELETE": "delete" if item else "deletecollection"}[method]
    return group, resource, verb


def test_rbac_request_mapping():
    assert rbac_request("GET", "/api/v1/pods?limit=500") == ("", "pods", "list")
    assert rbac_request("GET", "/api/v1/pods?watch=true&resourceVersion=3") == (
        "", "pods", "watch")
    assert rbac_request("POST", "/api/v1/namespaces/default/pods/p/binding") == (
        "", "pods/binding", "create")
    assert rbac_request("GET", "/api/v1/namespaces?limit=500") == ("", "namespaces", "list")
    assert rbac_request("PUT", "/apis/metrics.yoda.tpu/v1/tpunodemetrics/n0") == (
        "metrics.yoda.tpu", "tpunodemetrics", "update")
    assert rbac_request("GET", "/apis/coordination.k8s.io/v1/namespaces/kube-system/"
                               "leases/yoda-tpu-scheduler") == (
        "coordination.k8s.io", "leases", "get")
    assert rbac_request("GET", "/version") is None


def cluster_role_of(account: str) -> list[dict]:
    """The rules of every ClusterRole bound to the kube-system account
    `account` in the port's deploy set."""
    all_docs = [d for p in sorted(DEPLOY.glob("*.yaml")) for d in docs(p)]
    roles = {d["metadata"]["name"]: d["rules"] for d in all_docs if d["kind"] == "ClusterRole"}
    return [rule for d in all_docs if d["kind"] == "ClusterRoleBinding"
            if {"kind": "ServiceAccount", "name": account, "namespace": "kube-system"}
            in d["subjects"] for rule in roles[d["roleRef"]["name"]]]


def granted(rules, group, resource, verb) -> bool:
    return any((group in r["apiGroups"] or "*" in r["apiGroups"])
               and (resource in r["resources"] or "*" in r["resources"])
               and (verb in r["verbs"] or "*" in r["verbs"]) for r in rules)


def account_of(manifest: str) -> str:
    (dep,) = [d for d in docs(DEPLOY / manifest) if d["kind"] in ("Deployment", "DaemonSet")]
    return pod_spec(dep)["serviceAccountName"]


def wait(cond, limit=LIMIT_S, step=0.05):
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(step)


def run_scheduler(api, tmp_path):
    """`cli serve` as yoda-gpu-scheduler.yaml runs it (its ConfigMap's
    profile, --leader-elect) until it has bound a GPU pod."""
    add_gpu_node(api, "h100-a")
    api.state.add_pod({"metadata": {"name": "p", "namespace": "default",
                                    "labels": {"tpu/accelerator": "gpu", "scv/number": "2"}},
                       "spec": {"schedulerName": "yoda-scheduler"}})
    config = tmp_path / "config.yaml"
    config.write_text(one(DEPLOY / "yoda-gpu-scheduler.yaml", "ConfigMap")["data"]["config.yaml"])
    command = pod_spec(one(DEPLOY / "yoda-gpu-scheduler.yaml", "Deployment"))[
        "containers"][0]["command"]
    assert "--leader-elect" in command
    client = KubeClient.from_env(apiserver=api.url)
    stop = threading.Event()
    t = threading.Thread(target=run_scheduler_against_cluster, daemon=True, args=(
        client, cli.load_profiles(str(config))), kwargs=dict(
        metrics_port=None, leader_elect=True, stop_event=stop, poll_s=0.1))
    t.start()
    try:
        wait(lambda: (api.state.pod("p") or {}).get("spec", {}).get("nodeName"))
    finally:
        stop.set()
        t.join(timeout=LIMIT_S)
    assert not t.is_alive()


def run_sniffer(api, tmp_path):
    """`cli sniff` with gpu-sniffer-daemonset.yaml's arguments, --once,
    twice over a fake 8-card H100 host: the first publish creates the CR,
    the second updates it."""
    (c,) = pod_spec(one(DEPLOY / "gpu-sniffer-daemonset.yaml", "DaemonSet"))["containers"]
    assert c["command"][:3] == ["python3", "-m", "yoda_scheduler_tpu_torch.cli"]
    args = [a.replace("$(NODE_NAME)", "h100-a") for a in c["command"][3:]]
    lib = FakeNvml([FakeCard(uuid=f"GPU-{i}") for i in range(8)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nvml, "_default", nvml.Nvml(lib))
        for _ in range(2):
            assert cli.main([*args, "--once", f"--apiserver={api.url}"]) == 0
    assert api.state.objects["metrics"]["h100-a"]["status"]["tpu_generation"] == "h100-sxm5"


def run_webhook(api, tmp_path):
    """The webhook's feed over the fake, then one fenced review: its lease
    read."""
    add_gpu_node(api, "h100-a")
    api.state.add_pod({"metadata": {"name": "p", "namespace": "default"}})
    server = serve_webhook(KubeClient.from_env(apiserver=api.url), port=0,
                           host="127.0.0.1", relist_s=1.0)
    try:
        wait(lambda: not server.authority.stale() and server.authority.index.stats()[
            "nodes_with_metrics"] == 1)
        doc = {"request": {"uid": "u", "object": {
            "kind": "Binding", "metadata": {"name": "p", "namespace": "default",
                                            "annotations": {"yoda.tpu/fence":
                                                            "yoda-shard-0/rep-a/0"}},
            "target": {"name": "h100-a"}}}}
        req = urllib.request.Request(server.url, data=json.dumps(doc).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=5.0) as r:
            out = json.loads(r.read())["response"]
        assert not out["allowed"] and "stale fencing token" in out["status"]["message"]
    finally:
        server.stop()


COMPONENTS = {"scheduler": ("yoda-gpu-scheduler.yaml", run_scheduler),
              "sniffer": ("gpu-sniffer-daemonset.yaml", run_sniffer),
              "webhook": ("gpu-bind-authority-webhook.yaml", run_webhook)}


@pytest.fixture(scope="module")
def requests_of(tmp_path_factory):
    """Each component's (method, path) requests, from a fake API server of
    its own."""
    out = {}
    for name, (_manifest, run) in COMPONENTS.items():
        with FakeApiServer() as api:
            run(api, tmp_path_factory.mktemp(name))
            with api.state.cond:
                out[name] = list(api.state.requests)
    return out


@pytest.mark.parametrize("component", sorted(COMPONENTS))
def test_every_request_is_granted_to_the_manifests_account(component, requests_of):
    manifest, _run = COMPONENTS[component]
    rules = cluster_role_of(account_of(manifest))
    assert rules, f"no ClusterRole bound to {account_of(manifest)}"
    seen = {rbac_request(m, p) for m, p in requests_of[component]}
    # /version: the client's reachability probe, a non-resource URL that
    # Kubernetes' default ClusterRole system:public-info-viewer grants to all
    assert None in seen and all(p == "/version" for m, p in requests_of[component]
                                if rbac_request(m, p) is None)
    missing = sorted(r for r in seen - {None} if not granted(rules, *r))
    assert not missing, f"{component} ({account_of(manifest)}) lacks {missing}"


def test_the_components_reach_what_their_roles_must_grant(requests_of):
    """The runs made the requests the roles exist for: a test that saw
    none of them would grant nothing."""
    seen = {c: {rbac_request(m, p) for m, p in reqs} for c, reqs in requests_of.items()}
    assert {("", "pods/binding", "create"), ("coordination.k8s.io", "leases", "create"),
            ("", "pods", "watch"), ("metrics.yoda.tpu", "tpunodemetrics", "watch")
            } <= seen["scheduler"]
    assert {("metrics.yoda.tpu", "tpunodemetrics", v) for v in ("get", "create", "update")
            } <= seen["sniffer"]
    assert {("coordination.k8s.io", "leases", "get"), ("", "pods", "list"),
            ("metrics.yoda.tpu", "tpunodemetrics", "list")} <= seen["webhook"]


# ----------------------------------------------- (d) CRs against the CRD
def sniffed_cr_of(model) -> dict:
    g = GPUS[model]
    card = FakeCard(name=g.nvml_names[0], total=g.hbm_mb * MIB, free=g.hbm_mb * MIB // 2,
                    max_sm_mhz=g.max_sm_clock_mhz, cores=g.cuda_cores,
                    power_limit_mw=g.power_w * 1000, nvlink=(1,) * g.links)
    devices = nvml.Nvml(FakeNvml([card] * 8)).devices()
    cr = sniffer.local_node_metrics(f"{model}-0", devices=devices, fabric="f0",
                                    fabric_hosts=32).to_cr()
    return json.loads(json.dumps(cr))


def test_crd_enum_is_exactly_the_generations_and_the_gpu_catalog():
    schema = crdcheck.schema_of(crdcheck.load_crd())
    enum = schema["properties"]["status"]["properties"]["tpu_generation"]["enum"]
    assert enum == ["", *GENERATIONS, *GPUS]


def test_crd_keeps_the_jax_wire_contract():
    port, jax = crdcheck.load_crd(), crdcheck.load_crd(JAX_CRD)
    assert port["metadata"] == jax["metadata"]
    assert {k: v for k, v in port["spec"].items() if k != "versions"} == {
        k: v for k, v in jax["spec"].items() if k != "versions"}
    # every field is the JAX one's, with the same type; only the enum grew
    p_status = crdcheck.schema_of(port)["properties"]["status"]
    j_status = copy.deepcopy(crdcheck.schema_of(jax)["properties"]["status"])
    j_status["properties"]["tpu_generation"]["enum"] = p_status["properties"][
        "tpu_generation"]["enum"]
    assert p_status == j_status


@pytest.mark.parametrize("model", sorted(GPUS))
def test_the_ports_cr_of_each_catalog_model_passes_the_ports_crd(model):
    crd = crdcheck.load_crd()
    cr = sniffed_cr_of(model)
    assert cr["status"]["tpu_generation"] == model
    assert crdcheck.check_cr(cr, crd) == []
    made = json.loads(json.dumps(make_gpu_node(f"{model}-1", model=model).to_cr()))
    assert crdcheck.check_cr(made, crd) == []


def test_tpu_nodes_of_the_ports_schema_pass_the_ports_crd():
    crd = crdcheck.load_crd()
    nodes = (make_v4_slice("s0", "2x2x2") + [make_tpu_node("t0", chips=4),
                                             make_tpu_node("e0", chips=8, generation="v5e"),
                                             make_gpu_node("g0", cards=8)])
    for m in nodes:
        assert crdcheck.check_cr(json.loads(json.dumps(m.to_cr())), crd) == [], m.node


def test_an_h100_cr_fails_the_jax_crd_on_its_enum():
    """The witness of F5: the JAX package's CRD refuses the port's GPU CR."""
    faults = crdcheck.check_cr(sniffed_cr_of("h100-sxm5"), crdcheck.load_crd(JAX_CRD))
    assert len(faults) == 1 and faults[0].startswith(".status.tpu_generation: 'h100-sxm5'")


@pytest.mark.parametrize("path,value,fault", [
    (("chips", 0, "power_w"), 700.0, "not of type integer"),
    (("chips", 0, "index"), True, "not of type integer"),
    (("heartbeat",), "now", "not of type number"),
    (("accelerator",), "npu", "is not one of"),
    (("chips", 0, "coords"), [0, "0", 0], "not of type integer"),
    (("chips", 0, "uuid"), "GPU-1", "not declared"),
    (("vendor",), "nvidia", "not declared"),
])
def test_the_checker_refuses_what_an_apiserver_refuses(path, value, fault):
    cr = sniffed_cr_of("h100-sxm5")
    node = cr["status"]
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    (got,) = crdcheck.check_cr(cr, crdcheck.load_crd())
    where = ".status" + "".join(f"[{k}]" if isinstance(k, int) else f".{k}" for k in path)
    assert got.startswith(where) and fault in got
    cr.pop("status")
    cr["spec"] = {}
    assert crdcheck.check_cr(cr, crdcheck.load_crd()) == [".spec: not declared (pruned)"]


# -------------------------------------------- (e) no status subresource
def test_status_lands_where_the_publisher_writes_it(requests_of):
    """F6: the publisher writes the whole CR to the main resource, never
    to /status, and the port's CRD has no status subresource, so a real
    apiserver keeps the status it is sent. The JAX CRD has one."""
    writes = [(m, p) for m, p in requests_of["sniffer"] if m != "GET"]
    assert [m for m, _ in writes] == ["POST", "PUT"]
    assert not any("/status" in p.partition("?")[0] for _, p in requests_of["sniffer"])
    assert not crdcheck.has_status_subresource(crdcheck.load_crd())
    assert crdcheck.has_status_subresource(crdcheck.load_crd(JAX_CRD))


# --------------------------------------------- the GPU serving example
def test_cli_validate_passes_the_gpu_serving_example(capsys):
    rc = cli.main(["validate", str(EXAMPLE)])
    assert rc == 0 and "OK" in capsys.readouterr().out


def pods_of(P, path) -> tuple[list, list]:
    """The manifest's pods (a Deployment expanded as `cli simulate` does)
    and its disruption budgets, built from package P."""
    pdb = __import__(f"{P.name}.utils.pdb", fromlist=["DisruptionBudget"])
    pods, budgets = [], []
    for doc in docs(path):
        if doc["kind"] == "Pod":
            pods.append(P.utils.Pod.from_manifest(doc))
        elif doc["kind"] == "Deployment":
            tmpl = doc["spec"]["template"]
            pods += [P.utils.Pod.from_manifest({
                "metadata": {"name": f"{doc['metadata']['name']}-{r}", "namespace": "default",
                             "labels": dict(tmpl["metadata"]["labels"])},
                "spec": tmpl["spec"]}) for r in range(doc["spec"]["replicas"])]
        elif doc["kind"] == "PodDisruptionBudget":
            budgets.append(pdb.DisruptionBudget.from_manifest(doc))
    return pods, budgets


def serve_example(pkg):
    """Three 8-card GPU nodes: two in the tainted serving pool, zones a and
    b, and a plain one. Returns the bind log and where each pod ended."""
    P = Pkg(pkg)
    store = P.telemetry.TelemetryStore()
    names = ("gpu-serve-a", "gpu-serve-b", "gpu-plain")
    for name in names:
        m = P.telemetry.make_gpu_node(name, cards=8, mem_total_mb=81_559, mem_free_mb=81_559)
        m.heartbeat = 1e18
        store.put(m)
    cluster = P.scheduler.FakeCluster(store)
    cluster.add_nodes_from_telemetry()
    taint = {"key": "dedicated", "value": "serving", "effect": "NoSchedule"}
    for name, zone in (("gpu-serve-a", "a"), ("gpu-serve-b", "b")):
        cluster.set_node_meta(name, labels={"pool": "serving", "zone": zone}, taints=[taint])
    pods, budgets = pods_of(P, EXAMPLE)
    cluster.set_pdbs(budgets)
    log = []
    record(cluster, log)
    sched = P.scheduler.Scheduler(cluster, P.scheduler.SchedulerConfig(),
                                  clock=P.core.FakeClock(start=1000.0))
    for p in pods:
        sched.submit(p)
    sched.run_until_idle(max_cycles=200)
    return log, {p.name: (p.phase.value, p.node, tuple(p.assigned_chips())) for p in pods}


def test_gpu_serving_example_places_alike_in_both_engines():
    jax_log, jax_end = serve_example("yoda_scheduler_tpu")
    log, end = serve_example("yoda_scheduler_tpu_torch")
    assert log == jax_log and end == jax_end
    assert {end["serve-0"][1], end["serve-1"][1]} == {"gpu-serve-a", "gpu-serve-b"}
    assert end["batch-leaner"][:2] == ("Bound", "gpu-plain")  # no toleration
    assert all(phase == "Bound" and len(chips) == 1 for phase, _n, chips in end.values())
