"""Process entry point: ``python -m yoda_scheduler_tpu_torch.cli``.

The reference's entry is a cobra command wrapping upstream kube-scheduler
(reference cmd/scheduler/main.go:12-21 + pkg/register/register.go). Native
equivalent with three modes:

- ``serve``    — run against a real Kubernetes API server (gated on
                 reachability; watches pods + TpuNodeMetrics CRs)
- ``simulate`` — run a full scheduling session on the in-memory fake
                 cluster from YAML manifests (the kind-cluster stand-in)
- ``sniff``    — run the local telemetry sniffer once and print the CR

``--config`` accepts a KubeSchedulerConfiguration-style YAML (the shape in
deploy/yoda-tpu-scheduler.yaml); ``--v`` sets log verbosity, as the
reference's klog flag does (deploy/yoda-scheduler.yaml:63).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

from .scheduler import FakeCluster, SchedulerConfig
from .telemetry import (FakePublisher, TelemetryStore, make_gpu_node, make_gpu_pool,
                        make_tpu_node, make_v4_slice)
from .utils.pod import Pod, PodPhase

log = logging.getLogger("yoda-tpu")

# `simulate --gpu-models`: each model's pool is one InfiniBand fabric of
# this many leaves of this many 8-card nodes
GPU_POOL_LEAVES, GPU_POOL_LEAF_NODES = 2, 8


def load_profiles(path: str | None) -> list[tuple[SchedulerConfig, dict | None]]:
    """Load every profile from a KubeSchedulerConfiguration-style YAML as
    (SchedulerConfig, plugin-enablement) pairs; one default profile when
    path is None. Upstream kube-scheduler serves ALL profiles in the list,
    routing pods by spec.schedulerName — so do we (scheduler/multi.py)."""
    if path is None:
        return [(SchedulerConfig(), None)]
    import yaml

    from .scheduler.registry import merge_enablement

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    out = []
    for profile in doc.get("profiles") or [{}]:
        cfg = SchedulerConfig.from_profile(profile)
        plugins = profile.get("plugins")
        # defaults stay enabled at unlisted extension points (k8s
        # semantics); use disabled: [{name: '*'}] to clear a point
        out.append((cfg, merge_enablement(plugins) if plugins else None))
    return out


def load_config(path: str | None) -> tuple[SchedulerConfig, dict | None]:
    """First profile only (legacy single-profile callers)."""
    return load_profiles(path)[0]


def cmd_simulate(args) -> int:
    profiles = load_profiles(args.config)
    store = TelemetryStore()
    pub = FakePublisher(store)

    # cluster topology from flags
    from .telemetry import make_slice

    nodes = []
    for i in range(args.tpu_slices):
        nodes += make_v4_slice(f"v4-32-{i}", "2x2x4")
    for i in range(args.v5e_slices):
        nodes += make_slice(f"v5e-64-{i}", "8x8x1", generation="v5e")
    for i in range(args.tpu_nodes):
        nodes.append(make_tpu_node(f"v4-8-{i}", chips=4))
    for i in range(args.gpu_nodes):
        nodes.append(make_gpu_node(f"gpu-{i}", cards=8))
    leaf_of: dict[str, str] = {}
    for model in filter(None, (args.gpu_models or "").split(",")):
        pool, leaves = make_gpu_pool(model, GPU_POOL_LEAVES, GPU_POOL_LEAF_NODES)
        nodes += pool
        leaf_of.update(leaves)
    pub.publish(*nodes)
    # the one-shot publish stands in for a continuously-publishing sniffer;
    # re-pin heartbeats far in the future (publish stamps them `now`, and
    # the store holds these same objects) so the virtual clock's backoff
    # sleeps — which race simulated time past the 60s staleness gate in
    # seconds of wall time — never age the fleet out mid-simulation (same
    # hazard bench.py guards against)
    for m in nodes:
        m.heartbeat = time.time() + 1e9

    cluster = FakeCluster(store)
    cluster.add_nodes_from_telemetry()
    from .utils.labels import IB_LEAF_LABEL

    for name, leaf in leaf_of.items():
        cluster.set_node_meta(name, labels={IB_LEAF_LABEL: leaf})
    from .scheduler.core import HybridClock
    from .scheduler.multi import MultiProfileScheduler

    # virtual clock: retry backoffs and gang timeouts advance simulated
    # time instead of wall-sleeping — a manifest that can never place
    # (e.g. a v5e gang with --v5e-slices 0) previously made simulate hang
    # for max_cycles x backoff REAL seconds before reporting Pending
    sched = MultiProfileScheduler(cluster, profiles, clock=HybridClock())

    if args.metrics_port is not None:
        from .utils.httpserv import serve

        # merged view: every profile's counters/latencies/traces/spans
        server, _ = serve(sched.metrics, sched.traces,
                          port=args.metrics_port,
                          spans=sched.spans, flight=sched.flight)
        log.info("metrics on http://%s:%d/metrics", *server.server_address)

    pods: list[Pod] = []
    import yaml

    for path in args.manifests:
        with open(path) as f:
            for doc in yaml.safe_load_all(f):
                if not doc:
                    continue
                kind = doc.get("kind")
                if kind == "Pod":
                    pods.append(Pod.from_manifest(doc))
                elif kind == "Deployment":
                    replicas = doc.get("spec", {}).get("replicas", 1)
                    tmpl = doc.get("spec", {}).get("template", {})
                    meta = doc.get("metadata", {})
                    for r in range(replicas):
                        p = Pod.from_manifest(
                            {"metadata": {
                                "name": f"{meta.get('name', 'deploy')}-{r}",
                                "namespace": meta.get("namespace", "default"),
                                "labels": dict(
                                    tmpl.get("metadata", {}).get("labels", {})),
                            },
                             "spec": tmpl.get("spec", {})})
                        pods.append(p)

    accepted = sum(sched.submit(p) for p in pods)
    log.info("submitted %d/%d pods (profiles=%s)", accepted, len(pods),
             list(sched.engines))
    sched.run_until_idle(max_cycles=args.max_cycles)

    out = {
        "pods": {
            p.key: {"phase": p.phase.value, "node": p.node,
                    "chips": p.labels.get("tpu/assigned-chips")}
            for p in pods
        },
        "bound": sum(1 for p in pods if p.phase == PodPhase.BOUND),
        "bin_pack_util_pct": round(sched.bin_pack_utilization(), 2),
        "p50_latency_ms": round(sched.metrics.histogram(
            "schedule_latency_ms").quantile(0.5), 3),
    }
    print(json.dumps(out, indent=2))
    if args.serve_forever:
        while True:
            time.sleep(3600)
    return 0 if out["bound"] == accepted else 1


def cmd_sniff(args) -> int:
    from .telemetry.sniffer import local_node_metrics

    if not args.publish:
        print(json.dumps(local_node_metrics(
            args.node_name, fabric=args.fabric,
            fabric_hosts=args.fabric_hosts).to_cr(), indent=2))
        return 0
    # daemon mode: publish this node's CR to the API server on an interval
    # (what deploy/sniffer-daemonset.yaml runs)
    from .k8s.client import KubeClient
    from .telemetry.publisher import run_publisher

    client = KubeClient.from_env(
        args.kubeconfig, args.apiserver,
        insecure_skip_tls_verify=args.insecure_skip_tls_verify)
    if client is None:
        log.error("no reachable Kubernetes API server to publish to")
        return 2
    return run_publisher(client, node_name=args.node_name,
                         interval_s=args.interval, once=args.once,
                         fabric=args.fabric, fabric_hosts=args.fabric_hosts)


def cmd_validate(args) -> int:
    """Lint workload manifests against the label contract before they hit
    the cluster: malformed scv/tpu labels (strict parse), unknown labels in
    the scv/ and tpu/ namespaces (typos silently change scheduling), and
    gang-size consistency across a file's members."""
    import yaml

    from .utils.labels import KNOWN_LABELS, LabelError, WorkloadSpec

    problems: list[str] = []
    gang_sizes: dict[str, set[int]] = {}
    gang_members: dict[str, int] = {}

    def check(name: str, labels: dict, where: str, count: int = 1) -> None:
        """Validate one workload's labels; `count` = how many member pods
        this manifest contributes (a Deployment's replicas)."""
        try:
            spec = WorkloadSpec.from_labels(labels)
        except LabelError as e:
            problems.append(f"{where}: {name}: {e}")
            return
        for k in labels:
            ns = k.split("/", 1)[0]
            if ns in ("scv", "tpu") and k not in KNOWN_LABELS:
                problems.append(
                    f"{where}: {name}: unknown label {k!r} (typo? known: "
                    f"{sorted(KNOWN_LABELS)})")
        if spec.topology is not None and spec.tpu_generation is not None:
            from .topology.generations import generation
            from .topology.torus import parse_topology

            shape = parse_topology(spec.topology)
            gen = generation(spec.tpu_generation)
            if gen.torus_rank == 2 and shape[2] > 1:
                problems.append(
                    f"{where}: {name}: tpu/topology {spec.topology} is 3-D "
                    f"but {gen.name} slices are 2-D tori — this pod can "
                    f"never place")
        if spec.is_gang:
            gang_sizes.setdefault(spec.gang_name, set()).add(spec.gang_size)
            gang_members[spec.gang_name] = (
                gang_members.get(spec.gang_name, 0) + count)

    def check_spec(name: str, spec_doc, where: str) -> None:
        """Admission fields (same contract a real apiserver validates, plus
        the combinations that pass validation but can never match): a typo'd
        toleration silently stops tolerating and the pod goes Pending.
        Malformed shapes are reported as lint errors, never tracebacks."""
        if not isinstance(spec_doc, dict):
            problems.append(
                f"{where}: {name}: spec is {type(spec_doc).__name__}, "
                f"not a mapping")
            return
        tols = spec_doc.get("tolerations") or []
        if not isinstance(tols, list):
            problems.append(
                f"{where}: {name}: tolerations is "
                f"{type(tols).__name__}, not a list")
            tols = []
        for i, t in enumerate(tols):
            if not isinstance(t, dict):
                problems.append(
                    f"{where}: {name}: tolerations[{i}] is "
                    f"{type(t).__name__}, not a mapping")
                continue
            op = t.get("operator", "Equal")
            if op not in ("Equal", "Exists"):
                problems.append(
                    f"{where}: {name}: toleration operator {op!r} "
                    f"(must be Equal or Exists)")
            eff = t.get("effect", "")
            if eff not in ("", "NoSchedule", "PreferNoSchedule", "NoExecute"):
                problems.append(
                    f"{where}: {name}: toleration effect {eff!r} (must be "
                    f"NoSchedule, PreferNoSchedule, NoExecute, or empty)")
            if not t.get("key") and op == "Equal":
                problems.append(
                    f"{where}: {name}: toleration with empty key requires "
                    f"operator Exists (tolerate-everything); with Equal it "
                    f"matches nothing")
            if op == "Exists" and t.get("value"):
                problems.append(
                    f"{where}: {name}: toleration with operator Exists must "
                    f"not set a value (apiserver rejects it)")
        sel = spec_doc.get("nodeSelector") or {}
        if not isinstance(sel, dict):
            problems.append(
                f"{where}: {name}: nodeSelector is "
                f"{type(sel).__name__}, not a mapping")
            sel = {}
        for k, v in sel.items():
            if not isinstance(v, str):
                problems.append(
                    f"{where}: {name}: nodeSelector {k!r} value "
                    f"{v!r} is {type(v).__name__}, not a string — node "
                    f"labels are strings, this can never match")
        def as_dict(x, what):
            if x is None:
                return {}
            if not isinstance(x, dict):
                problems.append(
                    f"{where}: {name}: {what} is {type(x).__name__}, "
                    f"not a mapping")
                return {}
            return x

        aff = as_dict(spec_doc.get("affinity"), "affinity")
        node_aff = as_dict(aff.get("nodeAffinity"), "nodeAffinity")
        req = as_dict(
            node_aff.get("requiredDuringSchedulingIgnoredDuringExecution"),
            "requiredDuringSchedulingIgnoredDuringExecution")
        def lint_term(term, what):
            term = as_dict(term, what)
            raw_fields = term.get("matchFields")
            if raw_fields is not None and not isinstance(raw_fields, list):
                problems.append(
                    f"{where}: {name}: matchFields is "
                    f"{type(raw_fields).__name__}, not a list — the term "
                    f"will match no node")
                raw_fields = []
            for e in (raw_fields or []):
                if not isinstance(e, dict):
                    problems.append(
                        f"{where}: {name}: matchFields entry is "
                        f"{type(e).__name__}, not a mapping")
                    continue
                fk = e.get("key")
                if fk != "metadata.name":
                    problems.append(
                        f"{where}: {name}: nodeAffinity matchFields key "
                        f"{fk!r} is not supported (only metadata.name) — "
                        f"the term will match no node")
                    continue
                op = e.get("operator", "")
                vals = e.get("values") or []
                if op not in ("In", "NotIn"):
                    problems.append(
                        f"{where}: {name}: matchFields operator {op!r} "
                        f"(metadata.name supports In/NotIn)")
                elif not vals:
                    problems.append(
                        f"{where}: {name}: matchFields {op} requires "
                        f"non-empty values — matches nothing as written")
            raw_exprs = term.get("matchExpressions") or []
            if not isinstance(raw_exprs, list):
                problems.append(
                    f"{where}: {name}: matchExpressions is "
                    f"{type(raw_exprs).__name__}, not a list")
                raw_exprs = []
            for e in raw_exprs:
                if not isinstance(e, dict):
                    problems.append(
                        f"{where}: {name}: matchExpression is "
                        f"{type(e).__name__}, not a mapping")
                    continue
                op = e.get("operator", "")
                vals = e.get("values") or []
                if op not in ("In", "NotIn", "Exists", "DoesNotExist",
                              "Gt", "Lt"):
                    problems.append(
                        f"{where}: {name}: nodeAffinity operator {op!r} "
                        f"(must be In/NotIn/Exists/DoesNotExist/Gt/Lt)")
                elif op in ("In", "NotIn"):
                    if not vals:
                        problems.append(
                            f"{where}: {name}: nodeAffinity {op} requires "
                            f"non-empty values — matches nothing as written")
                    for v in vals:
                        if not isinstance(v, str):
                            problems.append(
                                f"{where}: {name}: nodeAffinity {op} value "
                                f"{v!r} is {type(v).__name__}, not a string "
                                f"(quote it — the apiserver rejects "
                                f"non-strings)")
                elif op in ("Exists", "DoesNotExist") and vals:
                    problems.append(
                        f"{where}: {name}: nodeAffinity {op} must not set "
                        f"values (apiserver rejects it)")
                elif op in ("Gt", "Lt"):
                    if len(vals) != 1 or not str(vals[0]).lstrip("-").isdigit():
                        problems.append(
                            f"{where}: {name}: nodeAffinity {op} needs "
                            f"exactly one integer value, got {vals!r}")

        raw_terms = req.get("nodeSelectorTerms") or []
        if not isinstance(raw_terms, list):
            problems.append(
                f"{where}: {name}: nodeSelectorTerms is "
                f"{type(raw_terms).__name__}, not a list")
            raw_terms = []
        for term in raw_terms:
            lint_term(term, "nodeSelectorTerm")
        raw_prefs = node_aff.get(
            "preferredDuringSchedulingIgnoredDuringExecution") or []
        if not isinstance(raw_prefs, list):
            problems.append(
                f"{where}: {name}: preferredDuringScheduling... is "
                f"{type(raw_prefs).__name__}, not a list")
            raw_prefs = []
        for pref in raw_prefs:
            pref = as_dict(pref, "preferred nodeAffinity entry")
            w = pref.get("weight")
            if not (isinstance(w, int) and not isinstance(w, bool)
                    and 1 <= w <= 100):
                problems.append(
                    f"{where}: {name}: preferred nodeAffinity weight "
                    f"{w!r} (must be an integer in 1-100)")
            preference = pref.get("preference")
            if not preference or not isinstance(preference, dict) \
                    or not preference.get("matchExpressions"):
                problems.append(
                    f"{where}: {name}: preferred nodeAffinity entry has "
                    f"no preference.matchExpressions — it can never match "
                    f"(the apiserver requires a preference)")
            else:
                lint_term(preference, "preference")
        from .utils.quantity import parse_cpu_millis, parse_memory_bytes

        for section in ("containers", "initContainers"):
            raw_cs = spec_doc.get(section) or []
            for i, ctr in enumerate(raw_cs
                                    if isinstance(raw_cs, list) else []):
                if not isinstance(ctr, dict):
                    continue
                res = ctr.get("resources")
                req = (res or {}).get("requests") if isinstance(res, dict) \
                    else None
                if not isinstance(req, dict):
                    continue
                if "cpu" in req and parse_cpu_millis(req["cpu"]) is None:
                    problems.append(
                        f"{where}: {name}: {section}[{i}] cpu request "
                        f"{req['cpu']!r} is not a valid quantity — the "
                        f"request is silently ignored")
                if "memory" in req and \
                        parse_memory_bytes(req["memory"]) is None:
                    problems.append(
                        f"{where}: {name}: {section}[{i}] memory request "
                        f"{req['memory']!r} is not a valid quantity — the "
                        f"request is silently ignored")
        raw_spread = spec_doc.get("topologySpreadConstraints") or []
        if not isinstance(raw_spread, list):
            problems.append(
                f"{where}: {name}: topologySpreadConstraints is "
                f"{type(raw_spread).__name__}, not a list")
            raw_spread = []
        for c in raw_spread:
            c = as_dict(c, "topologySpreadConstraint")
            skew = c.get("maxSkew")
            if not (isinstance(skew, int) and not isinstance(skew, bool)
                    and skew >= 1):
                problems.append(
                    f"{where}: {name}: topologySpreadConstraint "
                    f"maxSkew={skew!r} (must be an integer >= 1)")
            if not c.get("topologyKey"):
                problems.append(
                    f"{where}: {name}: topologySpreadConstraint has no "
                    f"topologyKey")
            when = c.get("whenUnsatisfiable", "DoNotSchedule")
            if when not in ("DoNotSchedule", "ScheduleAnyway"):
                problems.append(
                    f"{where}: {name}: whenUnsatisfiable={when!r} (must "
                    f"be DoNotSchedule or ScheduleAnyway)")
            # labelSelector {} (present, empty) is valid match-all; only
            # an ABSENT or non-mapping selector counts no pods
            sel = c.get("labelSelector")
            if sel is None or not isinstance(sel, dict):
                problems.append(
                    f"{where}: {name}: topologySpreadConstraint has no "
                    f"labelSelector — it counts no pods, so the spread "
                    f"is vacuous")
            md = c.get("minDomains")
            if md is not None:
                if not (isinstance(md, int) and not isinstance(md, bool)
                        and md >= 1):
                    problems.append(
                        f"{where}: {name}: minDomains={md!r} (must be an "
                        f"integer >= 1)")
                elif when == "ScheduleAnyway":
                    problems.append(
                        f"{where}: {name}: minDomains is only honoured "
                        f"with whenUnsatisfiable=DoNotSchedule (apiserver "
                        f"rejects it with ScheduleAnyway)")
            for fld, allowed in (("nodeAffinityPolicy", ("Honor", "Ignore")),
                                 ("nodeTaintsPolicy", ("Honor", "Ignore"))):
                v = c.get(fld)
                if v is not None and v not in allowed:
                    problems.append(
                        f"{where}: {name}: {fld}={v!r} (must be Honor or "
                        f"Ignore)")
            mlk = c.get("matchLabelKeys")
            if mlk is not None and not isinstance(mlk, list):
                problems.append(
                    f"{where}: {name}: matchLabelKeys is "
                    f"{type(mlk).__name__}, not a list")
        # inter-pod (anti-)affinity: required terms filter, preferred
        # entries score by signed weight
        for which in ("podAffinity", "podAntiAffinity"):
            block = as_dict(aff.get(which), which)
            raw_prefs_pod = block.get(
                "preferredDuringSchedulingIgnoredDuringExecution") or []
            if not isinstance(raw_prefs_pod, list):
                problems.append(
                    f"{where}: {name}: preferred {which} is "
                    f"{type(raw_prefs_pod).__name__}, not a list")
                raw_prefs_pod = []
            def lint_pod_term(term, ctx):
                term = as_dict(term, ctx)
                if not term.get("topologyKey"):
                    problems.append(
                        f"{where}: {name}: {ctx} has no topologyKey "
                        f"(the apiserver requires one; without it the term "
                        f"can never be satisfied)")
                sel = term.get("labelSelector")
                if not sel or not isinstance(sel, dict) or not (
                        sel.get("matchLabels") or sel.get("matchExpressions")):
                    problems.append(
                        f"{where}: {name}: {ctx} has no "
                        f"labelSelector — it matches no pods")
                else:
                    for e in (sel.get("matchExpressions") or []):
                        op = (e or {}).get("operator", "") \
                            if isinstance(e, dict) else ""
                        if op not in ("In", "NotIn", "Exists",
                                      "DoesNotExist"):
                            problems.append(
                                f"{where}: {name}: {ctx} matchExpressions "
                                f"operator {op!r} (must be In/NotIn/Exists/"
                                f"DoesNotExist)")

            for pref in raw_prefs_pod:
                pref = as_dict(pref, f"preferred {which} entry")
                w = pref.get("weight")
                if not (isinstance(w, int) and not isinstance(w, bool)
                        and 1 <= w <= 100):
                    problems.append(
                        f"{where}: {name}: preferred {which} weight {w!r} "
                        f"(must be an integer in 1-100)")
                if not isinstance(pref.get("podAffinityTerm"), dict):
                    problems.append(
                        f"{where}: {name}: preferred {which} entry has no "
                        f"podAffinityTerm — it can never match")
                else:
                    lint_pod_term(pref["podAffinityTerm"],
                                  f"preferred {which} term")
            raw_pod_terms = block.get(
                "requiredDuringSchedulingIgnoredDuringExecution") or []
            if not isinstance(raw_pod_terms, list):
                problems.append(
                    f"{where}: {name}: {which} required terms is "
                    f"{type(raw_pod_terms).__name__}, not a list")
                raw_pod_terms = []
            for term in raw_pod_terms:
                lint_pod_term(term, f"{which} term")

    for path in args.manifests:
        with open(path) as f:
            for doc in yaml.safe_load_all(f):
                if not doc:
                    continue
                if not isinstance(doc, dict):
                    problems.append(
                        f"{path}: document is not a mapping "
                        f"({type(doc).__name__}) — not a k8s object")
                    continue
                kind = doc.get("kind")
                meta = doc.get("metadata") or {}
                if kind == "Pod":
                    check(meta.get("name", "pod"),
                          dict(meta.get("labels") or {}), path)
                    check_spec(meta.get("name", "pod"),
                               doc.get("spec") or {}, path)
                elif kind == "Deployment":
                    tmpl = (doc.get("spec") or {}).get("template") or {}
                    labels = dict((tmpl.get("metadata") or {}).get("labels")
                                  or {})
                    replicas = (doc.get("spec") or {}).get("replicas", 1)
                    check(meta.get("name", "deploy"), labels, path,
                          count=replicas)
                    check_spec(meta.get("name", "deploy"),
                               tmpl.get("spec") or {}, path)
                elif kind == "PodDisruptionBudget":
                    name = meta.get("name", "pdb")
                    pspec = doc.get("spec") or {}
                    if not isinstance(pspec, dict):
                        problems.append(f"{path}: {name}: spec is "
                                        f"{type(pspec).__name__}, not a mapping")
                        continue
                    for fld in ("minAvailable", "maxUnavailable"):
                        v = pspec.get(fld)
                        if v is None:
                            continue
                        ok_int = isinstance(v, int) and not isinstance(v, bool)
                        ok_pct = (isinstance(v, str) and v.endswith("%")
                                  and v[:-1].isdigit()
                                  and 0 <= int(v[:-1]) <= 100)
                        if not ok_int and not ok_pct:
                            problems.append(
                                f"{path}: {name}: {fld}={v!r} — must be an "
                                f"integer or a percentage string like "
                                f"\"50%\"; this budget protects nothing")
                    sel = pspec.get("selector")
                    if sel is None:
                        # policy/v1: selector {} selects ALL pods in the
                        # namespace (legal, no lint); a MISSING selector
                        # selects none
                        problems.append(
                            f"{path}: {name}: no selector — selects no pods")
                    elif isinstance(sel, dict):
                        for e in (sel.get("matchExpressions") or []):
                            op = (e or {}).get("operator", "") \
                                if isinstance(e, dict) else ""
                            if op not in ("In", "NotIn", "Exists",
                                          "DoesNotExist"):
                                problems.append(
                                    f"{path}: {name}: matchExpressions "
                                    f"operator {op!r} (must be In/NotIn/"
                                    f"Exists/DoesNotExist)")
    for gang, sizes in gang_sizes.items():
        if len(sizes) > 1:
            problems.append(
                f"gang {gang!r}: members disagree on tpu/gang-size {sorted(sizes)}")
        else:
            size = next(iter(sizes))
            n = gang_members.get(gang, 0)
            if n != size:
                problems.append(
                    f"gang {gang!r}: {n} member pods in these manifests but "
                    f"tpu/gang-size={size} (the gang would park at Permit "
                    f"until timeout)")
    for p in problems:
        print(f"ERROR: {p}")
    if not problems:
        print("OK: all manifests satisfy the label contract")
    return 1 if problems else 0


def cmd_serve(args) -> int:
    # the serve PROCESS pairs CPU-bound scheduling cycles with
    # latency-sensitive IO threads (watch reflectors): the default 5ms
    # GIL quantum lets one busy cycle delay every watch-event read by
    # multiple quanta. A 1ms quantum cut measured watch-ingest p99 from
    # ~108ms to ~86ms at 200 nodes/1000 pods (bench serve_scale) for
    # negligible switch overhead at this thread count. Process-scoped
    # on purpose — set here, not in the library serve loop, so embedding
    # callers (bench, tests) choose their own interpreter settings.
    # Knob (gilSwitchIntervalMs / YODA_GIL_SWITCH_MS): the quantum
    # matters less as the hot path moves into GIL-releasing kernels
    # (nativePlane scans, nativeCommit folds) — a cycle blocked in C
    # yields the lock regardless of the interval — so operators running
    # the native planes can raise it back toward the 5ms default and
    # shed the context-switch overhead; 0 leaves the interpreter alone.
    profiles = load_profiles(args.config)
    gil_ms = profiles[0][0].gil_switch_interval_ms
    if gil_ms > 0:
        sys.setswitchinterval(gil_ms / 1000.0)
    from .k8s.client import KubeClient, run_scheduler_against_cluster

    client = KubeClient.from_env(
        args.kubeconfig, args.apiserver,
        insecure_skip_tls_verify=args.insecure_skip_tls_verify)
    if client is None:
        log.error("no reachable Kubernetes API server; use `simulate` for "
                  "the in-memory cluster")
        return 2
    return run_scheduler_against_cluster(
        client, profiles, metrics_port=args.metrics_port,
        leader_elect=args.leader_elect)


def cmd_webhook(args) -> int:
    """Run the bind-authority admission webhook (k8s/webhook.py): the
    chip/fence half of the conflict battery as a pods/binding
    ValidatingAdmissionWebhook, deployed NEXT TO a vanilla apiserver
    (deploy/gpu-bind-authority-webhook.yaml). Its own process, not the
    scheduler's — the authority must survive scheduler restarts."""
    from .k8s.client import KubeClient
    from .k8s.webhook import serve_webhook
    from .scheduler.config import SchedulerConfig

    client = KubeClient.from_env(
        args.kubeconfig, args.apiserver,
        insecure_skip_tls_verify=args.insecure_skip_tls_verify)
    if client is None:
        log.error("no reachable Kubernetes API server to feed the claim "
                  "index from")
        return 2
    cfg = SchedulerConfig()
    if args.config:
        profiles = load_profiles(args.config)
        cfg = profiles[0][0]
    port = args.port if args.port is not None else (cfg.webhook_port or 8443)
    fail_open = cfg.webhook_fail_open or args.fail_open
    server = serve_webhook(
        client, port=port, certfile=args.tls_cert, keyfile=args.tls_key,
        fail_open=fail_open, stale_after_s=cfg.webhook_stale_after_s,
        host=args.host)
    try:
        import threading

        threading.Event().wait()  # serve until killed
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="yoda-tpu-scheduler")
    ap.add_argument("--v", type=int, default=1, help="log verbosity (klog-style)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sim = sub.add_parser("simulate", help="schedule manifests on a fake cluster")
    sim.add_argument("manifests", nargs="*", help="Pod/Deployment YAML files")
    sim.add_argument("--config", default=None)
    sim.add_argument("--tpu-slices", type=int, default=2,
                     help="multi-host v4-32 slices (3-D torus)")
    sim.add_argument("--v5e-slices", type=int, default=0,
                     help="multi-host 8x8 v5e slices (2-D torus)")
    sim.add_argument("--tpu-nodes", type=int, default=2)
    sim.add_argument("--gpu-nodes", type=int, default=2)
    sim.add_argument("--gpu-models", default="",
                     help="comma-separated GPU models of the catalog (topology/gpus.py), "
                          "e.g. h100-sxm5,a100-sxm4-80gb: each adds one InfiniBand "
                          f"fabric of {GPU_POOL_LEAVES} leaves x {GPU_POOL_LEAF_NODES} "
                          "catalogued 8-card nodes, the leaf as the node label "
                          "tpu/ib-leaf")
    sim.add_argument("--metrics-port", type=int, default=None)
    sim.add_argument("--max-cycles", type=int, default=10_000)
    sim.add_argument("--serve-forever", action="store_true")
    sim.set_defaults(fn=cmd_simulate)

    sn = sub.add_parser(
        "sniff", help="print this host's telemetry CR, or publish it to "
                      "the API server on an interval (--publish)")
    sn.add_argument("--node-name", default=None)
    sn.add_argument("--publish", action="store_true",
                    help="publish the CR to the API server instead of printing")
    sn.add_argument("--interval", type=float, default=5.0,
                    help="publish interval seconds (with --publish)")
    sn.add_argument("--once", action="store_true",
                    help="publish a single snapshot and exit (with --publish)")
    sn.add_argument("--fabric", default="",
                    help="the InfiniBand fabric this GPU host is on: published as "
                         "the node's slice, which gang pods are placed within")
    sn.add_argument("--fabric-hosts", type=int, default=1,
                    help="hosts on that fabric (with --fabric)")
    sn.add_argument("--kubeconfig", default=None)
    sn.add_argument("--apiserver", default=None)
    sn.add_argument("--insecure-skip-tls-verify", action="store_true",
                    help="skip API server certificate verification "
                         "(lab clusters with self-signed certs)")
    sn.set_defaults(fn=cmd_sniff)

    val = sub.add_parser(
        "validate", help="lint manifests against the scv/tpu label contract")
    val.add_argument("manifests", nargs="+", help="Pod/Deployment YAML files")
    val.set_defaults(fn=cmd_validate)

    srv = sub.add_parser("serve", help="run against a real API server")
    srv.add_argument("--config", default=None)
    srv.add_argument("--kubeconfig", default=None)
    srv.add_argument("--apiserver", default=None)
    srv.add_argument("--insecure-skip-tls-verify", action="store_true",
                    help="skip API server certificate verification "
                         "(lab clusters with self-signed certs)")
    srv.add_argument("--metrics-port", type=int, default=10251)
    srv.add_argument("--leader-elect", action="store_true")
    srv.set_defaults(fn=cmd_serve)

    wh = sub.add_parser(
        "webhook", help="run the pods/binding bind-authority admission "
                        "webhook (chip/fence conflict checks for vanilla "
                        "apiservers)")
    wh.add_argument("--config", default=None,
                    help="scheduler profile YAML (webhookPort/failOpen/"
                         "webhookStaleAfterSeconds knobs)")
    wh.add_argument("--port", type=int, default=None,
                    help="listen port (default: webhookPort knob, else "
                         "8443)")
    wh.add_argument("--host", default="0.0.0.0")
    wh.add_argument("--tls-cert", default=None,
                    help="PEM certificate (a ValidatingWebhookConfiguration "
                         "requires an https callee; omit only for local "
                         "testing)")
    wh.add_argument("--tls-key", default=None)
    wh.add_argument("--fail-open", action="store_true",
                    help="allow binds while the claim index is stale "
                         "(availability over safety; default fail-closed)")
    wh.add_argument("--kubeconfig", default=None)
    wh.add_argument("--apiserver", default=None)
    wh.add_argument("--insecure-skip-tls-verify", action="store_true")
    wh.set_defaults(fn=cmd_webhook)

    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.v >= 3 else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
