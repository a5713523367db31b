"""The port's copy of the scheduling engine places exactly as the JAX
package's: the same seeded trace, each package's own modules, the same
binds (pod, node, assigned chips) in the same order and the same pods left
unschedulable. The two packages share nothing at run time (each has its
own module globals), so each case builds its cluster and pods twice."""

import contextlib
import importlib
import io
import json
import random
import threading
import time
from pathlib import Path

import pytest

from fake_apiserver import FakeApiServer

PKGS = ("yoda_scheduler_tpu", "yoda_scheduler_tpu_torch")
REPO = Path(__file__).resolve().parent.parent
NEVER_STALE = 1e18  # virtual clocks: telemetry never ages out


class Pkg:
    """One package's modules, by their names in either package."""

    def __init__(self, name: str) -> None:
        self.name = name
        imp = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
        self.scheduler = imp("scheduler")
        self.core = imp("scheduler.core")
        self.telemetry = imp("telemetry")
        self.utils = imp("utils")
        self.chaos = imp("chaos")
        self.capacity = imp("scheduler.capacity")
        self.refem = imp("scheduler.plugins.reference_emulation")
        self.cli = imp("cli")
        self.k8s = imp("k8s.client")

    def pods(self, specs):
        return [self.utils.Pod(name, labels=dict(labels)) for name, labels in specs]


def record(cluster, log: list) -> None:
    """Append each bind (pod, node, assigned chips) and each eviction to
    `log` in the order the cluster takes them; a bind that raises is
    logged with the error's class name and re-raised."""
    bind, evict = cluster.bind, cluster.evict

    def logged_bind(pod, node, *args, **kw):
        try:
            bind(pod, node, *args, **kw)
        except Exception as e:
            log.append(("bind_error", pod.name, node, type(e).__name__))
            raise
        log.append(("bind", pod.name, node, tuple(pod.assigned_chips())))

    def logged_evict(pod):
        evict(pod)
        log.append(("evict", pod.name))

    cluster.bind, cluster.evict = logged_bind, logged_evict


def store_of(P, nodes, heartbeat):
    store = P.telemetry.TelemetryStore()
    for m in nodes:
        m.heartbeat = heartbeat
        store.put(m)
    return store


def fake_cluster(P, nodes, heartbeat=1000.0, cls=None, **kw):
    cluster = (cls or P.scheduler.FakeCluster)(store_of(P, nodes, heartbeat), **kw)
    cluster.add_nodes_from_telemetry()
    return cluster


def end_state(pods):
    """(each pod's name, phase, node, chips), the names left unbound."""
    return ([(p.name, p.phase.value, p.node, tuple(p.assigned_chips())) for p in pods],
            [p.name for p in pods if p.phase.value != "Bound"])


def mixed_nodes(P):
    t = P.telemetry
    return (t.make_v4_slice("s0", "2x2x4") + t.make_v4_slice("s1", "2x2x2")
            + [t.make_tpu_node(f"t{i}", chips=4) for i in range(3)]
            + [t.make_tpu_node("e0", chips=8, generation="v5e")]
            + [t.make_gpu_node(f"g{i}", cards=4) for i in range(2)])


def mixed_specs(seed: int, n: int = 48):
    """Seeded pod labels: single-chip and multi-chip TPU pods, GPU pods,
    plain pods, priorities, memory floors and two gangs."""
    rng = random.Random(seed)
    specs = []
    for i in range(n):
        r = rng.random()
        if r < 0.45:
            labels = {"tpu/accelerator": "tpu", "scv/number": str(rng.choice((1, 1, 2, 4)))}
        elif r < 0.6:
            labels = {"tpu/accelerator": "gpu", "scv/number": str(rng.choice((1, 2))),
                      "scv/memory": str(rng.choice((10000, 30000, 50000)))}
        else:
            labels = {"scv/memory": str(rng.randrange(0, 16000, 2000))}
        if rng.random() < 0.3:
            labels["scv/priority"] = str(rng.choice((0, 5, 10)))
        specs.append((f"p{i}", labels))
    for g, size in (("ga", 4), ("gb", 2)):
        specs += [(f"{g}-w{i}", {"tpu/gang-name": g, "tpu/gang-size": str(size),
                                 "scv/number": "4"}) for i in range(size)]
    rng.shuffle(specs)
    return specs


def drive(sched, clock, rounds: int, tick: float, refresh: bool = False):
    """Run every cycle that is ready, then advance the virtual clock."""
    for _ in range(rounds):
        if refresh:
            for m in sched.cluster.telemetry.list():
                m.heartbeat = clock.time()
        while sched.run_one() is not None:
            pass
        clock.advance(tick)


# ------------------------------------------------------------------ scenarios
def case_default(P):
    clock = P.core.FakeClock(start=1000.0)
    cluster = fake_cluster(P, mixed_nodes(P))
    log = []
    record(cluster, log)
    sched = P.scheduler.Scheduler(cluster, P.scheduler.SchedulerConfig(
        telemetry_max_age_s=NEVER_STALE, max_attempts=4), clock=clock)
    pods = P.pods(mixed_specs(1))
    for p in pods:
        sched.submit(p)
    sched.run_until_idle(max_cycles=5000)
    return log, end_state(pods)


def case_reference_emulation(P):
    clock = P.core.FakeClock(start=1000.0)
    cluster = fake_cluster(P, mixed_nodes(P))
    log = []
    record(cluster, log)
    config = P.scheduler.SchedulerConfig(telemetry_max_age_s=NEVER_STALE, max_attempts=4)
    sched = P.scheduler.Scheduler(P.refem.TelemetryDecrementingCluster(cluster), config,
                                  profile=P.refem.reference_profile(config), clock=clock)
    pods = P.pods([(n, lab) for n, lab in mixed_specs(2) if "tpu/gang-name" not in lab])
    for p in pods:
        sched.submit(p)
    sched.run_until_idle(max_cycles=5000)
    return log, end_state(pods)


def case_policy_drf(P):
    """Heterogeneity (makespan over v4 and v5e) and DRF tenants with
    quotas, oversubscribed so the quota gate and the fairness sort bite."""
    t = P.telemetry
    nodes = ([t.make_tpu_node(f"v4-{i}", chips=4) for i in range(4)]
             + [t.make_tpu_node(f"v5e-{i}", chips=8, generation="v5e") for i in range(2)])
    clock = P.core.FakeClock(start=1000.0)
    cluster = fake_cluster(P, nodes)
    log = []
    record(cluster, log)
    config = P.scheduler.SchedulerConfig(
        max_attempts=6, telemetry_max_age_s=NEVER_STALE, policy_objective="makespan",
        workload_classes=(("light", (("v4", 0.9), ("v5e", 2.0))),
                          ("mem-heavy", (("v4", 1.0),))),
        drf_fairness=True, tenant_quotas=(("a", 0.6, 2), ("b", 0.4, 1)),
        starvation_after_s=3600.0, rng_seed=3)
    sched = P.scheduler.Scheduler(cluster, config, clock=clock)
    rng = random.Random(3)
    specs = []
    for i in range(44):
        kind = rng.choice(("light", "mem-heavy"))
        specs.append((f"f{i}", {"scv/number": "1", "tpu/accelerator": "tpu",
                                "scv/memory": "20000" if kind == "mem-heavy" else "1000",
                                "scv/class": kind, "scv/tenant": rng.choice("ab")}))
    pods = P.pods(specs)
    for p in pods:
        sched.submit(p)
    sched.run_until_idle(max_cycles=5000)
    return log, end_state(pods)


def case_elastic_defrag(P):
    """An elastic gang admitted at its minimum on a half-held slice, then
    the defrag controller moving a stray single off another slice so that
    a whole gang fits there."""
    t = P.telemetry
    nodes = (t.make_v4_slice("s", "2x2x2") + t.make_v4_slice("w", "2x2x4")
             + [t.make_tpu_node("lone", chips=4)])
    clock = P.core.FakeClock(start=1000.0)
    cluster = fake_cluster(P, nodes)
    log = []
    record(cluster, log)
    sched = P.scheduler.Scheduler(cluster, P.scheduler.SchedulerConfig(
        elastic_gangs=True, defrag_interval_s=5.0, defrag_cooldown_s=60.0,
        gang_timeout_s=30.0), clock=clock)
    held = P.pods([("stray", {"scv/number": "1", "tpu/accelerator": "tpu"})]
                  + [(f"b{i}", {"scv/number": "4", "tpu/accelerator": "tpu"})
                     for i in range(2)])
    cluster.bind(held[0], "s-host-0", [(0, 0, 0)])
    for i, b in enumerate(held[1:]):
        cluster.bind(b, f"w-host-{i}", [(0, 0, i), (1, 0, i), (0, 1, i), (1, 1, i)])
    elastic = P.pods([(f"e-w{i}", {"tpu/gang-name": "e", "tpu/gang-size": "4",
                                   "tpu/gang-min": "2", "scv/number": "4"})
                      for i in range(4)])
    whole = P.pods([(f"g-w{i}", {"tpu/gang-name": "g", "tpu/gang-size": "2",
                                 "scv/number": "4"}) for i in range(2)])
    for p in elastic:
        sched.submit(p)
    drive(sched, clock, 6, 0.5, refresh=True)
    for p in whole:
        sched.submit(p)
    drive(sched, clock, 40, 1.0, refresh=True)
    return log, end_state(held + elastic + whole)


def case_churn_plane(P):
    """churnPlane on, with membership and telemetry churn mid-run."""
    t = P.telemetry
    clock = P.core.FakeClock(start=1000.0)
    cluster = fake_cluster(P, mixed_nodes(P))
    log = []
    record(cluster, log)
    sched = P.scheduler.Scheduler(cluster, P.scheduler.SchedulerConfig(
        churn_plane=True, telemetry_max_age_s=NEVER_STALE, max_attempts=4), clock=clock)
    specs = mixed_specs(4, n=60)
    pods = P.pods(specs)
    for p in pods[:30]:
        sched.submit(p)
    for _ in range(12):
        sched.run_one()
    cluster.remove_node("t2")
    extra = t.make_tpu_node("t9", chips=4)
    extra.heartbeat = 1000.0
    cluster.telemetry.put(extra)
    cluster.add_node("t9")
    shrunk = t.make_gpu_node("g1", cards=4, mem_free_mb=20_000)
    shrunk.heartbeat = 1000.0
    cluster.telemetry.put(shrunk)
    for p in pods[30:]:
        sched.submit(p)
    sched.run_until_idle(max_cycles=5000)
    return log, end_state(pods)


def case_workload_admission(P):
    """Workload CRs admitted, parked for capacity and materialized."""
    t = P.telemetry
    workload = importlib.import_module(f"{P.name}.scheduler.workload")
    nodes = [t.make_tpu_node(f"t{i}", chips=4) for i in range(2)] + t.make_v4_slice("s0",
                                                                                    "2x2x2")
    clock = P.core.FakeClock(start=1000.0)
    cluster = fake_cluster(P, nodes)
    log = []
    record(cluster, log)
    sched = P.scheduler.Scheduler(cluster, P.scheduler.SchedulerConfig(
        workload_admission=True, telemetry_max_age_s=NEVER_STALE, max_attempts=0,
        gang_timeout_s=1e6), clock=clock)
    wls = [workload.Workload("a", members=1, replicas=5, labels={"scv/number": "1"}),
           workload.Workload("j", members=2, replicas=1, labels={"scv/number": "4"}),
           workload.Workload("big", members=1, replicas=4, labels={"scv/number": "4"})]
    for w in wls:
        assert sched.submit_workload(w)
    sched.run_until_idle(max_cycles=2000)
    return log, ([(w.name, w.state) for w in wls],
                 sorted((p.name, p.node, tuple(p.assigned_chips()))
                        for p in cluster.all_pods()))


def case_capacity(P):
    """The provisioner scales a simulated pool up for demand that cannot
    fit, and pods bind on the nodes it adds."""
    cap = P.capacity
    clock = P.core.FakeClock(start=0.0)
    cluster = fake_cluster(P, [P.telemetry.make_tpu_node("t0", chips=4)], heartbeat=0.0)
    log = []
    record(cluster, log)
    sched = P.scheduler.Scheduler(cluster, P.scheduler.SchedulerConfig(
        telemetry_max_age_s=1e9, provisioner_interval_s=0.5, scale_down_cooldown_s=3.0,
        provisioner_hysteresis_s=2.0, provisioner_backoff_s=0.5,
        provisioner_backoff_max_s=4.0, provision_timeout_s=6.0), clock=clock)
    provider = P.chaos.SimulatedProvider(
        cap.FakeBackend(cluster, orphan_router=sched.submit), clock=clock, seed=5,
        latency_s=(0.2, 1.0))
    sched.provisioner.attach_provider(provider)
    sched.provisioner.add_pool(cap.NodeTemplate(pool="vp", chips=4, max_nodes=4))
    pods = P.pods([(f"p{i}", {"scv/number": str(1 + i % 3), "tpu/accelerator": "tpu"})
                   for i in range(10)])
    for p in pods:
        sched.submit(p)
    while clock.time() < 60.0 and not all(p.phase.value == "Bound" for p in pods):
        if sched.run_one() is not None:
            clock.advance(0.05)
            continue
        wake = sched.next_wake_at()
        clock.advance(0.5 if wake is None else max(wake - clock.time(), 0.05))
    return log, (end_state(pods), sorted(cluster.node_names()))


def case_chaos_bind_faults(P):
    """Scripted bind faults: storms (no status: the engine reaches
    `k8s.client.is_webhook_denial`) and lost responses."""
    ch = P.chaos
    clock = P.core.FakeClock(start=1000.0)
    script = {1: ch.APISERVER_STORM, 4: ch.BIND_LOST, 6: ch.APISERVER_STORM,
              9: ch.BIND_LOST}
    cluster = fake_cluster(P, mixed_nodes(P), cls=ch.ChaosCluster, clock=clock,
                           bind_script=script)
    log = []
    record(cluster, log)
    sched = P.scheduler.Scheduler(cluster, P.scheduler.SchedulerConfig(
        telemetry_max_age_s=NEVER_STALE, breaker_threshold=0, gang_timeout_s=1.0),
        clock=clock)
    pods = P.pods(mixed_specs(5, n=24))
    for p in pods:
        sched.submit(p)
    sched.run_until_idle(max_cycles=5000)
    counters = {k: sched.metrics.counters.get(k, 0)
                for k in ("bind_errors_total", "ambiguous_bind_recoveries_total")}
    return log, (end_state(pods), counters, dict(cluster.injected))


CASES = {"default": case_default, "reference_emulation": case_reference_emulation,
         "policy_heterogeneity_drf": case_policy_drf, "elastic_defrag": case_elastic_defrag,
         "churn_plane": case_churn_plane, "workload_admission": case_workload_admission,
         "capacity_provisioner": case_capacity, "chaos_bind_faults": case_chaos_bind_faults}


@pytest.mark.parametrize("case", list(CASES))
def test_engines_place_alike(case):
    jax_log, jax_end = CASES[case](Pkg(PKGS[0]))
    port_log, port_end = CASES[case](Pkg(PKGS[1]))
    assert any(e[0] == "bind" for e in jax_log), "the trace bound nothing"
    assert port_log == jax_log
    assert port_end == jax_end


def test_chaos_case_reaches_the_k8s_import():
    """The scripted storms raise without a status: the engine's
    `_is_authority_conflict` imports the copy's own `k8s.client`."""
    _, (_, counters, injected) = case_chaos_bind_faults(Pkg(PKGS[1]))
    assert counters["bind_errors_total"] >= 2
    assert injected.get("ApiServerStorm") == 2 and injected.get("BindLost") == 2


def simulate(P, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = P.cli.main(["simulate", *argv])
    return rc, json.loads(out.getvalue())


def test_cli_simulate_places_alike():
    """`cli simulate` over every example manifest: the same pod table."""
    manifests = sorted(str(p) for p in (REPO / "example").glob("*.yaml"))
    runs = [simulate(Pkg(name), *manifests, "--v5e-slices", "1") for name in PKGS]
    (rc_jax, jax_out), (rc_port, port_out) = runs
    assert rc_port == rc_jax
    assert port_out["pods"] == jax_out["pods"]
    assert port_out["bound"] == jax_out["bound"] > 0


def serve_and_place(P, nodes, pods, timeout=20.0):
    """Each package's KubeClient and serve loop against a fresh fake API
    server holding the same nodes, CRs and pending pods: the server's
    pod -> (node, chips) book once every pod is bound."""
    with FakeApiServer() as api:
        for m in nodes:
            api.state.add_node(m.node)
            api.state.put_metrics(m.to_cr())
        for name, labels in pods:
            api.state.add_pod({
                "metadata": {"name": name, "namespace": "default", "labels": labels},
                "spec": {"schedulerName": "yoda-scheduler"},
                "status": {"phase": "Pending"}})
        stop = threading.Event()
        client = P.k8s.KubeClient(api.url)
        t = threading.Thread(target=P.k8s.run_scheduler_against_cluster, args=(
            client, [(P.scheduler.SchedulerConfig(telemetry_max_age_s=NEVER_STALE), None)]),
            kwargs={"metrics_port": None, "poll_s": 0.05, "stop_event": stop}, daemon=True)
        t.start()
        try:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with api.state.cond:
                    book = {k: v for k, v in api.state.objects["pods"].items()}
                    placed = {k: (v.get("spec", {}).get("nodeName"),
                                  v["metadata"].get("annotations", {}).get(
                                      "tpu/assigned-chips"))
                              for k, v in book.items()}
                if all(node for node, _ in placed.values()):
                    return placed
                time.sleep(0.05)
            raise AssertionError(f"{P.name}: not every pod bound: {placed}")
        finally:
            stop.set()
            t.join(timeout=10.0)
            assert not t.is_alive()


def test_serve_loop_over_the_wire_places_alike():
    nodes_of = lambda P: [P.telemetry.make_tpu_node(f"n{i}", chips=4)  # noqa: E731
                          for i in range(3)]
    pods = [(f"w{i}", {"scv/number": str(1 + i % 2), "tpu/accelerator": "tpu"})
            for i in range(6)]
    books = []
    for name in PKGS:
        P = Pkg(name)
        nodes = nodes_of(P)
        for m in nodes:
            m.heartbeat = time.time()
        books.append(serve_and_place(P, nodes, pods))
    assert books[1] == books[0]
