"""The steady-state serve tier at 50k nodes: open-loop seeded
Poisson arrivals held at equilibrium against the full shipped fleet
config (sharded reflectors + pipelined bind wire + intra-replica
scheduling heads), with latency measured AFTER warmup, at equilibrium —
the drain benches measure peak throughput with no sustained-latency
story; a server at equilibrium is a different regime. The port's twin of
the JAX package's tools/serve50k.py.

What the artifact (BENCH_SERVE50K.json) must show, honestly:

- the measured serve CEILING at 50k nodes (arrivals deliberately outrun
  the fleet; the backlog delta says it saturated), single-head and
  full-fleet, plus the bottleneck (named again in PERFORMANCE.md): the
  GIL serializes the pure-Python scoring path, which equilibrium churn
  (every bind/complete bumps the version vector and voids the score
  memos) keeps on the per-pod worst case;
- a TRUE equilibrium at 50k nodes at the arrival rate the process
  sustains: post-warmup e2e percentiles, zero backlog growth;
- the 80%-utilization SLO leg at the tier where arrival capacity and
  chip capacity meet, holding post-warmup p99 under the 1s target;
- the per-head scaling curve (1/2/4 heads) in BOTH wire regimes:
  synchronous binds (heads overlap wire RTTs — the regime heads exist
  for) and async pipelined binds (the wire never blocks, so the
  GIL-bound compute path gains nothing and conflicts cost a little) —
  reported as measured, not as hoped.

Every leg runs behind the leak fence: live threads
and the previous leg's cluster/fleet refcounts must return to baseline
before the next leg starts, or the run FAILS — a leaked completer or
RTT worker silently poisons every later leg's numbers.

Run:  python3 -m yoda_scheduler_tpu_torch.tools.serve50k                (full 50k tier)
      python3 -m yoda_scheduler_tpu_torch.tools.serve50k --smoke        (12.5k-node tier)
      python3 -m yoda_scheduler_tpu_torch.tools.serve50k --churn-fence  (churn-plane A/B
          fence only: adjacent ceiling legs at the smoke tier, exit 1 +
          flight dump on a missed fence)

Run it as a module (`-m`): the process-fleet legs spawn children, and each
imports the main module again, which the `__main__` guard below keeps
from starting the bench a second time.

Departures (bench.py's): the host's card is read through NVML and
recorded as `live_node` (the serve tiers run the JAX package's clusters;
`--cpu` reads no card; without NVML and without `--cpu` the run raises);
the native planes must build and load; the artifacts (BENCH_SERVE50K*.json,
CHURN_FENCE.json, churn_fence_flight.json) go to `chiprun_out/engine/` or
`--out DIR`, never the repository's root. The leak fence and the churn
fence still end the run with exit 1.
"""

from __future__ import annotations

import json
import os
import resource
import sys
import threading

from ..bench import (build_native_planes, engine_args, live_node, live_summary,
                     run_serve_procs, run_serve_steady, serve_leak_fence,
                     write_artifact)

TARGET_BINDS_PER_S = 10_000.0
SLO_P99_MS = 1000.0
NATIVE_SPEEDUP_TARGET = 1.3
CHURN_SPEEDUP_TARGET = 1.25

_BASE_THREADS = [1]       # set in main()/churn_fence() before the first leg
_FENCED_LEGS = [0]        # legs that passed the leak fence


def peak_rss_mb() -> float:
    """Peak RSS of this process (Linux ru_maxrss is in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _slim(r: dict) -> dict:
    keep = ("binds_per_s", "e2e_p50_ms", "e2e_p95_ms", "e2e_p99_ms",
            "backlog_end", "unbound_in_window", "utilization_measured",
            "bind_conflicts", "conflict_retries",
            "head_conflict_retry_rate", "per_head_binds_r0",
            "double_bound", "chip_double_booked", "nodes", "replicas",
            "schedule_heads", "arrival_per_s_target", "service_s",
            "pipeline_window", "reflector_sharding", "async_binding",
            "score_memo_hits", "score_memo_misses",
            "score_memo_hit_rate", "phase_breakdown",
            "fast_cycles", "fast_cycle_guard_misses",
            "fast_cycle_fallbacks", "requeue_events_dropped")
    return {k: r[k] for k in keep if k in r}


def _leg(fn, *a, **kw):
    """Run one serve leg, then hold it to the leak fence: threads and
    the leg's cluster/fleet refs must be back to baseline before the
    next leg. The fence RAISES (failing the whole run) on a leak."""
    r = fn(*a, **kw)
    # 20s grace: each gc.collect() poll over a 50k-node heap takes
    # seconds, and worker-head wind-down rides the same loaded core —
    # the loop exits early when clean, so the grace only costs time on
    # a slow teardown. A genuinely stranded thread still trips it.
    serve_leak_fence(_BASE_THREADS[0], grace_s=20.0)
    _FENCED_LEGS[0] += 1
    return r


def _with_env(env: dict, fn, *a, **kw):
    """Run one leg with scheduler knobs forced via the environment —
    knob defaults are read from the env at SchedulerConfig construction,
    so flipping the vars in-process is the whole switch (placements are
    bit-identical either way, pinned by tests/test_native_commit.py and
    tests/test_churn_plane.py; this measures only the speed)."""
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update({k: v for k, v in env.items()})
    try:
        return fn(*a, **kw)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _with_native_commit(flag: bool, fn, *a, **kw):
    """Back-compat shim over _with_env for the native-commit A/B."""
    return _with_env({"YODA_NATIVE_COMMIT": "1" if flag else "0"},
                     fn, *a, **kw)


def _ceiling_pair(units: int) -> tuple[dict, dict]:
    """The churn-plane A/B: ceiling_h1 with the native commit plane ON
    in both legs, churnPlane flipped between them, run ADJACENT (a ratio
    whose legs run many legs apart compares process states, not planes).
    Returns (off_leg, on_leg) FULL dicts (flight_tail included)."""
    common = dict(n_replicas=1, heads=1, units=units,
                  arrival_per_s=2000.0, warmup_s=3.0, measure_s=8.0,
                  utilization=0.8, seed=0)
    off = _leg(_with_env, {"YODA_NATIVE_COMMIT": "1",
                           "YODA_CHURN_PLANE": "0"},
               run_serve_steady, **common)
    on = _leg(_with_env, {"YODA_NATIVE_COMMIT": "1",
                          "YODA_CHURN_PLANE": "1"},
              run_serve_steady, **common)
    return off, on


def churn_fence(out_dir, live=None) -> int:
    """CI fence for the churn plane: THREE adjacent
    smoke-tier ceiling pairs, native commit on in every leg, churnPlane
    flipped within each pair (alternating, so drift hits both sides).
    The fence judges the RATIO OF MEDIANS — single pairs on a noisy
    runner swing +/-15-20%, well past the effect size; medians over
    three alternating pairs are the smallest protocol that measures the
    plane instead of the host — and requires ON >=
    CHURN_SPEEDUP_TARGET x OFF binds/s with ZERO double binds / chip
    double-bookings judged from the authority book on every leg. On
    failure the last pair's flight-recorder tails are dumped next to
    the verdict for the CI artifact, and the run returns 1."""
    _BASE_THREADS[0] = threading.active_count()
    _FENCED_LEGS[0] = 0
    units = 1563  # 12.5k-node smoke tier
    pairs = [_ceiling_pair(units) for _ in range(3)]
    off, on = pairs[-1]
    offs = sorted(p[0]["binds_per_s"] for p in pairs)
    ons = sorted(p[1]["binds_per_s"] for p in pairs)
    speedup = round(ons[1] / max(offs[1], 1e-9), 2)
    invariants_clean = all(
        leg["double_bound"] == 0 and leg["chip_double_booked"] == 0
        for pair in pairs for leg in pair)
    ok = speedup >= CHURN_SPEEDUP_TARGET and invariants_clean
    out = {
        "metric": "churn_fence",
        "nodes": units * 8,
        "off_binds_per_s": offs[1],
        "on_binds_per_s": ons[1],
        "pair_ratios": [round(p[1]["binds_per_s"]
                              / max(p[0]["binds_per_s"], 1e-9), 3)
                        for p in pairs],
        "speedup": speedup,
        "target": CHURN_SPEEDUP_TARGET,
        "protocol": "median of 3 alternating adjacent pairs",
        "invariants_clean": invariants_clean,
        "fast_cycles": on["fast_cycles"],
        "fast_cycle_guard_misses": on["fast_cycle_guard_misses"],
        "fast_cycle_fallbacks": on["fast_cycle_fallbacks"],
        "requeue_events_dropped": on["requeue_events_dropped"],
        "phase_breakdown_on": on["phase_breakdown"],
        "phase_breakdown_off": off["phase_breakdown"],
        "legs_fenced": _FENCED_LEGS[0],
        "live_node": live_summary(live),
        "ok": ok,
    }
    write_artifact(out_dir, "CHURN_FENCE.json", out)
    print(json.dumps(out))
    if not ok:
        # flight-dump artifact: the last engine events of both legs —
        # guard-miss reasons, conflict fallbacks, breaker flips — are
        # the first thing to read on a missed fence
        write_artifact(out_dir, "churn_fence_flight.json",
                       {"off": off.get("flight_tail", []),
                        "on": on.get("flight_tail", [])})
        return 1
    return 0


def run(smoke: bool, live=None) -> dict:
    """The artifact: the ceiling, native-commit and churn legs, the
    equilibrium and 80%-utilization legs, the head-scaling curve in both
    wire regimes and the process fleet, each leg behind the leak fence."""
    units = 1563 if smoke else 6250          # 12_504 / 50_000 nodes
    _BASE_THREADS[0] = threading.active_count()
    _FENCED_LEGS[0] = 0
    legs: dict = {}

    # --- ceiling probes: arrivals outrun the fleet on purpose ---------
    legs["ceiling_h1"] = _slim(_leg(
        run_serve_steady,
        n_replicas=1, heads=1, units=units, arrival_per_s=2000.0,
        warmup_s=3.0, measure_s=8.0, utilization=0.8, seed=0))
    # --- native commit plane attribution -------------------
    # same probe with the GIL-releasing commit kernels ON: single
    # process, single head, so the delta is pure per-pod hot-path CPU
    # (topology packing/blend + pre-score patch + commit bookkeeping
    # moved into native code), not parallelism. Measured ADJACENT to
    # ceiling_h1 — a ratio whose two legs run many legs apart compares
    # process states, not planes (an earlier cut of this script ran the
    # native leg ~15 legs in and read 0.12x; the same pair adjacent in
    # a fresh process reads >1x)
    from ..scheduler.nativeplane import CommitKernels, EventKernels
    legs["ceiling_h1_native_commit"] = _slim(_leg(
        _with_native_commit, True, run_serve_steady,
        n_replicas=1, heads=1, units=units, arrival_per_s=2000.0,
        warmup_s=3.0, measure_s=8.0, utilization=0.8, seed=0))
    native_speedup = round(
        legs["ceiling_h1_native_commit"]["binds_per_s"]
        / max(legs["ceiling_h1"]["binds_per_s"], 1e-9), 2)
    # --- churn plane attribution ---------------------------
    # the same probe again with churnPlane ON on top of the commit
    # plane: batched event application + the fast-cycle continuation.
    # Measured ADJACENT to the native-commit leg (same knobs otherwise,
    # same seed), so the ratio is the churn plane alone.
    legs["ceiling_h1_churn"] = _slim(_leg(
        _with_env, {"YODA_NATIVE_COMMIT": "1", "YODA_CHURN_PLANE": "1"},
        run_serve_steady,
        n_replicas=1, heads=1, units=units, arrival_per_s=2000.0,
        warmup_s=3.0, measure_s=8.0, utilization=0.8, seed=0))
    churn_speedup = round(
        legs["ceiling_h1_churn"]["binds_per_s"]
        / max(legs["ceiling_h1_native_commit"]["binds_per_s"], 1e-9), 2)
    legs["ceiling_fleet_r4"] = _slim(_leg(
        run_serve_steady,
        n_replicas=4, heads=1, units=units, arrival_per_s=2000.0,
        warmup_s=3.0, measure_s=8.0, utilization=0.8, seed=0))
    legs["ceiling_fleet_r4h4"] = _slim(_leg(
        run_serve_steady,
        n_replicas=4, heads=4, units=units, arrival_per_s=2000.0,
        warmup_s=3.0, measure_s=8.0, utilization=0.8, seed=0))
    ceiling = max(legs["ceiling_h1"]["binds_per_s"],
                  legs["ceiling_fleet_r4"]["binds_per_s"],
                  legs["ceiling_fleet_r4h4"]["binds_per_s"])

    # --- true equilibrium at the big tier -----------------------------
    # arrival at ~35% of the measured ceiling: the ceiling probe's long
    # service time sees little completion churn, while equilibrium's 4s
    # service voids the score memos every window (measured: the
    # churn-limited sustained rate is ~45% of the probe ceiling), so
    # the honest equilibrium arrival sits under THAT — the utilization
    # knob is service_s * arrival / chips, a small slice of 150k chips,
    # which is exactly the story the ceiling legs tell
    eq_arrival = max(50.0, round(0.35 * ceiling, 0))
    chips_total = units * 24
    legs["equilibrium_50k"] = _slim(_leg(
        run_serve_steady,
        n_replicas=1, heads=1, units=units, arrival_per_s=eq_arrival,
        warmup_s=4.0, measure_s=12.0,
        utilization=4.0 * eq_arrival / chips_total, seed=1))

    # --- 80%-utilization SLO leg --------------------------------------
    # the tier where arrival capacity meets chip capacity: 240 chips at
    # 300 pods/s with ~0.64s service holds measured utilization ~0.8
    # and must keep post-warmup p99 under the 1s SLO
    legs["equilibrium_80util"] = _slim(_leg(
        run_serve_steady,
        n_replicas=2, heads=2, units=30, arrival_per_s=300.0,
        warmup_s=3.0, measure_s=8.0, utilization=0.8,
        wire_pace_ms=2.0, seed=2))

    # --- per-head scaling curve, both wire regimes --------------------
    curve: dict = {"sync_wire": {}, "async_pipelined": {}}
    for h in (1, 2, 4):
        # synchronous binds: every cycle blocks a full 4ms RTT — the
        # regime parallel heads exist for (overlapped wire waits)
        curve["sync_wire"][f"h{h}"] = _slim(_leg(
            run_serve_steady,
            n_replicas=1, heads=h, units=30, arrival_per_s=600.0,
            warmup_s=2.0, measure_s=6.0, utilization=0.6,
            wire_pace_ms=4.0, pipeline_window=0, reflector_sharding=False,
            head_dispatch_depth=0, async_binding=False, seed=7))
        # async pipelined binds at the CPU-bound tier: the wire never
        # blocks, the GIL serializes scoring, so extra heads only add
        # contention — measured and reported as-is
        curve["async_pipelined"][f"h{h}"] = _slim(_leg(
            run_serve_steady,
            n_replicas=1, heads=h, units=units if smoke else 1563,
            arrival_per_s=1200.0, warmup_s=2.0, measure_s=6.0,
            utilization=0.8, seed=7))

    # --- process-fleet scaling curve -----------------------
    # real OS processes against the wire apiserver, shared-nothing. A
    # fixed mid tier, NOT the 50k tier: every child re-syncs the whole
    # node set over HTTP at startup, so at 50k nodes the leg would
    # measure watch sync, not scheduling. host_cpus is committed next
    # to the curve — on a single-core host the honest curve is flat
    # (process overhead, no parallelism to harvest), and the
    # correctness half (zero double binds from the authority book)
    # is the part that must hold everywhere.
    # sized under capacity (24 tpu chips/unit; pods average 1.5 chips)
    # so every leg drains fully instead of tripping the stall detector
    # on a fragmentation-stranded tail
    proc_units = 40 if smoke else 150
    proc_pods = 500 if smoke else 1800
    proc_grid = (1, 2) if smoke else (1, 2, 4, 8)
    procs_curve: dict = {}
    for np_ in proc_grid:
        for h in (1, 2):
            procs_curve[f"p{np_}h{h}"] = _leg(
                run_serve_procs,
                procs=np_, heads=h, units=proc_units, n_pods=proc_pods)
    proc_rates = [r["binds_per_s_window"] or r["binds_per_s"]
                  for r in procs_curve.values()]
    proc_invariants_clean = all(
        r["double_bound"] == 0 and r["chip_double_booked"] == 0
        for r in procs_curve.values())

    s1 = curve["sync_wire"]
    headline = legs["equilibrium_80util"]
    out = {
        "metric": "serve50k_steady",
        "smoke": smoke,
        "nodes": units * 8,
        "chips": chips_total,
        "measured_ceiling_binds_per_s": ceiling,
        "target_binds_per_s": TARGET_BINDS_PER_S,
        "target_met": ceiling >= TARGET_BINDS_PER_S,
        "bottleneck": (
            "GIL-serialized Python scoring under equilibrium churn: "
            "~1-3ms CPU per pod at this node count (topology pre_score "
            "+ batch fold dominate), and every bind/complete bumps the "
            "version vector so score memos cannot hold at equilibrium. "
            "Parallel heads and replicas share the one interpreter "
            "lock, so the async-pipelined ceiling is a single head's; "
            "heads pay off when cycles BLOCK on the wire (sync "
            "fencing postures) — see head_scaling.sync_wire."),
        "slo_80util_p99_ms": headline["e2e_p99_ms"],
        "slo_80util_met": (headline["e2e_p99_ms"] is not None
                           and headline["e2e_p99_ms"] < SLO_P99_MS),
        "head_speedup_sync_wire_h4_vs_h1": round(
            s1["h4"]["binds_per_s"] / max(s1["h1"]["binds_per_s"], 1e-9),
            2),
        "native_commit": {
            "kernels_loaded": CommitKernels.load() is not None,
            "speedup_vs_python_h1": native_speedup,
            "target": NATIVE_SPEEDUP_TARGET,
            "target_met": native_speedup >= NATIVE_SPEEDUP_TARGET,
            "attribution": (
                "single process, single head, same seed/tier as "
                "ceiling_h1 — the delta is per-pod hot-path CPU moved "
                "into GIL-releasing kernels (placements bit-identical; "
                "tests/test_native_commit.py)"),
        },
        "churn_plane": {
            "kernels_loaded": EventKernels.load() is not None,
            "speedup_vs_off_h1": churn_speedup,
            "target": CHURN_SPEEDUP_TARGET,
            "target_met": churn_speedup >= CHURN_SPEEDUP_TARGET,
            "attribution": (
                "adjacent ceiling_h1 legs, native commit ON in both, "
                "churnPlane flipped: batched event application (inbox "
                "drain + one eventplane call per dirty batch + wake "
                "coalescing) plus the fast-cycle continuation that "
                "skips the ordinary head cycle at memo-hit equilibrium "
                "(placements bit-identical; tests/test_churn_plane.py). "
                "Guard misses fall back to the ordinary cycle — see "
                "legs.ceiling_h1_churn.fast_cycle_guard_misses."),
        },
        "process_fleet": {
            "host_cpus": os.cpu_count(),
            "curve": procs_curve,
            "aggregate_ceiling_binds_per_s": max(proc_rates),
            "invariants_clean": proc_invariants_clean,
            "attribution": (
                "OS processes vs the wire apiserver at a fixed "
                f"{proc_units * 8}-node tier (the 50k tier would "
                "measure per-child watch sync, not scheduling). On a "
                "multi-core host the curve shows off-GIL scaling; on "
                "host_cpus=1 it shows process overhead only — the "
                "correctness half (zero double binds / chip "
                "double-bookings judged from the authority book) must "
                "hold regardless, and invariants_clean says it did."),
        },
        "leak_fence": {
            "legs_fenced": _FENCED_LEGS[0],
            "thread_baseline": _BASE_THREADS[0],
            "note": ("every leg above passed serve_leak_fence: threads "
                     "and leg cluster/fleet refs back to baseline "
                     "before the next leg (a trip raises and fails "
                     "the run)"),
        },
        "legs": legs,
        "head_scaling": curve,
        "peak_rss_mb": round(peak_rss_mb(), 1),
        "live_node": live_summary(live),
    }
    return out


def main(argv=None) -> int:
    ap = engine_args("the steady-state serve tier (the port's engine)")
    ap.add_argument("--smoke", action="store_true", help="the 12,504-node tier")
    ap.add_argument("--churn-fence", action="store_true",
                    help="only the churn-plane A/B fence at the smoke tier")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    live = live_node(args.cpu)
    build_native_planes()
    if args.churn_fence:
        return churn_fence(args.out, live)
    out = run(args.smoke, live)
    name = "BENCH_SERVE50K_SMOKE.json" if args.smoke else "BENCH_SERVE50K.json"
    write_artifact(args.out, name, out)
    print(json.dumps({k: out[k] for k in (
        "metric", "nodes", "measured_ceiling_binds_per_s", "target_met",
        "slo_80util_p99_ms", "slo_80util_met",
        "head_speedup_sync_wire_h4_vs_h1", "peak_rss_mb")}
        | {"native_commit_speedup":
           out["native_commit"]["speedup_vs_python_h1"],
           "churn_plane_speedup":
           out["churn_plane"]["speedup_vs_off_h1"],
           "proc_fleet_ceiling":
           out["process_fleet"]["aggregate_ceiling_binds_per_s"],
           "proc_invariants_clean":
           out["process_fleet"]["invariants_clean"],
           "legs_fenced": out["leak_fence"]["legs_fenced"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
