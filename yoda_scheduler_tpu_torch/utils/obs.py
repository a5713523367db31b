"""Observability: lifecycle spans, labeled metrics, traces, flight recorder.

The reference has none of it (metrics explicitly disabled at reference
pkg/yoda/scheduler.go:55, tracing = leveled klog strings only; SURVEY §5).
Four layers live here:

- ``CycleTrace`` / ``TraceLog``: one structured record per scheduling cycle
  (pod, filter verdicts, scores, outcome, latency) in a bounded ring.
- ``SpanRing``: span-structured lifecycle tracing — every sampled pod gets
  a span tree from intake to confirmed bind (``queued`` with backoff
  segments, ``cycle`` with per-extension-point children and plane
  attribution, ``bind_wire``, ``watch_confirm``), recorded as flat tuples
  on the engine's injectable clock and exportable as Chrome/Perfetto
  trace-event JSON (``/traces/export``, ``bench.py --trace-out``).
- ``Metrics``: counters/gauges/histograms, now with a label dimension
  (``plugin``, ``outcome``, ``plane``, ``replica``, ``shard``), # HELP
  lines, label-value escaping, and +Inf buckets per the Prometheus text
  exposition spec (round-tripped through prometheus_client's parser in
  tests/test_obs.py).
- ``FlightRecorder``: a black-box bounded ring of structured engine events
  (breaker transitions, degraded-mode flips, quarantines, fence aborts,
  conflict fallbacks) that dumps to disk when a chaos invariant trips or
  the circuit breaker opens.

Everything here must be cheap enough to leave on: span/flight appends are
one tuple into a GIL-atomic bounded deque, and the hot-path metric calls
allocate nothing beyond the record itself.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass, field


@dataclass
class CycleTrace:
    pod: str
    outcome: str = "unknown"        # bound | unschedulable | waiting | error | failed
    node: str | None = None
    reason: str = ""
    filter_verdicts: dict[str, str] = field(default_factory=dict)
    scores: dict[str, float] = field(default_factory=dict)
    # which data plane served the cycle's scan: scalar | numpy | native |
    # memo (class-memo hit/repair, no full scan) | "" (cycle never reached
    # the filter step)
    plane: str = ""
    # stamped by the OWNING engine from ITS clock — no wall-clock default:
    # chaos runs drive the engine on a virtual clock, and a time.time()
    # fallback here silently mixed wall and simulated time in latencies
    started: float = 0.0
    latency_ms: float = 0.0

    def finish(self, outcome: str, node: str | None = None, reason: str = "",
               *, now: float) -> "CycleTrace":
        """`now` is REQUIRED and must come from the same clock that stamped
        `started` (the scheduler's injectable clock) — a wall-time default
        here used to mix real and simulated time in chaos-run latencies."""
        self.outcome = outcome
        self.node = node
        self.reason = reason
        self.latency_ms = (now - self.started) * 1e3
        return self


class Histogram:
    DEFAULT_BOUNDS = (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000)

    # deterministic xorshift64* state seed for the reservoir: quantiles
    # of a given observation stream reproduce run-to-run (benches and
    # the golden test depend on that)
    _SEED = 0x9E3779B97F4A7C15
    _M64 = (1 << 64) - 1

    def __init__(self, bounds: tuple[float, ...] = DEFAULT_BOUNDS,
                 keep_values: int = 100_000) -> None:
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)
        self.total = 0.0
        self.n = 0
        # bounded raw-sample store for exact-ish quantiles in benches.
        # The first `keep_values` observations are kept exactly; past
        # that the store becomes a FIXED-SIZE uniform reservoir over the
        # whole stream (Algorithm R, deterministic xorshift indices) —
        # a 1M-pod drain costs O(keep_values) per family, not O(pods),
        # and quantiles stay representative of the ENTIRE run instead of
        # a sliding recency window. Quantile error past the exact phase
        # is the usual reservoir sampling error (~1/sqrt(keep_values));
        # the golden test in tests/test_obs.py pins the tolerance.
        self._cap = max(int(keep_values), 1)
        self._values: list[float] = []
        self._rng = self._SEED
        # quantile memo: (observation count at sort time, sorted snapshot).
        # Bench summary blocks ask for several percentiles back to back; a
        # fresh O(n log n) sort of up to 100k retained samples per call was
        # pure waste — the sorted view is valid until the next observe.
        self._sorted: tuple[int, list[float]] | None = None

    def observe(self, v: float) -> None:
        self.n += 1
        self.total += v
        vals = self._values
        if len(vals) < self._cap:
            vals.append(v)
        else:
            # Algorithm R: keep v with probability cap/n, replacing a
            # uniformly-chosen resident — every observation of the
            # stream ends up retained with equal probability
            x = self._rng
            x = (x ^ (x << 13)) & self._M64
            x ^= x >> 7
            x = (x ^ (x << 17)) & self._M64
            self._rng = x
            j = x % self.n
            if j < self._cap:
                vals[j] = v
        # bisect_left(bounds, v) = first bucket with v <= bound — the
        # same bucket the linear scan chose, without walking every bound
        # for large observations (e2e latencies land in the last buckets)
        self.counts[bisect_left(self.bounds, v)] += 1

    def quantile(self, q: float) -> float:
        if not self._values:
            return 0.0
        memo = self._sorted
        if memo is not None and memo[0] == self.n:
            xs = memo[1]
        else:
            xs = sorted(self._values)
            self._sorted = (self.n, xs)
        idx = min(int(q * len(xs)), len(xs) - 1)
        return xs[idx]

    def samples(self) -> list[float]:
        """Retained raw observations (exact below keep_values, a uniform
        whole-stream reservoir past it), for cross-histogram aggregation
        (e.g. one quantile over several profiles)."""
        return list(self._values)

    def merge_from(self, other: "Histogram") -> None:
        """Fold another histogram in (cross-profile aggregation): O(buckets)
        instead of replaying every retained sample through observe()."""
        if other.bounds == self.bounds:
            self.counts = [a + b for a, b in zip(self.counts, other.counts)]
            self.total += other.total
            self.n += other.n
            self._values.extend(other._values)
            if len(self._values) > self._cap:
                # deterministic stride downsample back to capacity: the
                # merged view keeps proportional representation of both
                # sources (merge feeds bench summaries, not the live
                # reservoir invariant)
                step = len(self._values) / self._cap
                self._values = [self._values[int(i * step)]
                                for i in range(self._cap)]
            self._sorted = None
        else:  # different bucketing: replay is the only faithful merge
            for v in other.samples():
                self.observe(v)


_NAME_BAD = None  # compiled lazily (module import stays cheap)


def _metric_name(name: str) -> str:
    """Sanitize a metric family name per the exposition spec
    ([a-zA-Z_:][a-zA-Z0-9_:]*): internal series names may carry workload
    classes with dashes (schedule_latency_ms_class_tpu-single), which a
    real Prometheus parser rejects outright."""
    global _NAME_BAD
    if _NAME_BAD is None:
        import re

        _NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
    return _NAME_BAD.sub("_", name)


def _escape_label_value(v: str) -> str:
    """Prometheus text exposition escaping for label VALUES: backslash,
    double quote, and newline (in that order — escaping the escapes)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    """# HELP text escaping: backslash and newline only (quotes are legal)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def fmt_labels(labels: dict | tuple) -> str:
    """Render a label set as `{k="v",...}` with spec-compliant value
    escaping; empty input renders as the empty string (no braces)."""
    items = labels.items() if isinstance(labels, dict) else labels
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in items]
    return "{" + ",".join(parts) + "}" if parts else ""


class Metrics:
    # HELP text for the well-known series; anything unregistered gets a
    # generated one-liner so every family still carries a # HELP line
    HELP: dict[str, str] = {
        "schedule_latency_ms": "End-to-end pod scheduling latency "
                               "(enqueue to bind), milliseconds.",
        "cycle_latency_ms": "One scheduling cycle's compute latency, "
                            "milliseconds.",
        "e2e_queue_wait_ms": "Per-bound-pod time spent queued or in "
                             "backoff, milliseconds.",
        "e2e_cycle_compute_ms": "Per-bound-pod scheduling-cycle compute "
                                "time (all attempts), milliseconds.",
        "e2e_commit_ms": "Per-bound-pod reserve/permit/bind bookkeeping "
                         "time, excluding the wire, milliseconds.",
        "e2e_wire_ms": "Per-bound-pod bind wire time (apiserver RTT), "
                       "milliseconds.",
        "bind_wire_ms": "Binding subresource POST round-trip time, "
                        "milliseconds.",
        "watch_confirm_ms": "Bind dispatch to watch-cache confirmation, "
                            "milliseconds.",
        "scheduling_outcomes_total": "Scheduling cycle outcomes, labeled "
                                     "by outcome.",
        "cycle_plane_total": "Scheduling cycles by serving data plane "
                             "(scalar|numpy|native|memo).",
        "filter_rejections_total": "Pods rejected per filter plugin "
                                   "(labeled by plugin).",
        "pods_scheduled_total": "Pods successfully bound.",
        "pods_unschedulable_total": "Cycles that ended unschedulable.",
        "breaker_open": "Apiserver circuit breaker state (1 = open).",
        "degraded": "Telemetry-blackout degraded mode (1 = active).",
        "tenant_dominant_share": "DRF dominant share (max over chips/"
                                 "HBM of used/capacity) per tenant.",
        "preemption_victims_total": "Pods evicted by preemption, per "
                                    "victim tenant.",
        "tenant_quota_rejections_total": "Pods refused by the tenant "
                                         "quota gate, per tenant.",
        "tenant_quota_breaches_total": "Episodes of a tenant's dominant "
                                       "share exceeding its quota cap.",
        "tenant_starvation_trips_total": "Pods unbound past the "
                                         "starvation threshold, per "
                                         "tenant.",
        "preemptions_budget_denied_total": "Preemption plans refused by "
                                           "per-tenant budgets, labeled "
                                           "by the denying budget level.",
        "defrag_evictions_total": "Pods migrated by the active "
                                  "defragmentation controller, labeled "
                                  "by strategy (slice-conservation|"
                                  "compaction).",
        "defrag_passes_total": "Defragmentation passes executed "
                               "(including passes that migrated "
                               "nothing).",
        "defrag_skips_total": "Defragmentation passes skipped, labeled "
                              "by reason (breaker-open|degraded|"
                              "not-owner).",
        "defrag_errors_total": "Defragmentation passes aborted by a "
                               "contained controller crash (the engine "
                               "thread survives; the pass is skipped).",
        "workloads_parked": "Workloads parked in the admission tier "
                            "(awaiting quota/capacity/backpressure) — "
                            "each costs O(1) memory, never O(pods).",
        "workloads_submitted_total": "Workloads accepted into the "
                                     "admission tier.",
        "workload_admissions_total": "Workloads admitted (pods "
                                     "materialized), per tenant.",
        "workload_rejections_total": "Workloads rejected or withdrawn, "
                                     "labeled by reason.",
        "workload_parked_total": "Workload park verdicts, labeled by "
                                 "reason (OverQuota|NoCapacity).",
        "workload_backpressure_total": "Admission passes held back, "
                                       "labeled by reason (queue-depth|"
                                       "rate-limit).",
        "workload_materialized_pods_total": "Pods materialized into the "
                                            "scheduling queue by "
                                            "workload admissions.",
        "workload_admission_decision_ms": "One workload admission "
                                          "decision's latency, "
                                          "milliseconds (flat with "
                                          "backlog depth by design).",
        "workload_park_wait_ms": "Time a workload sat parked before "
                                 "admission, milliseconds.",
        "workload_admission_errors_total": "Admission passes aborted by "
                                           "a contained tier crash (the "
                                           "engine thread survives).",
        "workload_admission_skips_total": "Admission passes skipped, "
                                          "labeled by reason "
                                          "(not-owner).",
        "workload_admission_dedup_total": "Admissions adopted because a "
                                          "peer replica already "
                                          "materialized the workload "
                                          "(fleet handover races).",
        "provision_requests_total": "Capacity-provider request results, "
                                    "labeled by outcome (ready|stockout|"
                                    "quota-denied|written-off).",
        "provisioner_scale_ups_total": "Node requests issued by the "
                                       "capacity provisioner, per pool.",
        "provisioner_nodes_released_total": "Empty, cooldown-expired "
                                            "nodes released by "
                                            "scale-down, per pool.",
        "provisioner_nodes_adopted_total": "Provisioned nodes adopted "
                                           "by membership "
                                           "reconciliation (response "
                                           "lost or requester crashed) "
                                           "— never leaked.",
        "provisioner_drain_evictions_total": "Ordinary pods migrated "
                                             "off a node being drained "
                                             "for scale-down (each "
                                             "with a dry-run-proven "
                                             "destination).",
        "provisioner_breaker_opens_total": "Per-pool provider circuit "
                                           "breaker openings "
                                           "(consecutive stockout/"
                                           "quota/write-off failures).",
        "provisioner_skips_total": "Provisioner actions skipped, "
                                   "labeled by reason (not-owner|"
                                   "breaker-open|degraded|hysteresis|"
                                   "pool-backoff|pool-breaker-open|"
                                   "pool-at-max|drain-blocked|"
                                   "slo-pressure).",
        "provisioner_errors_total": "Capacity passes aborted by a "
                                    "contained controller crash (the "
                                    "engine thread survives).",
        "pool_nodes": "Managed node count per pool (gauge).",
        "harvest_evictions_total": "Harvest-class (scv/harvest) pods "
                                   "evicted for free, labeled by reason "
                                   "(preemption|scale-down) — never "
                                   "counted against preemption budgets "
                                   "or the victim tenant's "
                                   "preemption_victims_total.",
        "gang_grow_total": "Elastic-gang members bound into a gang "
                           "running below its desired size (growth "
                           "binds).",
        "gang_shrink_total": "Elastic-gang members evicted from a "
                             "running gang, labeled by reason "
                             "(preemption|slo) — slo marks serving-"
                             "pressure degradation, never conflated "
                             "with preemption in PromQL.",
        "gang_elastic_admissions_total": "Gangs admitted below desired "
                                         "size, labeled by reason "
                                         "(no-fit|deadline).",
        "gang_elastic_completions_total": "Elastic gangs grown back to "
                                          "their desired size.",
        "slo_burn_rate": "Serving SLO burn rate (violation fraction / "
                         "error budget) per window (fast|slow); 1.0 "
                         "burns the budget exactly at the target.",
        "slo_requests_total": "Serving binds measured against an "
                              "scv/slo-ms budget.",
        "slo_violations_total": "Serving binds that landed outside "
                                "their scv/slo-ms budget.",
        "slo_window_violations_total": "Fixed evaluation windows whose "
                                       "serving violation fraction "
                                       "exceeded the error budget "
                                       "(burn > 1) — the bench fence "
                                       "pins this at zero.",
        "serving_headroom_chips": "Unused reserved serving headroom, "
                                  "chips (reservation minus serving "
                                  "usage, floored at zero).",
        "serving_headroom_rejections_total": "Non-serving pods refused "
                                             "by the serving-headroom "
                                             "quota level.",
        "slo_pressure": "SLO guard pressure state (1 = degrading "
                        "training toward gang-min).",
        "slo_shrink_passes_total": "SLO guard passes that evicted at "
                                   "least one elastic-gang member "
                                   "under serving pressure.",
        "slo_giveback_total": "Hysteresis-expired give-back passes "
                              "returning shrunk capacity to training.",
        "slo_guard_skips_total": "SLO guard passes skipped, labeled by "
                                 "reason (not-owner|breaker-open|"
                                 "degraded|hysteresis).",
        "slo_guard_errors_total": "SLO guard passes aborted by a "
                                  "contained controller crash (the "
                                  "engine thread survives).",
        "serving_growth_holds_total": "Elastic growth binds parked "
                                      "because the SLO guard is "
                                      "holding capacity for serving.",
        "workload_serving_fastpath_total": "Serving workloads admitted "
                                           "past rate-limit/"
                                           "backpressure holds, "
                                           "labeled by waived check.",
        "torus_multislice_dcn_span": "Greedy multi-slice carve plans' "
                                     "max inter-slice DCN distance "
                                     "(proxy units).",
    }

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}
        # labeled series: name -> {sorted (k, v) tuple -> value}. Plain
        # (unlabeled) series keep the flat dicts above — every existing
        # counters.get("...") consumer stays valid.
        self.labeled_counters: dict[str, dict[tuple, int]] = {}
        self.labeled_gauges: dict[str, dict[tuple, float]] = {}

    @staticmethod
    def _lkey(labels) -> tuple:
        # hot-path form: callers may pass an already-sorted ((k, v), ...)
        # tuple instead of a dict — the engine's per-cycle labeled incs
        # reuse cached tuples rather than re-sorting a fresh dict each
        # time (measurable across a 25k-pod drain's outcome counters)
        if type(labels) is tuple:
            return labels
        return tuple(sorted(labels.items()))

    def inc(self, name: str, by: int = 1, labels=None) -> None:
        with self._lock:
            if labels:
                fam = self.labeled_counters.setdefault(name, {})
                k = self._lkey(labels)
                fam[k] = fam.get(k, 0) + by
            else:
                self.counters[name] = self.counters.get(name, 0) + by

    def set_gauge(self, name: str, value: float,
                  labels: dict | None = None) -> None:
        with self._lock:
            if labels:
                self.labeled_gauges.setdefault(
                    name, {})[self._lkey(labels)] = value
            else:
                self.gauges[name] = value

    def labeled_counter(self, name: str, labels: dict) -> int:
        """Read one labeled counter value (0 when absent) — test/bench
        convenience, not a hot-path call."""
        return self.labeled_counters.get(name, {}).get(
            self._lkey(labels), 0)

    def observe(self, name: str, value: float) -> None:
        # plain get first: setdefault(name, Histogram()) would construct
        # (and discard) a fresh Histogram — counts list + sample deque —
        # on EVERY observation; this runs once per scheduling cycle
        h = self.histograms.get(name)
        if h is None:
            with self._lock:
                h = self.histograms.setdefault(name, Histogram())
        h.observe(value)

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is not None:
            return h
        with self._lock:
            return self.histograms.setdefault(name, Histogram())

    def snapshot_families(self):
        """Consistent shallow copies of every registry dict, taken under
        the writer lock: (counters, labeled_counters, gauges,
        labeled_gauges, histograms). Merged/multi-engine readers iterate
        these instead of the live dicts — an engine inserting its first
        'native' plane key mid-scrape must not blow up the reader with
        'dictionary changed size during iteration'."""
        with self._lock:
            return (dict(self.counters),
                    {k: dict(v) for k, v in self.labeled_counters.items()},
                    dict(self.gauges),
                    {k: dict(v) for k, v in self.labeled_gauges.items()},
                    dict(self.histograms))

    # --------------------------------------------------- prometheus exposition
    def _help_line(self, lines: list[str], prefix: str, k: str,
                   typ: str) -> None:
        text = self.HELP.get(k)
        if text is None:
            text = f"yoda-tpu scheduler {typ} {k.replace('_', ' ')}."
        name = _metric_name(k)
        lines.append(f"# HELP {prefix}_{name} {_escape_help(text)}")
        lines.append(f"# TYPE {prefix}_{name} {typ}")

    def render_prometheus(self, prefix: str = "yoda_tpu") -> str:
        lines: list[str] = []
        with self._lock:
            names = sorted(set(self.counters) | set(self.labeled_counters))
            for k in names:
                self._help_line(lines, prefix, k, "counter")
                n = _metric_name(k)
                if k in self.counters:
                    lines.append(f"{prefix}_{n} {self.counters[k]}")
                for lk, v in sorted(self.labeled_counters.get(k, {}).items()):
                    lines.append(f"{prefix}_{n}{fmt_labels(lk)} {v}")
            names = sorted(set(self.gauges) | set(self.labeled_gauges))
            for k in names:
                self._help_line(lines, prefix, k, "gauge")
                n = _metric_name(k)
                if k in self.gauges:
                    lines.append(f"{prefix}_{n} {self.gauges[k]}")
                for lk, v in sorted(self.labeled_gauges.get(k, {}).items()):
                    lines.append(f"{prefix}_{n}{fmt_labels(lk)} {v}")
            for k, h in sorted(self.histograms.items()):
                self._help_line(lines, prefix, k, "histogram")
                n = _metric_name(k)
                cum = 0
                for b, c in zip(h.bounds, h.counts):
                    cum += c
                    lines.append(f'{prefix}_{n}_bucket{{le="{b}"}} {cum}')
                lines.append(f'{prefix}_{n}_bucket{{le="+Inf"}} {h.n}')
                lines.append(f"{prefix}_{n}_sum {h.total}")
                lines.append(f"{prefix}_{n}_count {h.n}")
        return "\n".join(lines) + "\n"


class TraceLog:
    """Bounded ring of recent cycle traces."""

    def __init__(self, capacity: int = 4096) -> None:
        self._buf: deque[CycleTrace] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def add(self, t: CycleTrace) -> None:
        # lock-free: deque.append with maxlen is GIL-atomic, and recent()
        # snapshots via list(...) which is likewise atomic — the lock
        # only guards the (rare) reader-side slicing. One add runs per
        # scheduling cycle, so the acquire was measurable at drain scale.
        self._buf.append(t)

    def recent(self, n: int = 50) -> list[CycleTrace]:
        with self._lock:
            return list(self._buf)[-n:]


# ------------------------------------------------------------------ spans
def span_sampled(key: str, sampling: int) -> bool:
    """Deterministic 1-in-`sampling` pod sampling decision (crc32, stable
    across runs and replicas — the same pod samples identically on every
    fleet member, so a sampled pod's spans are complete). sampling<=0
    disables tracing; 1 traces every pod."""
    if sampling <= 0:
        return False
    if sampling == 1:
        return True
    return zlib.crc32(key.encode()) % sampling == 0


class SpanRing:
    """Low-overhead lifecycle span recorder: a bounded ring of finished
    spans, each a flat tuple (name, subject, t0, t1, attrs|None) stamped
    on the owning engine's injectable clock. record() is one tuple build
    plus a GIL-atomic deque append — no locks, no allocation beyond the
    record — so it can sit on the scheduling hot path at the default
    sampling rate. Export is Chrome/Perfetto trace-event JSON ("X"
    complete events, microsecond timestamps): one track (tid) per pod, so
    a pod's queued -> cycle -> bind_wire -> watch_confirm tree reads as a
    lane in the Perfetto UI."""

    def __init__(self, capacity: int = 16384, pid: int = 0) -> None:
        self._buf: deque[tuple] = deque(maxlen=capacity)
        self.pid = pid  # replica index in a fleet; 0 standalone

    def record(self, name: str, subject: str, t0: float, t1: float,
               attrs: dict | None = None) -> None:
        self._buf.append((name, subject, t0, t1, attrs))

    def __len__(self) -> int:
        return len(self._buf)

    def snapshot(self) -> list[tuple]:
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()

    def chrome_events(self) -> list[dict]:
        """Chrome trace-event dicts for every retained span. Timestamps
        are the recording clock's seconds scaled to microseconds; on a
        virtual clock the trace is in virtual time, which is exactly what
        a chaos replay should show."""
        events: list[dict] = []
        tids: dict[str, int] = {}
        # snapshot before iterating: the engine appends concurrently, and
        # iterating a live deque raises "mutated during iteration"
        # (list(deque) is GIL-atomic)
        for name, subject, t0, t1, attrs in list(self._buf):
            tid = tids.get(subject)
            if tid is None:
                tid = len(tids) + 1
                tids[subject] = tid
                events.append({
                    "name": "thread_name", "ph": "M", "pid": self.pid,
                    "tid": tid, "args": {"name": subject}})
            ev = {
                "name": name, "cat": "scheduling", "ph": "X",
                "ts": round(t0 * 1e6, 3),
                "dur": round(max(t1 - t0, 0.0) * 1e6, 3),
                "pid": self.pid, "tid": tid,
            }
            if attrs:
                ev["args"] = attrs
            events.append(ev)
        return events


def export_chrome_trace(rings, path: str | None = None) -> dict:
    """Merge one or more SpanRings into a Chrome/Perfetto trace document
    ({"traceEvents": [...], "displayTimeUnit": "ms"}); optionally write it
    to `path`. Accepts any iterable of objects exposing chrome_events()."""
    events: list[dict] = []
    for ring in rings:
        events.extend(ring.chrome_events())
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


# ---------------------------------------------------------- SLO monitor
class SloMonitor:
    """Multi-window serving SLO burn-rate monitor.

    Burn rate = (violation fraction) / (error budget), the SRE-workbook
    normalization: 1.0 spends the budget exactly at the target, 100x
    means every request violates a 99% objective. Pressure asserts only
    when BOTH a fast and a slow window burn above threshold — fast-only
    is noise a single straggler can cause, slow-only is stale history a
    recovered crowd leaves behind. Alongside the rolling windows, time
    partitions into FIXED evaluation windows of fast_window_s: a closed
    window whose violation fraction exceeded the budget counts one
    `slo_window_violations_total` (the bench fence pins this at zero).
    The fast->pressed transition records the `slo_burn` flight trip
    (auto-dumping, rate-limited like every trip); recovery re-arms it.

    Observations and evaluations run on the engine clock and the engine
    thread — no locking beyond the Metrics registry's own."""

    def __init__(self, metrics: Metrics, flight=None, *,
                 target_pct: float = 99.0, burn_threshold: float = 2.0,
                 fast_window_s: float = 30.0,
                 slow_window_s: float = 300.0) -> None:
        self.metrics = metrics
        self.flight = flight
        self.budget = max(1.0 - target_pct / 100.0, 1e-9)
        self.burn_threshold = burn_threshold
        self.fast_window_s = fast_window_s
        self.slow_window_s = max(slow_window_s, fast_window_s)
        self._events: deque[tuple[float, bool]] = deque()
        self.pressed = False
        self._win_start: float | None = None
        self._win_total = 0
        self._win_bad = 0
        self.window_violations = 0  # fence/test convenience mirror

    def observe(self, latency_ms: float, slo_ms: float,
                now: float) -> None:
        """One serving bind's e2e latency against its scv/slo-ms budget."""
        bad = latency_ms > slo_ms
        self._events.append((now, bad))
        self.metrics.inc("slo_requests_total")
        if bad:
            self.metrics.inc("slo_violations_total")
        self._roll_fixed(now)
        self._win_total += 1
        self._win_bad += 1 if bad else 0

    def _roll_fixed(self, now: float) -> None:
        # close every fixed window the clock has fully passed; empty
        # windows close silently (no traffic cannot violate an SLO)
        if self._win_start is None:
            self._win_start = now
        while now - self._win_start >= self.fast_window_s:
            if (self._win_total
                    and self._win_bad / self._win_total > self.budget):
                self.window_violations += 1
                self.metrics.inc("slo_window_violations_total")
            self._win_total = self._win_bad = 0
            self._win_start += self.fast_window_s

    def burn(self, window_s: float, now: float) -> float:
        """Rolling burn rate over the trailing `window_s` seconds."""
        total = bad = 0
        for ts, b in reversed(self._events):  # newest first; early out
            if now - ts > window_s:
                break
            total += 1
            bad += 1 if b else 0
        if not total:
            return 0.0
        return (bad / total) / self.budget

    def evaluate(self, now: float) -> bool:
        """Refresh gauges, close idle fixed windows, return pressure."""
        self._roll_fixed(now)
        ev = self._events
        while ev and now - ev[0][0] > self.slow_window_s:
            ev.popleft()
        fast = self.burn(self.fast_window_s, now)
        slow = self.burn(self.slow_window_s, now)
        self.metrics.set_gauge("slo_burn_rate", round(fast, 4),
                               labels={"window": "fast"})
        self.metrics.set_gauge("slo_burn_rate", round(slow, 4),
                               labels={"window": "slow"})
        pressed = (fast >= self.burn_threshold
                   and slow >= self.burn_threshold)
        if pressed and not self.pressed and self.flight is not None:
            self.flight.record("slo_burn", fast=round(fast, 3),
                               slow=round(slow, 3))
        self.pressed = pressed
        return pressed


# --------------------------------------------------------- flight recorder
# event kinds that auto-trigger a disk dump when a dump dir is configured.
# webhook_deny / webhook_fail_open (the bind-authority webhook catching a
# would-be double-booking / flipping its degradation posture) and
# shard_takeover (a replica claiming a dead peer's shard) are trip kinds
# too: each marks the system actively absorbing a fault, exactly the
# moment the black box should land on disk. Dumps stay rate-limited
# (min_dump_interval_s), so a deny storm costs one file per window.
# tenant_quota_breach (a tenant's dominant share EXCEEDS its configured
# cap in cluster truth — the quota gate can only stop further binds) and
# tenant_starvation (a pod unbound past starvationAfterSeconds) are the
# policy engine's trip kinds: both mark fairness actively failing, the
# moment the black box should land on disk.
# defrag_pass (the active defragmentation controller actually MIGRATING
# workloads — empty passes stay out of the ring) joins them: every
# migration is the scheduler rearranging running jobs on its own
# initiative, exactly what an operator reconstructing "why did my pod
# move" needs the black box to show. Unlike every other trip — all
# exceptional failure signals that self-limit — defrag passes are
# PLANNED recurring behavior, so they land in the ring but never
# auto-dump: the rate limiter bounds dump frequency, not count, and a
# steady defrag cadence would otherwise grow a new dump file per window
# indefinitely on a healthy cluster.
# provisioner_breaker_open (a node pool's capacity provider failing
# consistently — stockouts, quota denials, lost responses — so the
# closed capacity loop stopped asking) dumps like breaker_open: it is
# the capacity plane actively failing. pool_scaledown (the provisioner
# releasing an empty, cooldown-expired node) is the defrag_pass shape:
# planned recurring behavior an operator reconstructing "where did my
# node go" needs in the ring, but never a dump file per window on a
# healthy diurnal cluster.
# slo_burn (the serving SLO burning above threshold in BOTH the fast
# and slow windows — the multi-window trip that starts graceful
# degradation) dumps like breaker_open: it is user-facing latency
# actively failing, and the rate limiter already bounds a sustained
# flash crowd to one file per window.
TRIP_KINDS = frozenset({"breaker_open", "invariant_violation",
                        "quarantine", "webhook_deny", "webhook_fail_open",
                        "shard_takeover", "tenant_quota_breach",
                        "tenant_starvation", "defrag_pass",
                        "provisioner_breaker_open", "pool_scaledown",
                        "slice_drain", "slo_burn"})
# trips that mark routine (if noteworthy) operation rather than a fault
# being absorbed: recorded + counted, but no disk dump.
# slice_drain (the provisioner migrating residents off a whole slice so
# it can release shape-intact) is pool_scaledown's sibling: planned
# consolidation, ring-worthy, never a dump per pass.
RING_ONLY_TRIPS = frozenset({"defrag_pass", "pool_scaledown",
                             "slice_drain"})


class FlightRecorder:
    """Black-box recorder: a bounded ring of structured engine events —
    breaker transitions, degraded-mode flips, quarantines, fence aborts,
    conflict fallbacks, crash containment — cheap enough to run always.
    record() is one tuple append (GIL-atomic deque); when the event kind
    is in TRIP_KINDS and a dump directory is configured (constructor arg
    or $YODA_FLIGHT_DIR), the ring auto-dumps to a JSON file, rate-limited
    to one dump per `min_dump_interval_s` of wall time so a flapping
    breaker cannot fill a disk. test_chaos.py dumps explicitly on
    invariant violations and CI uploads the directory on failure."""

    def __init__(self, capacity: int = 2048, clock=None,
                 dump_dir: str | None = None,
                 min_dump_interval_s: float = 5.0) -> None:
        self._buf: deque[tuple] = deque(maxlen=capacity)
        self._clock = clock  # engine clock; ts in its timebase
        self.dump_dir = (dump_dir if dump_dir is not None
                         else os.environ.get("YODA_FLIGHT_DIR", ""))
        self.min_dump_interval_s = min_dump_interval_s
        self._last_dump_wall = 0.0
        self.dumps: list[str] = []  # paths written (tests/CI read these)

    def _now(self) -> float:
        return self._clock.time() if self._clock is not None else time.time()

    def record(self, kind: str, /, **detail) -> None:
        # positional-only `kind`: detail keys are free-form event payload
        # and must never collide with the event-kind parameter
        self._buf.append((self._now(), kind, detail or None))
        if (kind in TRIP_KINDS and kind not in RING_ONLY_TRIPS
                and self.dump_dir):
            self.auto_dump(reason=kind)

    def snapshot(self) -> list[dict]:
        # event kind merged LAST: a detail payload key named "kind" must
        # never masquerade as the event kind
        return [{"ts": ts, **(detail or {}), "kind": kind}
                for ts, kind, detail in list(self._buf)]

    def auto_dump(self, reason: str) -> str | None:
        """Rate-limited trigger dump (wall-clock limited: the recorder's
        own clock may be virtual and frozen mid-storm)."""
        wall = time.time()
        if wall - self._last_dump_wall < self.min_dump_interval_s:
            return None
        self._last_dump_wall = wall
        return self.dump(reason=reason)

    def dump(self, path: str | None = None, reason: str = "") -> str | None:
        """Write the ring to `path` (or an auto-named file under dump_dir).
        Best-effort: a full disk must never take the engine down."""
        if path is None:
            if not self.dump_dir:
                return None
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
            except OSError:
                return None
            # id(self) uniquifies across recorders sharing one dump dir
            # in one process (fleet replicas tripping within the same
            # wall millisecond must not overwrite each other's dump)
            path = os.path.join(
                self.dump_dir,
                f"flight-{os.getpid()}-{id(self):x}-"
                f"{int(time.time() * 1e3):x}-{reason or 'manual'}.json")
        doc = {"reason": reason, "wall_time": time.time(),
               "events": self.snapshot()}
        try:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        except OSError:
            return None
        self.dumps.append(path)
        return path
