"""Serving-headroom quota level: reserved capacity for the SLO class.

The SLO class's admission half: ``servingHeadroomPct`` carves a slice of
cluster chips that only ``scv/serving`` pods may use — expressed as a
quota LEVEL sitting ABOVE every tenant in the DRF hierarchy.
The DRFBook already splits serving usage out of its per-node
incremental accounting (fairness.DRFBook, serving_reserve_pct); this
gate is the enforcement tooth: a NON-serving pod (training and harvest
alike — harvest must not squat the reservation either, or a flash
crowd pays an eviction round-trip before its first bind) whose bind
would push the non-serving aggregate past ``(1 - pct) * capacity`` is
unschedulable now and wakes event-driven when capacity frees, exactly
the TenantQuotaGate discipline. Serving pods always pass: the
reservation is a floor for serving, a ceiling for everyone else.

Built only when ``sloServing`` is on AND the reservation is positive —
otherwise the profile carries no trace of it (the bit-identical
knob-off parity leg)."""

from __future__ import annotations

from ..framework import (
    CycleState,
    EnqueueExtensions,
    NODE_ADDED,
    NO_BATCH,
    POD_DELETED,
    PreFilterPlugin,
    QUEUE,
    Snapshot,
    Status,
)
from ...utils.labels import LabelError, spec_for


class ServingHeadroomGate(PreFilterPlugin, EnqueueExtensions):
    """PreFilter: refuse a non-serving pod whose bind would eat into
    the reserved serving headroom. Node-independent (one aggregate
    check per cycle, not per node)."""

    name = "serving-headroom-gate"

    def __init__(self, policy) -> None:
        self.policy = policy  # fairness.PolicyEngine

    def equivalence_key(self, pod):
        """Serving pods are a no-op by construction (always SUCCESS, no
        state) — they batch freely as one class. A NON-serving pod's
        verdict moves with every bind, including our own mid-batch
        commits the batch loop would not re-check, so it never batches
        (the TenantQuotaGate discipline)."""
        try:
            spec = spec_for(pod)
        except LabelError:
            return ("malformed",)  # the filter owns malformed pods
        return ("serving",) if spec.serving else NO_BATCH

    def events_to_register(self):
        # a pod leaving frees aggregate share; new capacity grows the
        # non-serving ceiling — either can cure a headroom rejection
        return (POD_DELETED, NODE_ADDED)

    def queueing_hint(self, event, pod) -> str:
        return QUEUE

    def pre_filter(self, state: CycleState, pod,
                   snapshot: Snapshot) -> Status:
        book = self.policy.book
        if book is None:
            return Status.success()
        spec = state.read_or("workload_spec")
        if spec is None:
            try:
                spec = spec_for(pod)
            except LabelError:
                return Status.success()
        if spec.serving:
            return Status.success()
        book.refresh()
        # a gang member is gated on the gang's UNBOUND remainder, the
        # quota-gate rule with one refinement: siblings parked at Permit
        # hold no cluster-truth usage yet (per-member gating would admit
        # each against the same headroom), but members ALREADY BOUND are
        # in the book's aggregate — whole-gang demand would double-count
        # them and wedge an elastic gang's re-growth toward full size
        mult = 1
        if spec.is_gang:
            from ..elastic.gangs import bound_member_count

            mult = max(spec.gang_size
                       - bound_member_count(book.cluster, spec.gang_name),
                       1)
        if not book.nonserving_over_reserve(spec.chips * mult):
            return Status.success()
        if self.policy.metrics is not None:
            self.policy.metrics.inc("serving_headroom_rejections_total")
        return Status.unschedulable(
            f"serving headroom: non-serving aggregate would exceed "
            f"{1.0 - book._serve_pct:.2f} of cluster chips "
            f"({book._serve_pct:.0%} reserved for scv/serving)")
