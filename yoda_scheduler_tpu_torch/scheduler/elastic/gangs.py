"""Elastic gangs: shrink/grow placement for ``tpu/gang-min`` gangs.

Classic gang admission (plugins/gang.py) is all-or-nothing: every member
parks at Permit until the full ``tpu/gang-size`` is placed, and any
failure tears the whole assembly down. On a fragmented cluster a v4-32
job that could usefully run on 2 of its 4 hosts instead waits — or fails
— while the chips it DID find sit reserved and idle.

With ``elasticGangs`` on, a gang labeled ``tpu/gang-min: K`` gets three
new behaviours, all coordinated here:

- **Admit at min**: when a member finds no capacity and the gang already
  has >= K members placed (parked at Permit + bound in cluster truth),
  the engine binds the parked members NOW instead of letting the
  assembly time out (core._elastic_admit_at_min). The failing member —
  and every later member that cannot place — parks as a GROWTH member.
- **Event-driven growth**: growth members are a distinct queue class
  (rejected_by=ELASTIC_GROW_HINT) woken by POD_DELETED / NODE_ADDED
  through the ordinary queueing-hint machinery; each one that places
  binds alone (GangPermit's grow branch: bound members >= K means
  assembly is over) and counts gang_grow_total. Growth never preempts —
  it rides capacity as it frees (the defrag controller is what actively
  frees it).
- **Shrink to min**: a bound elastic gang running ABOVE its min is a
  preemption donor — the planner may evict members down to (never past)
  ``tpu/gang-min``, a strictly cheaper victim plan than the only prior
  option, not touching gangs at all. Shrink victims re-enter the queue
  and re-grow the gang when capacity returns (gang_shrink_total{reason}).

``scv/deadline-seconds`` adds SLO pressure: a gang whose remaining
start-deadline budget cannot cover another full-assembly round starts at
min as soon as K members are placed, without waiting for the no-fit
signal. The threshold scales with the policy engine's throughput model:
on a fast generation, running at min costs less, so the gang
gives up on full assembly sooner.
"""

from __future__ import annotations

from ...utils.labels import GANG_NAME_LABEL, WorkloadSpec

# the queue-hint name growth members park under (core registers it with
# the queue alongside the engine's victim-drain hint)
ELASTIC_GROW_HINT = "elastic-grow"


def bound_member_count(cluster, gang: str) -> int:
    """Non-terminating bound members of `gang`, from CLUSTER TRUTH — the
    one count every elastic decision keys on, so fleet replicas and a
    restarted engine agree without any coordinator state. O(cluster):
    gang lifecycle events (admission, grow bind, shrink eviction) pay it
    directly; the engine's per-cycle growth-park checks go through
    Scheduler._bound_members_of, which memoises this walk on the cluster
    version vector so a wave of parked-member wakes pays it once."""
    n = 0
    for node in cluster.node_names():
        for p in cluster.pods_on(node):
            if p.labels.get(GANG_NAME_LABEL) == gang and not p.terminating:
                n += 1
    return n


class ElasticGangs:
    """Shared elastic-gang state, one per profile (like GangCoordinator).
    Engine-thread-only after attach(): every hook runs inside the cycle
    lock. Holds only bookkeeping the metrics/deadline decisions need —
    admission itself always reads cluster truth, so a crashed engine or
    a foreign fleet replica reconstructs behaviour from the cluster
    alone."""

    def __init__(self, config, policy=None) -> None:
        self.config = config
        self.policy = policy  # PolicyEngine | None: throughput model
        self.metrics = None
        self.clock = None
        # gang -> first time any member reached Permit (deadline anchor)
        self._first_seen: dict[str, float] = {}
        # gangs admitted BELOW desired size and still growing:
        # gang -> pending_initial (members of the admission batch whose
        # binds must not count as grows). Entries retire at completion.
        self._growing: dict[str, int] = {}
        # admissions recorded but not yet COUNTED: the metric fires only
        # once cluster truth shows the gang at min under the record — an
        # admission the engine aborts (peer bind failed below min) never
        # reached min, so it never counts and a later real admission of
        # the same gang cannot double-count.
        self._pending_admission: dict[str, str] = {}

    def attach(self, metrics, clock) -> None:
        self.metrics = metrics
        self.clock = clock

    # ------------------------------------------------------------ decisions
    @staticmethod
    def _bound_insert(book: dict, key, value) -> None:
        """Insert under a churn backstop that evicts the OLDEST entry
        (dict insertion order) instead of wiping the book: these maps
        hold live semantic state (deadline anchors, growing records),
        and a wholesale clear at the bound would silently stop counting
        grows / reset deadline clocks for every active gang at once."""
        if len(book) > 4096:
            book.pop(next(iter(book)))
        book[key] = value

    def note_member_seen(self, gang: str, now: float | None) -> None:
        if now is not None and gang not in self._first_seen:
            self._bound_insert(self._first_seen, gang, now)

    def deadline_pressed(self, spec: WorkloadSpec,
                         now: float | None) -> bool:
        """Start-now-at-min vs wait-for-full, for a gang with >= min
        members placed. True when the remaining start-deadline budget
        cannot cover another full-assembly wait (one gang_timeout_s
        round), scaled by the cost of running at min: the budget
        threshold is gang_timeout_s * r * (min/size) — a bigger
        throughput sacrifice (size/min) shrinks it, so the gang holds
        out for full assembly longer, while a fast generation
        (throughput ratio r > 1 from the policy model) delivers
        acceptably at min, so the gang gives up on full sooner."""
        if spec.deadline_s <= 0 or spec.gang_min <= 0 or now is None:
            return False
        waited = now - self._first_seen.get(spec.gang_name, now)
        ratio = 1.0
        if self.policy is not None:
            from ..policy.heterogeneity import throughput_class

            ratio = max(self.policy.model.best(throughput_class(spec)),
                        1e-9)
        threshold = (self.config.gang_timeout_s * ratio
                     * (max(spec.gang_min, 1) / spec.gang_size))
        return (spec.deadline_s - waited) <= threshold

    # ------------------------------------------------------------- lifecycle
    def note_admitted_at_min(self, gang: str, initial: int,
                             reason: str) -> None:
        """The gang was admitted below desired size with `initial`
        members binding as part of the admission itself (those binds are
        the floor, not growth). The admission METRIC stays pending until
        on_member_bound sees the gang reach min in cluster truth — an
        engine-aborted admission must not count."""
        if gang not in self._growing:
            self._bound_insert(self._growing, gang, initial)
            self._pending_admission[gang] = reason

    def on_member_bound(self, cluster, spec: WorkloadSpec,
                        n_bound: int | None = None) -> None:
        """A gang member bound. Counts growth binds (a bind into an
        already-admitted-below-desired gang) and retires the growing
        record once cluster truth shows the gang complete. The engine
        passes `n_bound` from its version-vector-memoised count so this
        hook adds no cluster walk of its own; None falls back to the
        direct walk (unit tests, exotic callers)."""
        gang = spec.gang_name
        pending = self._growing.get(gang)
        if pending is None and gang not in self._first_seen:
            return
        if n_bound is None:
            n_bound = bound_member_count(cluster, gang)
        if pending is None:
            # classic full assembly of a gang-min gang: retire its
            # deadline anchor at completion, or a later gang REUSING the
            # name would inherit a weeks-old _first_seen and be deadline-
            # pressed into admitting at min on its first eligible cycle
            if n_bound >= spec.gang_size:
                self._first_seen.pop(gang, None)
            return
        if pending > 0:
            self._growing[gang] = pending - 1
        elif self.metrics is not None:
            self.metrics.inc("gang_grow_total")
        reason = self._pending_admission.get(gang)
        if reason is not None and n_bound >= max(spec.gang_min, 1):
            # the admission STUCK: the gang runs at min under the record
            del self._pending_admission[gang]
            if self.metrics is not None:
                self.metrics.inc("gang_elastic_admissions_total",
                                 labels={"reason": reason})
        if n_bound >= spec.gang_size:
            self._growing.pop(gang, None)
            self._first_seen.pop(gang, None)  # name-reuse starts fresh
            if self.metrics is not None:
                self.metrics.inc("gang_elastic_completions_total")

    def on_member_evicted(self, spec: WorkloadSpec, reason: str) -> None:
        """A bound elastic-gang member was evicted (shrink-to-min): the
        gang is below desired again, so its re-placed members bind
        through the grow path and count as grows."""
        gang = spec.gang_name
        if gang not in self._growing:
            self._bound_insert(self._growing, gang, 0)
        if self.metrics is not None:
            self.metrics.inc("gang_shrink_total",
                             labels={"reason": reason})

    def reset(self, gang: str) -> None:
        """Assembly failed/doomed before any elastic admission stuck:
        drop the bookkeeping (a re-formed incarnation starts fresh).
        A never-confirmed admission dies uncounted here."""
        self._growing.pop(gang, None)
        self._first_seen.pop(gang, None)
        self._pending_admission.pop(gang, None)
