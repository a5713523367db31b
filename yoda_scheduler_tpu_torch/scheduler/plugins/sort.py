"""Queue-sort plugin: strict priority by ``scv/priority`` label.

Reference: pkg/yoda/sort/sort.go:8-18 — higher label value schedules first,
absent/unparseable treated as 0. We add two tie-breaks the reference lacks:

- **most-constrained-first** among equal priority: gang members first
  (a gang consumes whole hosts across one slice — the largest structural
  demand), then pods pinned to an exact ICI block shape
  (``tpu/topology``), then FIFO. Classic bin-packing order — gangs and
  block-shaped jobs place while slices are still whole, instead of
  retrying against space the easy pods fragmented; easy pods lose a
  cycle or two, hard pods stop paying the whole queue's length in wait.
  Only STRUCTURAL constraints rank; plain chip count deliberately does
  not (reordering 2-chip jobs ahead of 1-chip jobs spends the same chips
  on fewer pods under capacity pressure, with no contiguity gain to show
  for it).
- FIFO on enqueue time last, so equal-priority/equal-constraint pods cannot
  starve each other (the reference's comparator is not a strict weak order
  on ties; upstream's queue happened to mask that).
"""

from __future__ import annotations

from ..framework import QueueSortPlugin, QueuedPodInfo
from ...utils.labels import GANG_NAME_LABEL, PRIORITY_LABEL, TOPOLOGY_LABEL


def pod_priority(info: QueuedPodInfo) -> int:
    raw = info.pod.labels.get(PRIORITY_LABEL)
    if raw is None:
        return 0
    try:
        return int(raw)
    except ValueError:
        return 0  # queue sort cannot reject; the filter will surface the error


def constraint_rank(info: QueuedPodInfo) -> int:
    """Structural placement difficulty of a pod — higher schedules first
    within a priority band. Gang > exact-topology > unconstrained."""
    labels = info.pod.labels
    rank = 0
    if GANG_NAME_LABEL in labels:
        rank += 2
    if TOPOLOGY_LABEL in labels:
        rank += 1
    return rank


class PrioritySort(QueueSortPlugin):
    name = "priority-sort"

    def equivalence_key(self, pod):
        """Batch-cycle contract: ordering reads only the priority and
        constraint labels, all inside the WorkloadSpec the engine's memo
        key already carries — classmates sort identically."""
        return ()

    def less(self, a: QueuedPodInfo, b: QueuedPodInfo) -> bool:
        pa, pb = pod_priority(a), pod_priority(b)
        if pa != pb:
            return pa > pb
        ca, cb = constraint_rank(a), constraint_rank(b)
        if ca != cb:
            return ca > cb
        return a.enqueued < b.enqueued

    def key(self, info: QueuedPodInfo):
        """Sort key consistent with less(): lets the queue use a heap
        (O(log n) pop) instead of a comparator scan (O(n))."""
        return (-pod_priority(info), -constraint_rank(info), info.enqueued)
