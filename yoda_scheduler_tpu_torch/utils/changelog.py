"""Bounded change log: version counter + recent-changes ring.

Shared by the cluster backends and the telemetry store so per-cycle
consumers (incremental snapshots, the unschedulable-class memo) can ask
"what changed since version V" instead of rescanning everything. One
implementation because the boundary condition in changes_since (`log[0]
version > V+1` = trimmed past the caller, full rebuild required) is easy
to get subtly wrong in copies.

Changes optionally carry a DIRECTION: `grew=False` marks a change that
can only have consumed capacity on the key (a bind, a reservation).
Within the per-node-predicate envelope the feasible/unschedulable class
memos operate under (capacity-monotone filters only — pods with
inter-pod terms never take that path), a shrink can never flip a node
infeasible->feasible, so repair paths skip re-filtering such nodes when
hunting for NEWLY feasible ones. `grew=True` (the default) is the
conservative direction: always safe to report.

Thread-safety: record() must be called under the owner's lock; version
reads are single-int reads (GIL-atomic).
"""

from __future__ import annotations


class ChangeLog:
    __slots__ = ("version", "_log", "_cap")

    def __init__(self, cap: int = 8192) -> None:
        self.version = 0
        self._log: list[tuple[int, str, bool]] = []  # (version, key, grew)
        self._cap = cap

    def record(self, key: str, grew: bool = True) -> int:
        """Bump the version, attributing the change to `key`. `grew=False`
        promises the change only consumed capacity on the key (see module
        docstring). Returns the new version. Caller holds the owner's
        lock."""
        self.version += 1
        self._log.append((self.version, key, grew))
        if len(self._log) > self._cap:
            del self._log[: len(self._log) - self._cap]
        return self.version

    def changes_since(self, version: int) -> tuple[int, set[str] | None]:
        """(current version, keys changed after `version`) — None for the
        key set when the log no longer reaches back that far (the caller
        must rebuild from scratch)."""
        cur, dirty, _ = self.changes_since_directed(version)
        return cur, dirty

    def changes_since_directed(
            self, version: int
    ) -> tuple[int, set[str] | None, set[str] | None]:
        """(current version, dirty keys, keys with at least one GREW
        change) — both sets None when the log was trimmed past `version`.
        grew ⊆ dirty; a key changed only by shrinking updates appears in
        dirty but not grew."""
        cur = self.version
        if version >= cur:
            return cur, set(), set()
        if not self._log or self._log[0][0] > version + 1:
            return cur, None, None
        # versions are appended in increasing order: bisect to the first
        # entry past `version` instead of scanning the whole ring (hot on
        # the per-class feasible-repair path at 1000 nodes)
        from bisect import bisect_right

        i = bisect_right(self._log, version, key=lambda e: e[0])
        dirty = set()
        grew = set()
        for _, k, g in self._log[i:]:
            dirty.add(k)
            if g:
                grew.add(k)
        return cur, dirty, grew
