"""Lease-based leader election + per-shard scheduling leases.

The reference inherits leader election from upstream kube-scheduler,
configured lease 15s / renew 10s / retry 2s (reference
deploy/yoda-scheduler.yaml:10-17). Native equivalent over the
coordination.k8s.io/v1 Lease API with the same timing defaults, injectable
clock + client so the state machine is unit-testable without a cluster.

Fleet extension (scheduler/fleet.py): instead of one leader and idle
standbys, node-pool SHARDS map to leases (``yoda-shard-<i>``) and every
replica schedules concurrently, holding the leases for its shards. Two
mechanisms make that safe:

- **fencing epochs**: every lease carries ``leaseTransitions``, bumped on
  each change of holder. A bind carries ``(lease, holder, transitions)``
  as its fencing token and the authority (fake_apiserver /
  FakeCluster.lease_authority) rejects commits whose token is stale —
  a replica that lost its lease mid-bind (split-brain, GC pause past the
  lease duration) cannot silently write.
- **sub-second renewal**: the Lease API's ``leaseDurationSeconds`` is an
  integer — sub-second configs would truncate to 0 (= instantly
  expired). Durations now serialize as ``ceil`` (never 0) and the exact
  float rides a ``yodaDurationMs`` spec extension that this module's own
  expiry checks prefer (a real apiserver drops the unknown field, leaving
  the integer ceiling — strictly safer, never looser). Renewal retries
  are jittered 0.5-1.5x so a replica fleet doesn't thundering-herd the
  Lease objects.
"""

from __future__ import annotations

import logging
import math
import random
import socket
import threading
import time
import uuid

log = logging.getLogger("yoda-tpu.le")

LEASE_PATH = ("/apis/coordination.k8s.io/v1/namespaces/{ns}/leases/{name}")
SHARD_LEASE_PREFIX = "yoda-shard-"
# replica liveness heartbeats (dynamic shard rebalancing): each fleet
# replica renews `yoda-replica-<idx>` alongside its shard leases. A
# replica holding a foreign shard (crash takeover) watches the PREFERRED
# owner's heartbeat and hands the shard back the moment that replica is
# provably alive again — without this, takeover ownership was sticky
# forever. A distinct prefix so a heartbeat can never be mistaken for a
# fencing lease.
REPLICA_HB_PREFIX = "yoda-replica-"


def _duration_fields(duration_s: float) -> dict:
    """Serialize a float lease duration: integer-second API field (ceil,
    never the 0 a truncation produced) + the exact float extension."""
    return {
        "leaseDurationSeconds": max(int(math.ceil(duration_s)), 1),
        "yodaDurationMs": int(duration_s * 1000),
    }


def _duration_of(spec: dict, default_s: float) -> float:
    ms = spec.get("yodaDurationMs")
    if ms is not None:
        try:
            return float(ms) / 1000.0
        except (TypeError, ValueError):
            pass
    return float(spec.get("leaseDurationSeconds", default_s))


class LeaderElector:
    def __init__(self, client, name: str = "yoda-tpu-scheduler",
                 namespace: str = "kube-system",
                 lease_duration_s: float = 15.0,
                 renew_deadline_s: float = 10.0,
                 retry_period_s: float = 2.0,
                 identity: str | None = None,
                 clock=time) -> None:
        self.client = client
        self.path = LEASE_PATH.format(ns=namespace, name=name)
        self.name = name
        self.namespace = namespace
        self.lease_duration_s = lease_duration_s
        self.renew_deadline_s = renew_deadline_s
        self.retry_period_s = retry_period_s
        self.identity = identity or f"{socket.gethostname()}_{uuid.uuid4().hex[:8]}"
        self.clock = clock
        self.is_leader = False
        # fencing epoch: the lease's leaseTransitions while we hold it —
        # carried on binds so a stale ex-leader's commits are rejectable
        self.transitions = 0
        self._rng = random.Random()

    # ------------------------------------------------------------ lease CRUD
    def _get(self) -> dict | None:
        try:
            return self.client.request("GET", self.path)
        except Exception:
            return None

    def _create(self) -> bool:
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": self._spec(1),
        }
        try:
            self.client.request(
                "POST",
                f"/apis/coordination.k8s.io/v1/namespaces/{self.namespace}/leases",
                body)
            self.transitions = 1
            return True
        except Exception:
            return False

    def _update(self, lease: dict, transitions: int) -> bool:
        lease = dict(lease)
        lease["spec"] = self._spec(transitions)
        try:
            self.client.request("PUT", self.path, lease)
            self.transitions = transitions
            return True
        except Exception:
            return False

    def _spec(self, transitions: int) -> dict:
        now = self.clock.time()
        return {
            "holderIdentity": self.identity,
            **_duration_fields(self.lease_duration_s),
            "renewTime": _micro_time(now),
            "acquireTime": _micro_time(now),
            # bumped on every change of HOLDER (client-go semantics):
            # the fencing epoch carried on binds
            "leaseTransitions": transitions,
        }

    def fence(self) -> tuple[str, str, int] | None:
        """Fencing token for binds: (lease name, holder, transitions) —
        None while not leading."""
        if not self.is_leader:
            return None
        return (self.name, self.identity, self.transitions)

    # --------------------------------------------------------- state machine
    def try_acquire_or_renew(self) -> bool:
        lease = self._get()
        if lease is None:
            acquired = self._create()
            self.is_leader = acquired
            return acquired
        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity")
        prev_transitions = int(spec.get("leaseTransitions", 0) or 0)
        if holder == self.identity:
            self.is_leader = self._update(lease, prev_transitions or 1)
            return self.is_leader
        renew = _parse_micro_time(spec.get("renewTime"))
        expired = (renew is None or
                   self.clock.time() - renew > _duration_of(
                       spec, self.lease_duration_s))
        # a change of holder bumps the fencing epoch: the previous
        # holder's in-flight binds carry the old transitions count and
        # the authority rejects them
        if expired and self._update(lease, prev_transitions + 1):
            log.info("%s acquired expired lease from %s", self.identity, holder)
            self.is_leader = True
            return True
        self.is_leader = False
        return False

    def _jittered(self, period: float) -> float:
        # 0.5-1.5x: candidate fleets must not retry in lockstep
        return period * self._rng.uniform(0.5, 1.5)

    def run_until_leader(self, stop: threading.Event) -> None:
        """Block until we hold the lease (retry every retry_period_s,
        jittered), then keep renewing in a daemon thread; on renew
        failure, release leadership and set `stop` (the reference
        posture: losing the lease kills the process so a standby takes
        over)."""
        while not stop.is_set() and not self.try_acquire_or_renew():
            stop.wait(self._jittered(self.retry_period_s))
        if stop.is_set():
            return
        log.info("became leader: %s", self.identity)

        def renew_loop():
            # retry every retry_period (jittered); step down only after
            # the renew deadline elapses without ONE success — a single
            # dropped request must not kill the only scheduler replica
            # (client-go semantics, reference deploy/yoda-scheduler.yaml
            # :12-17 timing)
            last_success = self.clock.time()
            while not stop.wait(self._jittered(self.retry_period_s)):
                if self.try_acquire_or_renew():
                    last_success = self.clock.time()
                elif self.clock.time() - last_success > self.renew_deadline_s:
                    log.error("lost leadership (no renew within %.0fs); stopping",
                              self.renew_deadline_s)
                    stop.set()
                    return

        threading.Thread(target=renew_loop, daemon=True).start()


class ShardLeaseManager:
    """Leases-per-shard over the k8s Lease API: the wire twin of
    scheduler/fleet.py's LocalLeaseStore upkeep. A fleet replica owns a
    set of shard leases (``yoda-shard-<i>``), renews them sub-second, and
    carries each shard's fencing token on binds into that shard's nodes.

    ``preferred`` names the shards this replica tries to ACQUIRE when they
    are free or expired (None = any); owned shards are always renewed.
    Lost shards (renew failed: another holder, or the PUT raced a
    takeover's resourceVersion bump) simply leave ``owned`` — the caller's
    fence_provider then aborts the one in-flight commit and schedules the
    shard's pods unfenced/elsewhere. step() is synchronous and cheap; the
    caller decides the cadence (sub-second for sub-second durations)."""

    def __init__(self, client, shard_count: int,
                 identity: str | None = None,
                 namespace: str = "kube-system",
                 prefix: str = SHARD_LEASE_PREFIX,
                 lease_duration_s: float = 1.0,
                 preferred: set[int] | None = None,
                 clock=time, replica_count: int | None = None,
                 replica_idx: int | None = None,
                 rebalance: bool = False) -> None:
        self.client = client
        self.shard_count = shard_count
        self.identity = identity or f"{socket.gethostname()}_{uuid.uuid4().hex[:8]}"
        self.namespace = namespace
        self.prefix = prefix
        self.lease_duration_s = lease_duration_s
        self.preferred = preferred
        self.clock = clock
        self.owned: dict[int, int] = {}  # shard -> transitions epoch
        # dynamic rebalancing (needs the fleet geometry): shard s's
        # preferred owner is replica s % replica_count; this replica
        # heartbeats `yoda-replica-<replica_idx>` and releases foreign
        # shards whose preferred owner's heartbeat is live again
        self.replica_count = replica_count
        self.replica_idx = replica_idx
        self.rebalance = rebalance and replica_count is not None \
            and replica_idx is not None
        # shard -> first instant its lease was observed ABSENT: the
        # orphan guard — a preferrer that died before ever creating its
        # lease must not leave the shard unowned forever
        self._absent_since: dict[int, float] = {}
        # per-step heartbeat-liveness memo (see _hb_live)
        self._hb_memo: dict[int, bool] = {}
        self.rebalance_releases = 0
        self.takeovers = 0

    def _name(self, shard: int) -> str:
        return f"{self.prefix}{shard}"

    def _path(self, shard: int) -> str:
        return LEASE_PATH.format(ns=self.namespace, name=self._name(shard))

    def _spec(self, transitions: int) -> dict:
        now = self.clock.time()
        return {
            "holderIdentity": self.identity,
            **_duration_fields(self.lease_duration_s),
            "renewTime": _micro_time(now),
            "acquireTime": _micro_time(now),
            "leaseTransitions": transitions,
        }

    def fence(self, shard: int) -> tuple[str, str, int] | None:
        epoch = self.owned.get(shard)
        if epoch is None:
            return None
        return (self._name(shard), self.identity, epoch)

    def validate_fence(self, fence: tuple) -> bool:
        """Authority-side check (shared interface with LocalLeaseStore so
        FakeCluster.lease_authority can be either): does the named lease
        still belong to this holder at this epoch?"""
        name, holder, epoch = fence
        try:
            lease = self.client.request(
                "GET", LEASE_PATH.format(ns=self.namespace, name=name))
        except Exception:
            return False
        spec = (lease or {}).get("spec", {})
        return (spec.get("holderIdentity") == holder
                and int(spec.get("leaseTransitions", 0) or 0) == int(epoch))

    def step(self) -> None:
        """One upkeep pass: heartbeat (when rebalancing), renew every
        owned shard (dropping the lost), release foreign shards whose
        preferred owner is alive again, then try to acquire free/expired
        shards this replica prefers — plus provably-orphaned ones."""
        now = self.clock.time()
        self._hb_memo.clear()  # liveness re-read once per pass
        if self.rebalance:
            self._heartbeat()
        for shard in list(self.owned):
            if not self._renew(shard):
                self.owned.pop(shard, None)
                log.warning("%s lost shard lease %d", self.identity, shard)
        if self.rebalance:
            for shard in list(self.owned):
                pref = shard % self.replica_count
                if pref == self.replica_idx:
                    continue
                if self._hb_live(pref):
                    # the preferred owner is provably back: hand the
                    # shard over (epoch retired so our in-flight fences
                    # die with it) instead of staying sticky forever
                    if self._release(shard):
                        self.owned.pop(shard, None)
                        self.rebalance_releases += 1
                        log.info("%s released shard %d to replica %d",
                                 self.identity, shard, pref)
        for shard in range(self.shard_count):
            if shard in self.owned:
                continue
            if self.preferred is not None and shard not in self.preferred:
                if self.rebalance and self._hb_live(
                        shard % self.replica_count):
                    # alive preferrer: the shard is theirs to (re)take —
                    # acquiring it would instantly undo a rebalance
                    # release (see ShardLeaseManager step docstring)
                    self._absent_since.pop(shard, None)
                    continue
                lease = self._get(shard)
                if lease is None:
                    # absent: leave it to its preferrer — unless
                    # rebalancing is on AND it has stayed absent past a
                    # full lease duration (the preferrer died before
                    # ever creating it): the orphan guard claims it.
                    # Without rebalancing there is no handback either,
                    # so claiming here would permanently rob a peer
                    # that merely started late.
                    first = self._absent_since.setdefault(shard, now)
                    if not self.rebalance \
                            or now - first <= self.lease_duration_s:
                        continue
                else:
                    self._absent_since.pop(shard, None)
                    # non-preferred shards are only taken over once
                    # their holder has provably expired (crash takeover)
                    if not self._lease_expired(lease):
                        continue
            if self._acquire(shard):
                self._absent_since.pop(shard, None)
                if self.owned.get(shard, 1) > 1:
                    self.takeovers += 1

    # ------------------------------------------------------------- internals
    def _get(self, shard: int) -> dict | None:
        try:
            return self.client.request("GET", self._path(shard))
        except Exception:
            return None

    def _lease_expired(self, lease: dict) -> bool:
        spec = lease.get("spec", {})
        renew = _parse_micro_time(spec.get("renewTime"))
        return (renew is None or self.clock.time() - renew >
                _duration_of(spec, self.lease_duration_s))

    def _expired(self, shard: int) -> bool:
        lease = self._get(shard)
        if lease is None:
            return False  # absent = never owned; leave it to its preferrer
        return self._lease_expired(lease)

    # ------------------------------------------- heartbeats + rebalancing
    def _hb_path(self, idx: int) -> str:
        return LEASE_PATH.format(ns=self.namespace,
                                 name=f"{REPLICA_HB_PREFIX}{idx}")

    def _hb_live(self, idx: int) -> bool:
        """Is replica `idx` provably alive (its heartbeat lease held and
        unexpired)? Identity is NOT checked: any incarnation serving the
        index counts — the handoff goes to the slot, not the process.
        Memoized per step() pass: `shard % replica_count` takes at most
        replica_count distinct values, so without the memo a 32-shard
        fleet would re-GET the same one or two heartbeat leases once per
        shard per upkeep tick."""
        memo = self._hb_memo
        if idx in memo:
            return memo[idx]
        try:
            lease = self.client.request("GET", self._hb_path(idx),
                                        timeout=3.0, retries=0)
        except Exception:
            memo[idx] = False
            return False
        spec = (lease or {}).get("spec", {}) or {}
        memo[idx] = bool(spec.get("holderIdentity")) \
            and not self._lease_expired(lease)
        return memo[idx]

    def _heartbeat(self) -> None:
        """Acquire-or-renew this replica's own liveness lease. A fresh
        incarnation waits out the dead one's remaining duration (the
        conservative read: liveness must never be claimable early)."""
        try:
            lease = self.client.request(
                "GET", self._hb_path(self.replica_idx),
                timeout=3.0, retries=0)
        except Exception:
            lease = None
        if lease is None:
            body = {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                    "metadata": {
                        "name": f"{REPLICA_HB_PREFIX}{self.replica_idx}",
                        "namespace": self.namespace},
                    "spec": self._spec(1)}
            try:
                self.client.request(
                    "POST",
                    f"/apis/coordination.k8s.io/v1/namespaces/"
                    f"{self.namespace}/leases", body)
            except Exception:
                pass
            return
        spec = lease.get("spec", {})
        if spec.get("holderIdentity") != self.identity \
                and not self._lease_expired(lease):
            return  # a live foreign incarnation still owns the slot
        transitions = int(spec.get("leaseTransitions", 0) or 0)
        if spec.get("holderIdentity") != self.identity:
            transitions += 1
        lease = dict(lease)
        lease["spec"] = self._spec(max(transitions, 1))
        try:
            self.client.request("PUT", self._hb_path(self.replica_idx),
                                lease)
        except Exception:
            pass

    def _release(self, shard: int) -> bool:
        """Voluntarily give a shard up: holder cleared, epoch bumped (our
        in-flight fencing tokens are stale from this instant), renewTime
        cleared so the next claimant sees it immediately acquirable."""
        lease = self._get(shard)
        if lease is None:
            return False
        spec = lease.get("spec", {})
        if spec.get("holderIdentity") != self.identity or int(
                spec.get("leaseTransitions", 0) or 0) != self.owned.get(
                    shard):
            return False  # already taken over: nothing of ours to release
        lease = dict(lease)
        lease["spec"] = {
            "holderIdentity": None,
            **_duration_fields(self.lease_duration_s),
            "renewTime": None, "acquireTime": None,
            "leaseTransitions": int(spec.get("leaseTransitions", 0) or 0)
            + 1,
        }
        try:
            self.client.request("PUT", self._path(shard), lease)
            return True
        except Exception:
            return False

    def _renew(self, shard: int) -> bool:
        lease = self._get(shard)
        if lease is None:
            return False
        spec = lease.get("spec", {})
        if spec.get("holderIdentity") != self.identity or int(
                spec.get("leaseTransitions", 0) or 0) != self.owned[shard]:
            return False  # taken over: our epoch is history
        lease = dict(lease)
        lease["spec"] = self._spec(self.owned[shard])
        try:
            self.client.request("PUT", self._path(shard), lease)
            return True
        except Exception:
            return False

    def _acquire(self, shard: int) -> bool:
        lease = self._get(shard)
        if lease is None:
            body = {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {"name": self._name(shard),
                             "namespace": self.namespace},
                "spec": self._spec(1),
            }
            try:
                self.client.request(
                    "POST",
                    f"/apis/coordination.k8s.io/v1/namespaces/"
                    f"{self.namespace}/leases", body)
                self.owned[shard] = 1
                return True
            except Exception:
                return False
        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity")
        renew = _parse_micro_time(spec.get("renewTime"))
        expired = (renew is None or self.clock.time() - renew >
                   _duration_of(spec, self.lease_duration_s))
        if holder != self.identity and not expired:
            return False
        transitions = int(spec.get("leaseTransitions", 0) or 0)
        if holder != self.identity:
            transitions += 1  # change of holder = fencing epoch bump
        lease = dict(lease)
        lease["spec"] = self._spec(max(transitions, 1))
        try:
            # the resourceVersion-conditional PUT is the tie-break: two
            # racing claimants of an expired lease are serialized by the
            # apiserver's optimistic concurrency (loser gets 409)
            self.client.request("PUT", self._path(shard), lease)
            self.owned[shard] = max(transitions, 1)
            return True
        except Exception:
            return False


def _micro_time(t: float) -> str:
    from datetime import datetime, timezone

    return datetime.fromtimestamp(t, timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%f") + "Z"


def _parse_micro_time(s: str | None) -> float | None:
    if not s:
        return None
    from datetime import datetime, timezone

    try:
        return datetime.strptime(
            s.replace("Z", ""), "%Y-%m-%dT%H:%M:%S.%f").replace(
                tzinfo=timezone.utc).timestamp()
    except ValueError:
        return None
