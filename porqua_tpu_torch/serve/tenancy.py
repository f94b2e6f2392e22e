"""Tenancy as a serving dimension: quotas + fair share (a host copy of
``porqua_tpu/serve/tenancy.py``).

* :class:`TenantAdmission` — per-tenant bounded sub-queue accounting
  shared by ``SolveService.submit`` (admit/shed) and the batchers
  (release at dequeue). A tenant over its quota sheds at its own
  sub-queue (:class:`~porqua_tpu_torch.serve.service.QueueFull`,
  counted per tenant) instead of filling the shared queue.
* :class:`FairPendingQueue` — the per-bucket pending structure both
  batchers drain: per-tenant FIFO deques dequeued by deficit round
  robin (per-request cost 1, quantum = the tenant's weight), so a
  bursting tenant's backlog interleaves 1:1 (at equal weights) with a
  quiet tenant's requests.

Tenancy is host-side scheduling and attribution only: no solve entry
sees a tenant, and requests of different tenants share batches once
dequeued.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

from porqua_tpu_torch.analysis import tsan

__all__ = ["DEFAULT_TENANT", "FairPendingQueue", "TenantAdmission"]

#: The tenant id untagged requests are accounted under. Every request
#: has a tenant from the scheduler's point of view; callers that never
#: pass one simply all share this lane (bit-identical scheduling to
#: the pre-tenant service when it is the only tenant).
DEFAULT_TENANT = "default"


class TenantAdmission:
    """Per-tenant bounded sub-queue accounting (quota enforcement).

    ``quota`` is the per-tenant cap on requests queued-or-pending at
    once: an ``int`` applies to every tenant, a ``{tenant: int}`` dict
    sets per-tenant caps (missing tenants fall back to
    ``default_quota``; ``None`` anywhere = unbounded, i.e. only the
    shared physical queue bounds that tenant). ``try_admit`` runs on
    submitter threads and the depth decrements on the dispatch thread
    (via :meth:`FairPendingQueue.popleft`), so the counters are
    lock-guarded.
    """

    #: The lane tenants beyond ``max_tenants`` share (same bounding
    #: posture as ``ServeMetrics``: tenant ids are caller-supplied
    #: strings, and an id-spraying client must not grow the scheduler
    #: dicts — or the ``/healthz`` depths payload — without limit).
    OVERFLOW = "(overflow)"

    def __init__(self, quota=None, default_quota: Optional[int] = None,
                 max_tenants: int = 1024) -> None:
        if isinstance(quota, dict):
            self._quotas: Dict[str, Optional[int]] = {
                str(k): (None if v is None else int(v))
                for k, v in quota.items()}
            self._default = (None if default_quota is None
                             else int(default_quota))
        else:
            self._quotas = {}
            self._default = (int(quota) if quota is not None
                             else (None if default_quota is None
                                   else int(default_quota)))
        self._max_tenants = int(max_tenants)
        self._lock = tsan.lock("TenantAdmission")
        self._depth: Dict[str, int] = {}   # guarded-by: self._lock
        self._sheds: Dict[str, int] = {}   # guarded-by: self._lock

    def quota_for(self, tenant: str) -> Optional[int]:
        return self._quotas.get(tenant, self._default)

    def _lane(self, tenant: str) -> str:  # guarded-by: self._lock
        """The accounting lane for ``tenant``: itself while the
        registry has room (or it is already tracked / explicitly
        configured), the shared overflow lane past ``max_tenants``.
        Deterministic across admit/release for the life of the
        process: a tenant first seen at capacity maps to the overflow
        lane on BOTH calls (it is never inserted as itself)."""
        if tenant in self._depth or tenant in self._quotas \
                or len(self._depth) < self._max_tenants:
            return tenant
        return self.OVERFLOW

    def try_admit(self, tenant: str) -> bool:
        """Reserve one slot in ``tenant``'s sub-queue; ``False`` means
        the tenant is at quota and this request must shed (the caller
        raises ``QueueFull`` and counts the rejection per tenant)."""
        with self._lock:
            lane = self._lane(tenant)
            quota = self.quota_for(lane)
            depth = self._depth.get(lane, 0)
            if quota is not None and depth >= quota:
                self._sheds[lane] = self._sheds.get(lane, 0) + 1
                return False
            self._depth[lane] = depth + 1
            return True

    def release(self, tenant: str) -> None:
        """One request left the queued/pending window (dequeued for
        dispatch, expired at batch formation, or failed at cohort
        teardown — every dequeue path releases exactly once)."""
        with self._lock:
            lane = self._lane(tenant)
            depth = self._depth.get(lane, 0)
            if depth > 0:
                self._depth[lane] = depth - 1

    def depth(self, tenant: str) -> int:
        with self._lock:
            return self._depth.get(tenant, 0)

    def depths(self) -> Dict[str, int]:
        """Per-tenant queued-or-pending depth (the ``/healthz``
        tenants section reads this)."""
        with self._lock:
            return dict(self._depth)

    def sheds(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._sheds)


class FairPendingQueue:
    """Per-bucket pending requests: per-tenant FIFOs + DRR dequeue.

    Drop-in for the plain ``collections.deque`` the batchers kept per
    bucket — same surface (``append`` / ``popleft`` / ``len`` /
    truthiness / ``[0]``) plus :meth:`oldest_submitted` for the age
    trigger. Only the single dispatch thread touches an instance, so
    there is no lock; the shared :class:`TenantAdmission` (which IS
    cross-thread) release happens inside :meth:`popleft` so every
    dequeue path — batch formation, expiry filtering, cohort staging,
    drain-on-stop — releases the tenant's sub-queue slot exactly once.

    Deficit round robin, per-request cost 1: each tenant's turn grants
    ``weight`` credits (default 1.0); a tenant with queued work and
    >= 1 credit surrenders one credit per dequeued request. At equal
    weights this interleaves tenants 1:1 however deep any one backlog
    is; weights > 1 grant proportionally more slots. An emptied
    tenant's deficit resets (classic DRR — credit must not accrue
    while idle).
    """

    def __init__(self, admission: Optional[TenantAdmission] = None,
                 weights: Optional[Dict[str, float]] = None) -> None:
        self.admission = admission
        self._weights = dict(weights or {})
        self._queues: Dict[str, collections.deque] = {}
        self._order: List[str] = []   # active tenants, ring order
        self._idx = 0                 # ring cursor
        self._deficit: Dict[str, float] = {}
        self._len = 0

    # -- deque surface -------------------------------------------------

    def append(self, req) -> None:
        tenant = getattr(req, "tenant", None) or DEFAULT_TENANT
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = collections.deque()
            self._order.append(tenant)
            self._deficit.setdefault(tenant, 0.0)
        q.append(req)
        self._len += 1

    def _retire_tenant(self, tenant: str) -> None:
        i = self._order.index(tenant)
        del self._order[i]
        del self._queues[tenant]
        # Delete rather than zero: an idle tenant accrues no credit
        # either way (re-append starts from 0.0), and keeping the key
        # would grow the dict one entry per distinct tenant id ever
        # seen — unbounded under caller-supplied ids.
        self._deficit.pop(tenant, None)
        if i < self._idx:
            self._idx -= 1
        if self._order:
            self._idx %= len(self._order)
        else:
            self._idx = 0

    def popleft(self):
        """Dequeue the next request per DRR (releases its admission
        slot). Raises ``IndexError`` when empty, like a deque."""
        if not self._len:
            raise IndexError("pop from an empty FairPendingQueue")
        while True:
            tenant = self._order[self._idx % len(self._order)]
            if self._deficit.get(tenant, 0.0) < 1.0:
                # Grant this tenant's quantum and move on; it is
                # served on a later pass once its credit reaches 1.
                # Quanta are >= a positive weight, so the loop always
                # terminates within O(1/min_weight) passes.
                self._deficit[tenant] = (self._deficit.get(tenant, 0.0)
                                         + max(self._weights.get(tenant, 1.0),
                                               1e-3))
                self._idx = (self._idx + 1) % len(self._order)
                continue
            self._deficit[tenant] -= 1.0
            q = self._queues[tenant]
            req = q.popleft()
            self._len -= 1
            if not q:
                self._retire_tenant(tenant)
            if self.admission is not None:
                self.admission.release(getattr(req, "tenant", None)
                                       or DEFAULT_TENANT)
            return req

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __getitem__(self, i: int):
        """``dq[0]`` — the batchers' age-trigger peek: the OLDEST
        queued request across every tenant (the request whose deadline
        pressure drives the wakeup horizon)."""
        if i != 0 or not self._len:
            raise IndexError("FairPendingQueue only exposes [0] (peek)")
        return min((q[0] for q in self._queues.values() if q),
                   key=lambda r: r.submitted)

    def oldest_submitted(self) -> Optional[float]:
        if not self._len:
            return None
        return min(q[0].submitted for q in self._queues.values() if q)

    def tenants(self) -> List[str]:
        """Tenants with queued work, in current ring order."""
        return list(self._order)
