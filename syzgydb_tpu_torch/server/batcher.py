"""Server-side search micro-batching.

The reference serves each REST search with its own tree walk (rest.go:371-487).
On an accelerator a single query pays a fixed dispatch + result-fetch cost
while the card answers a 64-query batch in little more time, so the batcher
makes concurrent single-query REST traffic ride the batched path: the first
request for a compatible key becomes the group LEADER, waits a few
milliseconds for followers to pile on, then issues ONE
Collection.search_many() (or radius_many()) for the whole group and
distributes the per-query results.  The policy is the JAX package's
(``syzgydb_tpu/server/batcher.py``), unchanged.

Batching keys on (collection, mode, k, precision, filter_query): homogeneous
kNN searches share a device dispatch, and radius searches batch among
themselves — different radii may share a group, since the device escalation
loop runs at the group's shared top-k shape and each member post-filters to
its own radius (Collection.radius_many).  Callable filters and list-mode
queries bypass the batcher entirely.

A lone query on an idle server pays only one idle gap before dispatching;
once any follower joins, the leader waits for the window or for arrivals to
stop for one grow gap.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ..core.collection import Collection, SearchArgs, SearchResults

# The window and gap constants below are kept from the JAX package, where
# they were tuned against its accelerator's dispatch and fetch costs.  They
# are not yet measured on a CUDA card: chip_smoke.py's serving phase reports
# queries per dispatch at these values, and a sweep on the H100 is what may
# re-derive them.
DEFAULT_WINDOW_S = 0.016
# Two-phase window policy: a genuinely lone query dispatches after ONE idle
# gap; once any follower joins — or a same-key dispatch is in flight whose
# waiters will join on completion — the leader commits to the window.
IDLE_GAP_S = 0.006
# arrival-gap close for a formed group (see the leader loop): a wave that
# stopped growing this long ago dispatches without waiting out the window
GROW_GAP_S = 0.004
# Last-resort bound on follower waits so a leader thread killed in the
# narrow pre-dispatch window can never hang a request forever.  Must be far
# beyond any legitimate dispatch: a kernel's first launch builds it with
# nvcc inside the request.
FOLLOWER_TIMEOUT_S = 900.0
MAX_BATCH = 64
# Radius groups escalate k geometrically until every member's worst
# distance clears its radius; a wide group escalates to the most demanding
# member's k, so cap radius batches smaller than kNN ones
MAX_BATCH_RADIUS = 16


class _Group:
    __slots__ = ("members", "closed", "done", "leader_thread")

    def __init__(self):
        self.members: list[_Pending] = []
        self.closed = False
        self.done = threading.Event()
        # set by the creating (leader) thread so followers can detect a
        # leader that died before reaching its try/finally without waiting
        # out the full last-resort timeout
        self.leader_thread: Optional[threading.Thread] = None


class _Pending:
    __slots__ = ("args", "result", "error")

    def __init__(self, args: SearchArgs):
        self.args = args
        self.result: Optional[SearchResults] = None
        self.error: Optional[BaseException] = None


class SearchBatcher:
    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 max_batch: int = MAX_BATCH,
                 idle_gap_s: float = IDLE_GAP_S,
                 grow_gap_s: float = GROW_GAP_S):
        self.window_s = window_s
        self.max_batch = max_batch
        self.idle_gap_s = idle_gap_s
        self.grow_gap_s = grow_gap_s
        self._lock = threading.Lock()
        # leaders sleep on this instead of a poll loop: join() notifies, so
        # the only wakeups are real arrivals and the computed deadlines
        self._cond = threading.Condition(self._lock)
        self._groups: dict[tuple, _Group] = {}
        self._dispatching: dict[tuple, int] = {}  # per batch key
        # observability: how many device dispatches vs queries served
        self.dispatches = 0
        self.queries = 0

    @staticmethod
    def _mode(args: SearchArgs) -> Optional[str]:
        """Batchable dispatch mode: "knn", "radius", or None (bypass)."""
        if args.vector is None or args.filter is not None:
            return None
        if args.radius > 0:
            return "radius"
        if args.k > 0:
            return "knn"
        return None

    def search(self, coll: Collection, args: SearchArgs) -> SearchResults:
        mode = self._mode(args) if self.window_s > 0 else None
        if mode is not None:
            try:  # malformed vectors must fail their own request, not the
                # group: a right-length vector with a non-numeric element
                # would otherwise blow up the whole search_many batch
                v = np.asarray(args.vector, dtype=np.float64)
                if v.shape != (coll.dimension_count,):
                    mode = None
            except (TypeError, ValueError):
                mode = None
        if mode is None:
            return coll.search(args)
        cap = self.max_batch if mode == "knn" \
            else min(self.max_batch, MAX_BATCH_RADIUS)

        # batch_token, not id(coll): CPython reuses object addresses, so a
        # deleted collection's id() can alias a new one's and mix batches.
        # Radius groups ignore k (radius mode returns every in-radius row)
        # and coalesce across different radii.
        key = (coll.batch_token, mode, args.k if mode == "knn" else 0,
               args.precision or "medium", args.filter_query or "")
        pend = _Pending(args)
        with self._lock:
            group = self._groups.get(key)
            if group is None or group.closed or \
                    len(group.members) >= cap:
                group = _Group()
                group.leader_thread = threading.current_thread()
                self._groups[key] = group
                leader = True
            else:
                leader = False
            group.members.append(pend)
            if not leader:
                self._cond.notify_all()  # wake the leader: a member joined

        if not leader:
            # liveness-checked wait: poll in 1s slices so a leader thread
            # that died pre-dispatch wakes followers within ~1s; the long
            # FOLLOWER_TIMEOUT_S remains only for a LIVE leader stuck in a
            # legitimately long dispatch (a first launch that builds its
            # kernels)
            deadline = time.monotonic() + FOLLOWER_TIMEOUT_S
            while not group.done.wait(timeout=1.0):
                lt = group.leader_thread
                if lt is not None and not lt.is_alive() and \
                        not group.done.is_set():
                    # retire the zombie so subsequent requests start a
                    # fresh group instead of joining this one and failing
                    # for a full member-cap's worth of traffic
                    with self._lock:
                        group.closed = True
                        if self._groups.get(key) is group:
                            del self._groups[key]
                    raise RuntimeError(
                        "search batch leader thread died before dispatch")
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        "search batch timed out waiting for its leader "
                        "dispatch")
            if pend.error is not None:
                _reraise(pend.error)
            assert pend.result is not None
            return pend.result

        # leader: two-phase wait.  Phase 1: even an apparently lone query
        # waits one idle gap — under serving load the rest of a client wave
        # is usually mid-flight client-side, and a solo dispatch splinters
        # the wave.  Phase 2: once ANY follower joins, wait for the window
        # or for arrivals to stop for one grow gap.
        try:
            start = time.monotonic()
            deadline = start + self.window_s
            last_n, last_growth = 1, start
            with self._cond:
                while True:
                    now = time.monotonic()
                    n = len(group.members)
                    # only a SAME-KEY in-flight dispatch predicts imminent
                    # arrivals; unrelated collections' traffic must not
                    # make a lone query pay the full window
                    busy = self._dispatching.get(key, 0) > 0
                    if n >= cap or now >= deadline:
                        break
                    if n > last_n:
                        last_n, last_growth = n, now
                    if n == 1:
                        # lone query: dispatch after one idle gap unless a
                        # same-key dispatch in flight predicts arrivals
                        gap_end = start + self.idle_gap_s
                        if not busy and now >= gap_end:
                            break
                        wake = min(deadline, gap_end if not busy
                                   else deadline)
                    else:
                        # arrival-gap close: once a wave has joined and
                        # arrivals stop for grow_gap_s, dispatch instead of
                        # sitting out the window.  Closed-loop keep-alive
                        # clients otherwise lock-step on the same group,
                        # and the residual window is pure added latency.
                        gap_end = last_growth + self.grow_gap_s
                        if now >= gap_end:
                            break
                        wake = min(deadline, gap_end)
                    # sleep until the next decision point or a join; a
                    # notify re-evaluates immediately (no polling)
                    self._cond.wait(timeout=max(wake - now, 0.0))

            with self._lock:
                group.closed = True
                if self._groups.get(key) is group:
                    del self._groups[key]
                members = list(group.members)
            try:
                with self._lock:
                    self._dispatching[key] = self._dispatching.get(key, 0) + 1
                try:
                    if len(members) == 1:
                        members[0].result = coll.search(members[0].args)
                    elif mode == "radius":
                        res = coll.radius_many([m.args for m in members])
                        for m, r in zip(members, res, strict=True):
                            m.result = r
                    else:
                        res = coll.search_many([m.args for m in members])
                        for m, r in zip(members, res, strict=True):
                            m.result = r
                finally:
                    with self._lock:
                        n_d = self._dispatching.get(key, 1) - 1
                        if n_d:
                            self._dispatching[key] = n_d
                        else:
                            self._dispatching.pop(key, None)
                        self.dispatches += 1
                        self.queries += len(members)
                    # wake waiting leaders: a lone query sleeping out the
                    # window because this dispatch predicted arrivals must
                    # re-evaluate now that it finished
                    with self._cond:
                        self._cond.notify_all()
            except BaseException as exc:  # propagate to every member
                for m in members:
                    m.error = exc
        finally:
            # no matter where the leader died: close the group so future
            # requests start fresh, and wake every waiter with an error
            # rather than leaving them (and all future joiners) wedged
            with self._lock:
                group.closed = True
                if self._groups.get(key) is group:
                    del self._groups[key]
                waiters = list(group.members)
            if not group.done.is_set():
                for m in waiters:
                    if m.result is None and m.error is None:
                        m.error = RuntimeError("search batch leader aborted")
                group.done.set()
        if pend.error is not None:
            _reraise(pend.error)
        assert pend.result is not None
        return pend.result


def _reraise(exc: BaseException):
    """Raise a fresh same-type exception per waiter: up to max_batch threads
    re-raising ONE shared instance race on its __traceback__ and chain each
    other's frames into the logged stack."""
    try:
        raise type(exc)(*exc.args) from exc
    except TypeError:
        raise exc
