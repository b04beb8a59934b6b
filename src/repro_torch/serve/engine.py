"""QueryEngine: async multi-tenant serving over one Database (port of
``repro.serve.engine``; DESIGN.md §3.8).

The paper makes each nearest-neighbour query cheap so a *server* can
answer more of them per second; this module is that server.  One
:class:`repro_torch.api.Database` session (build-once artifacts:
envelopes, norms, stage-0 index, the rows on the device) is shared by
every client:

    engine = QueryEngine(db, max_batch=8, max_wait_ms=2.0)
    fut = engine.submit(q, k=5, tenant="mobile", deadline=0.05)
    ans = fut.result()          # Answer: distances/indices/stats + meta
    sess = engine.open_stream(threshold=3.0)   # streaming, same session
    engine.stats()              # queue depth, occupancy, hit rate, qps

The request path is admission -> coalesce -> plan -> cache:

* **admission** — ``submit`` validates the query against the session up
  front (shape, length, k) and enqueues it on a bounded per-tenant
  FIFO; a full queue raises :class:`AdmissionFull` *at the caller*
  (backpressure, never silent dropping), and a request whose
  ``deadline`` lapses before execution fails its future with
  :class:`DeadlineExceeded` instead of wasting a batch lane.
* **coalesce** — a worker thread drains the tenant queues round-robin
  into query-major microbatches (the §3.4 execution shape): a batch is
  held open until ``max_batch`` lanes fill or the oldest admitted
  request has waited ``max_wait_ms``.  Requests whose z-normed digests
  collide share one lane (identical-in-flight traffic executes once and
  fans out), and a batch only admits requests with one execution key
  (k, method, driver) so it maps onto a single ``db.search`` call.
* **plan / execute** — the padded ``(max_batch, n)`` block rides the
  session's planner-routed batched driver, one shape for the engine's
  lifetime.  Per-lane results are bit-identical to a direct
  ``db.search`` of the same batch, so the engine adds zero numeric
  surface.
* **cache** — cold answers are stored in the LRU
  :class:`repro_torch.serve.cache.AnswerCache` keyed on the session
  fingerprint + execution key + z-normed query bytes; hits resolve at
  ``submit`` time without occupying a lane and return the stored
  arrays bit-identical to the cold path.

Streaming shares the same session: :meth:`QueryEngine.open_stream`
multiplexes any number of :class:`StreamSession` wrappers (each a
``db.stream`` matcher behind a lock) over the build-once artifacts,
concurrent with the batch worker.

Threads and the device: the worker and every stream client launch
kernels from their own threads, all on the device's current (default)
stream, so their launches run in the order they were enqueued.  Each
launch allocates its own outputs and workspace (the caching allocator
is stream-ordered), the kernel library loads once under a lock, and the
launch counters and LB_Kim's tickets are taken under locks
(``kernels/common.py``).

Anytime serving (``mode="anytime"``, sessions built with an anytime
tier) rides the same path: a batch of like-keyed requests is one
``db.search(mode="anytime", budget=)`` call over its real lanes only,
and a request's ``deadline`` maps onto a budget through the engine's
refine-rate EMA.

A session whose mesh spans several ranks (``Database.use_mesh`` over a
multi-rank ``torch.distributed`` group, one process a rank) is served
from one controller, as the reference serves it: every rank builds the
same session, attaches the mesh and makes the engine with the same
arguments.  Rank 0 admits, coalesces, caches and keeps the stats; before
it runs a batch that its planner routes to the sharded driver it sends
the execution key and the padded block to every other rank
(``Mesh.broadcast_batch``), whose follower thread runs the same
``db.search``, so every rank issues the same sharded searches in the
same order.  Cache hits, expired requests, the scan, host and indexed
routes and anytime batches have no collectives and run on rank 0 alone.
``close()`` on rank 0 drains, then sends the stop; a follower's
``close()`` waits for it.  While such an engine serves, no other thread
of any rank may run a sharded search (the collectives would pair the
wrong calls).  The mesh is fixed at construction.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future

import numpy as np

from repro_torch.core.cascade import SearchResult, SearchStats
from repro_torch.core.microbatch import pad_rows
from repro_torch.serve.cache import AnswerCache, query_digest


def _ranks(mesh) -> int:
    return 1 if mesh is None else int(mesh.size)


class AdmissionFull(RuntimeError):
    """Raised by ``submit`` when the tenant's admission queue is full —
    the engine's backpressure signal (shed load at the caller instead of
    queueing unboundedly)."""


class DeadlineExceeded(RuntimeError):
    """Set on a request's future when its deadline lapsed while it was
    still queued; the request never reaches a batch lane."""


@dataclasses.dataclass(frozen=True)
class Answer:
    """One served request: the search result plus serving metadata.

    ``distances``/``indices``/``stats`` are exactly what a direct
    ``db.search(query)`` call returns (bit-identical — cold, coalesced
    or cached).  ``wait_ms`` is admission-to-execution queueing delay
    (0 for cache hits), ``batch_lanes`` the number of real lanes in the
    serving batch (0 for cache hits).  ``error_bounds`` is set for
    anytime-mode answers only: the sound per-answer gap bounds of
    :class:`repro_torch.anytime.AnytimeResult` (all zeros once
    exploration finished — the answer is exact).
    """

    distances: np.ndarray  # (k,) ascending
    indices: np.ndarray  # (k,)
    stats: SearchStats
    tenant: str
    cache_hit: bool
    coalesced: bool  # served from a lane another request owns
    wait_ms: float
    batch_lanes: int
    error_bounds: np.ndarray | None = None  # anytime mode only

    @property
    def distance(self) -> float:
        return float(self.distances[0])

    @property
    def index(self) -> int:
        return int(self.indices[0])

    @property
    def error_bound(self) -> float:
        """Worst per-answer error bound (0.0 for exact-mode answers)."""
        if self.error_bounds is None:
            return 0.0
        return float(np.max(self.error_bounds))


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Cumulative engine counters, snapshot at :meth:`QueryEngine.stats`."""

    submitted: int
    served: int
    rejected: int  # AdmissionFull at submit
    expired: int  # DeadlineExceeded while queued
    cache_hits: int
    cache_misses: int
    cache_size: int
    cache_evictions: int
    coalesced: int  # requests that shared another request's lane
    batches: int
    batch_lanes: int  # real (non-pad) lanes executed, over all batches
    max_batch: int
    queue_depth: int  # requests admitted but not yet executed
    streams_open: int
    stream_samples: int  # values pushed through open_stream sessions (m*d)
    wait_ms_mean: float  # mean admission->execution delay of batch-served
    uptime_s: float
    # anytime-tier telemetry (0 until an anytime request is served):
    anytime_served: int = 0  # requests answered through mode="anytime"
    clusters_explored: int = 0  # leaf clusters refined, over all requests
    residual_bound_mean: float = 0.0  # mean worst error bound per answer

    @property
    def qps(self) -> float:
        return self.served / self.uptime_s if self.uptime_s > 0 else 0.0

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def batch_occupancy(self) -> float:
        """Mean fraction of batch lanes holding real queries (the rest
        are the §3.4 shape-stability padding)."""
        if self.batches == 0:
            return 0.0
        return self.batch_lanes / (self.batches * self.max_batch)


@dataclasses.dataclass
class _Request:
    tenant: str
    query: np.ndarray  # raw precision-cast (n,) or (n, d): what db.search consumes
    digest: str  # over the *prepared* (z-normed) form
    exec_key: tuple  # (k, method, driver): one db.search call per key
    deadline: float | None  # absolute monotonic, None = no deadline
    future: Future
    t_submit: float


class StreamSession:
    """One streaming client multiplexed over the engine's session.

    Wraps a ``db.stream`` :class:`repro_torch.stream.StreamMatcher` behind a
    lock so a client thread can push/poll concurrently with the batch
    worker and other sessions; matches are bit-identical to driving the
    matcher directly (the engine only counts samples).
    """

    def __init__(self, engine: "QueryEngine", matcher, sid: int):
        self._engine = engine
        self.matcher = matcher
        self.sid = sid
        self._lock = threading.Lock()
        self.closed = False

    def push(self, samples) -> None:
        with self._lock:
            n = np.asarray(samples).size
            self.matcher.push(samples)
            self._engine._count_stream_samples(n)

    def poll(self):
        with self._lock:
            return self.matcher.poll()

    def feed(self, samples):
        """push + poll in one locked step (chunk-at-a-time serving)."""
        with self._lock:
            n = np.asarray(samples).size
            out = self.matcher.feed(samples)
            self._engine._count_stream_samples(n)
            return out

    def flush(self) -> None:
        with self._lock:
            self.matcher.flush()

    def matches(self):
        with self._lock:
            return self.matcher.matches()

    @property
    def stats(self):
        return self.matcher.stats

    def close(self):
        """Flush the matcher and detach the session from the engine's
        stats; returns the matches the flush finalized (so
        ``feed``-collected matches plus this tail are the complete,
        offline-equal set — ``matches()`` still returns it whole)."""
        with self._lock:
            self.matcher.flush()
            out = self.matcher.poll()
        if not self.closed:
            self.closed = True
            self._engine._close_stream(self)
        return out


class QueryEngine:
    """Async multi-tenant query server over one ``Database`` session.

    * ``max_batch``   — lanes per coalesced microbatch (the one
      ``(max_batch, n)`` shape the engine serves through).
    * ``max_wait_ms`` — how long a non-full batch is held open for more
      requests, measured from the oldest admitted request.
    * ``max_queue``   — per-tenant admission bound; beyond it ``submit``
      raises :class:`AdmissionFull`.
    * ``cache_capacity`` / ``cache`` — answer-cache size, or a
      pre-built (possibly shared) :class:`AnswerCache`.
    * ``start=False`` defers the worker thread (tests use it to stage
      queue states); call :meth:`start` when ready.

    A multivariate session (``db.channels > 1``) takes one (n, d) query
    per request; the coalesced batch is searched as (Q, n, d).

    Over a session whose mesh spans several ranks, every rank makes the
    engine with the same arguments after ``use_mesh``: the ranks exchange
    the session's fingerprint and ``max_batch`` here, and a mismatch
    raises ``ValueError`` on every rank.  Rank 0 is the controller; on
    every other rank a follower thread takes the worker's place, mirrors
    each batch rank 0 routes to the sharded driver, and ``submit`` and
    ``open_stream`` raise ``RuntimeError``.  A batch whose session's mesh
    is no longer the engine's fails with ``RuntimeError``.
    """

    def __init__(
        self,
        db,
        *,
        max_batch: int = 8,
        max_wait_ms: float = 2.0,
        max_queue: int = 64,
        cache_capacity: int = 256,
        cache: AnswerCache | None = None,
        start: bool = True,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.db = db
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self.cache = cache if cache is not None else AnswerCache(cache_capacity)
        self._fingerprint = db.fingerprint  # pinned once: keys are stable
        # the mesh is pinned too: over several ranks rank 0 controls and
        # every other rank follows (mirrors its sharded batches)
        self._mesh = getattr(db, "mesh", None)
        self._follower = False
        if _ranks(self._mesh) > 1:
            self._check_same_engine()
            self._follower = self._mesh.rank != 0
        self._n_mirrored = 0  # sharded batches sent (rank 0) or run
        self._follow_error: BaseException | None = None

        self._cv = threading.Condition()
        self._tenants: OrderedDict[str, deque[_Request]] = OrderedDict()
        self._pending = 0
        self._rr_last: str | None = None  # last tenant served, for fairness
        self._closed = False
        self._started = False
        self._worker = threading.Thread(
            target=self._follow if self._follower else self._run,
            name="query-engine-follower" if self._follower else "query-engine",
            daemon=True,
        )

        # counters (all under _cv except the cache's own)
        self._n_submitted = 0
        self._n_served = 0
        self._n_rejected = 0
        self._n_expired = 0
        self._n_cache_hits = 0
        self._n_cache_misses = 0
        self._n_coalesced = 0
        self._n_batches = 0
        self._n_batch_lanes = 0
        self._wait_s_sum = 0.0
        self._streams: dict[int, StreamSession] = {}
        self._next_sid = 0
        self._stream_samples = 0
        # anytime-tier counters + the refine-rate EMA (windows/s) that
        # maps per-request deadlines onto exploration budgets
        self._n_anytime = 0
        self._clusters_explored = 0
        self._residual_sum = 0.0
        self._refine_rate: float | None = None
        self._t_created = time.monotonic()

        if start:
            self.start()

    # ------------------------------------------------------------ lifecycle

    def _check_same_engine(self) -> None:
        """Every rank's (fingerprint, max_batch), exchanged over the mesh:
        a sharded search over different sessions or block shapes would
        pair wrong collectives and answer wrongly without an error."""
        mine = (self._fingerprint, self.max_batch)
        ranks = self._mesh.gather_objects(mine)
        if any(r != ranks[0] for r in ranks):
            rows = "; ".join(
                f"rank {i}: fingerprint {fp[:12]}, max_batch {mb}"
                for i, (fp, mb) in enumerate(ranks)
            )
            raise ValueError(
                f"QueryEngine over a {len(ranks)}-rank mesh: the ranks' "
                f"sessions or max_batch differ ({rows}); every rank must "
                f"build the same session and make the engine with the same "
                f"arguments"
            )

    @property
    def mirrored_batches(self) -> int:
        """Sharded batches sent to the other ranks (rank 0) or run for
        rank 0 (a follower); 0 without a multi-rank mesh."""
        with self._cv:
            return self._n_mirrored

    def start(self) -> "QueryEngine":
        if not self._started:
            self._started = True
            self._worker.start()
        return self

    def close(self, timeout: float | None = None) -> None:
        """Drain every admitted request, then stop the worker.  Open
        stream sessions stay usable (they never touch the worker).

        Over a multi-rank mesh rank 0's worker then sends the stop, so a
        never-started controller or follower is started here; a follower
        waits for the stop and re-raises any error its thread hit."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if _ranks(self._mesh) > 1:
            self.start()
        if self._started:
            self._worker.join(timeout)
        if self._follower:
            if self._worker.is_alive():
                raise RuntimeError(
                    f"QueryEngine follower (rank {self._mesh.rank}): no stop "
                    f"from rank 0 within {timeout} s"
                )
            if self._follow_error is not None:
                raise self._follow_error

    def __enter__(self) -> "QueryEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ admission

    def submit(
        self,
        query,
        *,
        k: int | None = None,
        tenant: str = "default",
        deadline: float | None = None,
        method: str | None = None,
        driver: str | None = None,
        mode: str = "exact",
        budget: int | None = None,
    ) -> Future:
        """Admit one (n,) query (one (n, d) query on a d-channel session);
        returns a Future resolving to an :class:`Answer`.

        ``deadline`` is a latency budget in seconds from now: a request
        still queued when it lapses fails with :class:`DeadlineExceeded`.
        ``k``/``method``/``driver`` are the per-call-safe overrides of
        ``db.search``; they become part of the execution key, so only
        like-keyed requests share a batch (and a cache entry).  A full
        tenant queue raises :class:`AdmissionFull` immediately.

        ``mode="anytime"`` (sessions built with an anytime tier) serves
        best-so-far answers with error bounds; ``budget`` caps refined
        windows per query.  With no explicit budget, a ``deadline`` maps
        onto an exploration budget through the engine's measured refine
        rate (EMA over past anytime batches) — tighter deadlines explore
        fewer clusters, looser ones converge to exact.
        """
        self._refuse_on_follower("submit")
        db = self.db
        raw = np.asarray(query, dtype=db.config.precision)
        if db.channels > 1:
            # multivariate session: one (n, d) query per request; the
            # prepared form below is the channel-major flattened row
            if raw.ndim != 2:
                raise ValueError(
                    f"submit takes one (n, {db.channels}) query per "
                    f"request on this {db.channels}-channel session, got "
                    f"shape {raw.shape}; submit a batch as individual "
                    f"requests and let the coalescer form the batch"
                )
        elif raw.ndim != 1:
            raise ValueError(
                f"submit takes one (n,) query per request, got shape "
                f"{raw.shape}; submit a batch as individual requests and "
                f"let the coalescer form the batch"
            )
        if mode not in ("exact", "anytime"):
            raise ValueError(f"mode={mode!r} unknown; use 'exact' or 'anytime'")
        if budget is not None and mode != "anytime":
            raise ValueError("budget= only applies to mode='anytime'")
        if mode == "anytime":
            if db.anytime is None:
                raise ValueError(
                    "mode='anytime' needs the anytime tier: build the "
                    "session with Database.build(..., anytime=True)"
                )
            if driver is not None:
                raise ValueError(
                    f"driver={driver!r} cannot be combined with "
                    f"mode='anytime' — the cluster explorer is the driver"
                )
            qlen = int(raw.shape[-1])
            tier = db.anytime.tier(qlen)  # raises with built lengths
            prepared = db.prepare_queries(raw, length=qlen)
            k = db.config.validate_k(
                db.config.k if k is None else k, tier.n_windows
            )
            if budget is None and deadline is not None:
                with self._cv:
                    rate = self._refine_rate
                if rate is not None:
                    budget = max(1, int(rate * float(deadline)))
            if budget is not None:
                budget = int(budget)
                if budget < 1:
                    raise ValueError(
                        f"budget={budget} must be >= 1 refined windows "
                        f"per query (or None for unlimited)"
                    )
        else:
            qlen = db.length
            prepared = db.prepare_queries(raw)  # validates length, z-norms
            k = db.config.validate_k(
                db.config.k if k is None else k, db.n_rows
            )
        # normalized execution key: an explicit method equal to the
        # config's must hit the same lane/cache entry as the default;
        # mode/budget/length join it so only like-quality requests share
        # a batch lane or a cache entry
        method = db.config.method if method is None else method
        exec_key = (k, method, driver, mode, budget, qlen)
        digest = query_digest(self._fingerprint, exec_key, prepared)
        t_now = time.monotonic()

        future: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("submit on a closed QueryEngine")
            self._n_submitted += 1
        hit = self.cache.get(digest)
        with self._cv:  # engine-local hit/miss (the cache may be shared)
            if hit is not None:
                self._n_cache_hits += 1
            else:
                self._n_cache_misses += 1
        if hit is not None:
            err = getattr(hit, "error_bounds", None)
            with self._cv:
                self._n_served += 1
                if mode == "anytime":
                    self._n_anytime += 1
                    if err is not None:
                        self._residual_sum += float(np.max(err))
            future.set_result(
                Answer(
                    distances=hit.distances,
                    indices=hit.indices,
                    stats=hit.stats,
                    tenant=tenant,
                    cache_hit=True,
                    coalesced=False,
                    wait_ms=0.0,
                    batch_lanes=0,
                    error_bounds=err,
                )
            )
            return future

        req = _Request(
            tenant=tenant,
            query=raw,
            digest=digest,
            exec_key=exec_key,
            deadline=None if deadline is None else t_now + float(deadline),
            future=future,
            t_submit=t_now,
        )
        with self._cv:
            queue = self._tenants.setdefault(tenant, deque())
            if len(queue) >= self.max_queue:
                self._n_rejected += 1
                raise AdmissionFull(
                    f"tenant {tenant!r} admission queue is full "
                    f"({self.max_queue} pending): back off and retry"
                )
            queue.append(req)
            self._pending += 1
            self._cv.notify_all()
        return future

    def search(self, query, **kw) -> Answer:
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(query, **kw).result()

    # ------------------------------------------------------------- coalesce

    def _fail_expired_head(self, queue: deque, now: float) -> None:
        while queue and queue[0].deadline is not None and now > queue[0].deadline:
            req = queue.popleft()
            self._pending -= 1
            self._n_expired += 1
            req.future.set_exception(
                DeadlineExceeded(
                    f"request queued {1e3 * (now - req.t_submit):.1f} ms, "
                    f"past its deadline"
                )
            )

    def _oldest_submit_locked(self) -> float | None:
        heads = [q[0].t_submit for q in self._tenants.values() if q]
        return min(heads) if heads else None

    def _form_batch_locked(self):
        """Drain tenant queues round-robin into one batch of lanes.

        The oldest head request fixes the batch's execution key; heads
        with a different key stay queued (per-tenant FIFO is preserved —
        a tenant's later requests never overtake its head).  Requests
        whose digest matches an already-admitted lane coalesce into it
        even when the batch is lane-full.  Returns ``(exec_key, lanes)``
        where each lane is the list of requests it serves, or None.
        """
        now = time.monotonic()
        for queue in self._tenants.values():
            self._fail_expired_head(queue, now)
        heads = [q[0] for q in self._tenants.values() if q]
        if not heads:
            return None
        exec_key = min(heads, key=lambda r: r.t_submit).exec_key

        names = list(self._tenants.keys())
        if self._rr_last in names:  # start after the last tenant served
            i = names.index(self._rr_last) + 1
            names = names[i:] + names[:i]
        lanes: OrderedDict[str, list[_Request]] = OrderedDict()
        progress = True
        while progress:
            progress = False
            for name in names:  # one head per tenant per pass: round-robin
                queue = self._tenants[name]
                self._fail_expired_head(queue, now)
                if not queue or queue[0].exec_key != exec_key:
                    continue
                if len(lanes) >= self.max_batch and queue[0].digest not in lanes:
                    continue
                req = queue.popleft()
                self._pending -= 1
                lane = lanes.setdefault(req.digest, [])
                if lane:
                    self._n_coalesced += 1
                lane.append(req)
                self._rr_last = name
                progress = True
        if not lanes:
            return None
        return exec_key, list(lanes.values())

    # -------------------------------------------------------------- execute

    def _refuse_on_follower(self, what: str) -> None:
        if self._follower:
            raise RuntimeError(
                f"{what} on rank {self._mesh.rank}: a QueryEngine over a "
                f"{self._mesh.size}-rank mesh admits requests on the mesh's "
                f"rank 0; this rank only mirrors its sharded batches"
            )

    def _check_mesh(self) -> None:
        """Raise if the session's mesh is no longer the one the engine was
        made with, where either spans several ranks: the ranks would no
        longer run the same sharded searches."""
        mesh = getattr(self.db, "mesh", None)
        if mesh is not self._mesh and max(_ranks(mesh), _ranks(self._mesh)) > 1:
            raise RuntimeError(
                "the session's mesh changed after the QueryEngine was made: "
                "make the engine after use_mesh, on every rank of the mesh"
            )

    def _mirror(self, exec_key: tuple, block: np.ndarray) -> None:
        """On rank 0 of a multi-rank mesh, send a batch the planner routes
        to the sharded driver to every other rank before running it."""
        if _ranks(self._mesh) <= 1:
            return
        k, method, driver = exec_key[:3]
        if self.db.plan(block, driver=driver, method=method, k=k).driver != "sharded":
            return
        self._mesh.broadcast_batch((exec_key, block))
        with self._cv:
            self._n_mirrored += 1

    def _follow(self) -> None:
        """A follower's loop: run each batch rank 0 sends, in its order,
        until the stop (``None``).  A search that raises is recorded and
        the loop goes on, as rank 0's worker fails the batch and goes on;
        a failed receive ends it."""
        self._mesh.bind_device()
        while True:
            try:
                msg = self._mesh.broadcast_batch()
            except Exception as e:  # the transport failed: nothing to pair
                self._follow_error = e
                return
            if msg is None:
                return
            exec_key, block = msg
            k, method, driver = exec_key[:3]
            with self._cv:
                self._n_mirrored += 1
            try:
                self.db.search(block, k=k, method=method, driver=driver)
            except Exception as e:
                if self._follow_error is None:
                    self._follow_error = e

    def _execute(self, exec_key: tuple, lanes: list[list[_Request]]) -> None:
        k, method, driver, mode, _budget, _qlen = exec_key
        t_exec = time.monotonic()
        if mode == "anytime":
            self._execute_anytime(exec_key, lanes, t_exec)
            return
        block, n_valid = pad_rows([lane[0].query for lane in lanes], self.max_batch)
        try:
            self._check_mesh()
            self._mirror(exec_key, block)
            res = self.db.search(block, k=k, method=method, driver=driver)
        except Exception as e:  # fail every rider, never wedge the worker
            for lane in lanes:
                for req in lane:
                    req.future.set_exception(e)
            return
        with self._cv:
            self._n_batches += 1
            self._n_batch_lanes += n_valid
        for i, lane in enumerate(lanes):
            single = SearchResult(
                distances=res.distances[i],
                indices=res.indices[i],
                stats=res.per_query[i] if res.per_query else res.stats,
            )
            self.cache.put(lane[0].digest, single)
            for j, req in enumerate(lane):
                wait_s = t_exec - req.t_submit
                with self._cv:
                    self._n_served += 1
                    self._wait_s_sum += wait_s
                req.future.set_result(
                    Answer(
                        distances=single.distances,
                        indices=single.indices,
                        stats=single.stats,
                        tenant=req.tenant,
                        cache_hit=False,
                        coalesced=j > 0,
                        wait_ms=1e3 * wait_s,
                        batch_lanes=n_valid,
                    )
                )

    def _execute_anytime(
        self, exec_key: tuple, lanes: list[list[_Request]], t_exec: float
    ) -> None:
        """One anytime batch: the cluster explorer runs per lane, so
        real lanes stack unpadded (padding would burn real budget)."""
        k, method, _driver, _mode, budget, _qlen = exec_key
        block = np.stack([lane[0].query for lane in lanes])
        try:
            self._check_mesh()  # no collectives: rank 0 alone runs it
            res = self.db.search(
                block, k=k, method=method, mode="anytime", budget=budget
            )
        except Exception as e:  # fail every rider, never wedge the worker
            for lane in lanes:
                for req in lane:
                    req.future.set_exception(e)
            return
        dt = time.monotonic() - t_exec
        with self._cv:
            self._n_batches += 1
            self._n_batch_lanes += len(lanes)
            self._clusters_explored += res.stats.clusters_explored
            # refine-rate EMA (windows/s): maps future deadlines onto
            # budgets; seeded by the first batch, then smoothed
            if dt > 0 and res.stats.refined:
                rate = res.stats.refined / dt / len(lanes)
                self._refine_rate = (
                    rate
                    if self._refine_rate is None
                    else 0.7 * self._refine_rate + 0.3 * rate
                )
        for i, lane in enumerate(lanes):
            single = res[i]  # AnytimeResult: distances/indices/stats ride
            self.cache.put(lane[0].digest, single)
            for j, req in enumerate(lane):
                wait_s = t_exec - req.t_submit
                with self._cv:
                    self._n_served += 1
                    self._n_anytime += 1
                    self._wait_s_sum += wait_s
                    self._residual_sum += float(np.max(single.error_bounds))
                req.future.set_result(
                    Answer(
                        distances=single.distances,
                        indices=single.indices,
                        stats=single.stats,
                        tenant=req.tenant,
                        cache_hit=False,
                        coalesced=j > 0,
                        wait_ms=1e3 * wait_s,
                        batch_lanes=len(lanes),
                        error_bounds=single.error_bounds,
                    )
                )

    def _run(self) -> None:
        if _ranks(self._mesh) <= 1:
            self._serve()
            return
        self._mesh.bind_device()
        try:
            self._serve()
        finally:
            self._mesh.broadcast_batch(None)  # the followers' stop

    def _serve(self) -> None:
        while True:
            with self._cv:
                while self._pending == 0 and not self._closed:
                    self._cv.wait(timeout=0.1)
                if self._pending == 0 and self._closed:
                    return
                # max-wait/max-batch policy: hold the batch open until it
                # fills or the oldest admitted request has waited max_wait
                # (a closing engine drains immediately)
                oldest = self._oldest_submit_locked()
                if oldest is not None and not self._closed:
                    t_limit = oldest + self.max_wait
                    while self._pending < self.max_batch and not self._closed:
                        left = t_limit - time.monotonic()
                        if left <= 0:
                            break
                        self._cv.wait(timeout=left)
                batch = self._form_batch_locked()
            if batch is not None:
                self._execute(*batch)

    # ------------------------------------------------------------ streaming

    def open_stream(self, templates=None, *, threshold, **kw) -> StreamSession:
        """A streaming client over this session's artifacts: forwards to
        ``db.stream`` (db rows as templates + build-time envelopes when
        ``templates`` is None) and registers the session for stats."""
        self._refuse_on_follower("open_stream")
        matcher = self.db.stream(templates, threshold=threshold, **kw)
        with self._cv:
            sid = self._next_sid
            self._next_sid += 1
            session = StreamSession(self, matcher, sid)
            self._streams[sid] = session
        return session

    def _close_stream(self, session: StreamSession) -> None:
        with self._cv:
            self._streams.pop(session.sid, None)

    def _count_stream_samples(self, n: int) -> None:
        with self._cv:
            self._stream_samples += int(n)

    # ---------------------------------------------------------------- stats

    def queue_depth(self) -> int:
        with self._cv:
            return self._pending

    def stats(self) -> EngineStats:
        """A consistent snapshot of the cumulative engine counters."""
        with self._cv:
            served_batched = self._n_served - self._n_cache_hits
            return EngineStats(
                submitted=self._n_submitted,
                served=self._n_served,
                rejected=self._n_rejected,
                expired=self._n_expired,
                cache_hits=self._n_cache_hits,
                cache_misses=self._n_cache_misses,
                cache_size=len(self.cache),
                cache_evictions=self.cache.evictions,
                coalesced=self._n_coalesced,
                batches=self._n_batches,
                batch_lanes=self._n_batch_lanes,
                max_batch=self.max_batch,
                queue_depth=self._pending,
                streams_open=len(self._streams),
                stream_samples=self._stream_samples,
                wait_ms_mean=(
                    1e3 * self._wait_s_sum / served_batched
                    if served_batched
                    else 0.0
                ),
                uptime_s=time.monotonic() - self._t_created,
                anytime_served=self._n_anytime,
                clusters_explored=self._clusters_explored,
                residual_bound_mean=(
                    self._residual_sum / self._n_anytime
                    if self._n_anytime
                    else 0.0
                ),
            )
