"""Load-balancing policies.

The port's copy of `skypilot_tpu/serve/load_balancing_policies.py`:
`RoundRobinPolicy` (:60), `LeastLoadPolicy` (:77, the default) and
`PrefixAffinityPolicy` (:117) with its page fingerprints (:159), the
bounded-load guard through `_load_locked` (:190) and
`_least_load_locked` (:201), `select` (:214), `on_request_start` (:258)
and the LRU cap, and `make_policy` (:318). Every method takes the
policy's lock: the port's load balancer calls them from one thread per
connection at once.

`PrefixAffinityPolicy` routes by prompt CONTENT. The LB keeps a
host-side fingerprint index of the page-aligned prompt prefixes it has
routed — mirroring the engine's `inference/prefix_cache.py` radix
semantics at the same page granularity — and sends a request to the
replica most likely to hold its prefix warm in that replica's radix KV
cache. Affinity is bounded: once the affine replica's load crosses
`c x` the fleet mean the request falls back to least-load (affinity
must never create a hotspot — the bounded-load rule of Mirrokni et
al.'s consistent hashing, applied to an explicit index instead of a
hash ring).

`select()` takes an optional request `context` (a dict with
`prompt_tokens` / `max_new_tokens`, produced by the LB's JSON peek)
and an optional `candidates` restriction (the replica-pool slice the
LB computed from request shape). Policies that ignore content simply
ignore both.
"""
import collections
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from skypilot_tpu_torch import envs
from skypilot_tpu_torch.observability import instruments as obs


class LoadBalancingPolicy:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.replicas: List[str] = []

    def set_replicas(self, replicas: List[str]) -> None:
        with self._lock:
            self.replicas = list(replicas)

    def select(self, context: Optional[Dict[str, Any]] = None,
               candidates: Optional[Sequence[str]] = None
               ) -> Optional[str]:
        raise NotImplementedError

    def on_request_start(self, url: str,
                         context: Optional[Dict[str, Any]] = None
                         ) -> None:
        pass

    def on_request_end(self, url: str) -> None:
        pass

    def stats(self) -> Dict[str, Any]:
        """Routing-internal state for /internal/stats (non-mutating)."""
        return {}


class RoundRobinPolicy(LoadBalancingPolicy):
    def __init__(self) -> None:
        super().__init__()
        self._index = 0

    def select(self, context: Optional[Dict[str, Any]] = None,
               candidates: Optional[Sequence[str]] = None
               ) -> Optional[str]:
        with self._lock:
            pool = list(candidates) if candidates else self.replicas
            if not pool:
                return None
            url = pool[self._index % len(pool)]
            self._index += 1
            return url


class LeastLoadPolicy(LoadBalancingPolicy):
    """Route to the replica with the fewest in-flight requests."""

    def __init__(self) -> None:
        super().__init__()
        self._in_flight: Dict[str, int] = {}

    def set_replicas(self, replicas: List[str]) -> None:
        with self._lock:
            self.replicas = list(replicas)
            self._in_flight = {r: self._in_flight.get(r, 0)
                               for r in replicas}

    def select(self, context: Optional[Dict[str, Any]] = None,
               candidates: Optional[Sequence[str]] = None
               ) -> Optional[str]:
        with self._lock:
            pool = list(candidates) if candidates else self.replicas
            if not pool:
                return None
            return min(pool,
                       key=lambda r: self._in_flight.get(r, 0))

    def on_request_start(self, url: str,
                         context: Optional[Dict[str, Any]] = None
                         ) -> None:
        with self._lock:
            self._in_flight[url] = self._in_flight.get(url, 0) + 1

    def on_request_end(self, url: str) -> None:
        with self._lock:
            self._in_flight[url] = max(
                0, self._in_flight.get(url, 0) - 1)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {'in_flight': {r: self._in_flight.get(r, 0)
                                  for r in self.replicas}}


class PrefixAffinityPolicy(LeastLoadPolicy):
    """Content-aware routing with a bounded-load hotspot guard.

    Index model: every routed prompt contributes one fingerprint per
    page-aligned prefix (a hash chain over `page_tokens`-token pages,
    the LB-side mirror of the engine radix tree's full-page-only
    rule), each mapping to the replicas that served it. A lookup
    walks the chain and picks the replica with the DEEPEST match —
    the one holding the most reusable KV pages. The index is pure
    host bookkeeping bounded by `max_entries` (LRU over
    fingerprints): it predicts warmth, it never pins replica memory,
    so a stale entry costs one mispredicted route, not correctness.

    Load model: in-flight requests plus request starts within
    `load_window` seconds (the recency term keeps a burst dispatched
    within one scheduling quantum — before any request finishes —
    from piling onto a single warm replica). The affine pick is taken
    only while `load + 1 <= ceil(c * (total_load + 1) / n_replicas)`;
    past that the request spills to least-load AND the spill target
    is indexed too, so a hot prefix family automatically replicates
    across exactly as many replicas as its traffic needs.
    """

    def __init__(self, now_fn=time.monotonic) -> None:
        super().__init__()
        self._now = now_fn
        self._page = max(1, envs.SKYTPU_LB_AFFINITY_PAGE_TOKENS.get())
        self._bound = envs.SKYTPU_LB_AFFINITY_BOUND.get()
        self._max_entries = max(
            1, envs.SKYTPU_LB_AFFINITY_MAX_ENTRIES.get())
        self._window = envs.SKYTPU_LB_AFFINITY_LOAD_WINDOW.get()
        # fingerprint -> {url: last-use tick}; _order is the LRU.
        self._index: Dict[int, Dict[str, int]] = {}
        self._order: 'collections.OrderedDict[int, None]' = \
            collections.OrderedDict()
        self._url_entries: Dict[str, int] = {}
        self._recent: Dict[str, collections.deque] = {}
        self._rr = 0
        self._tick = 0

    # -- fingerprinting -------------------------------------------------------

    def _fingerprints(self, context: Optional[Dict[str, Any]]
                      ) -> List[int]:
        """One fingerprint per full page-aligned prompt prefix (the
        hash chain makes fp_k depend on all k pages, so equal tails
        under different heads never collide structurally). Memoized
        in the context dict: select(), failover retries, and
        on_request_start() all see the same request, so the
        O(prompt) hashing under the routing lock runs once, not once
        per hook."""
        if not context:
            return []
        cached = context.get('_fps')
        if cached is not None:
            return cached
        tokens = context.get('prompt_tokens')
        if not tokens:
            prompt = context.get('prompt')
            if not isinstance(prompt, str) or not prompt:
                return []
            tokens = list(prompt.encode('utf-8'))
        ps = self._page
        fps: List[int] = []
        h = 0
        for off in range(0, len(tokens) - ps + 1, ps):
            h = hash((h, tuple(tokens[off:off + ps])))
            fps.append(h)
        context['_fps'] = fps
        return fps

    # -- load accounting ------------------------------------------------------

    def _load_locked(self, url: str) -> int:
        load = self._in_flight.get(url, 0)
        if self._window > 0:
            recent = self._recent.get(url)
            if recent:
                cutoff = self._now() - self._window
                while recent and recent[0] < cutoff:
                    recent.popleft()
                load += len(recent)
        return load

    def _least_load_locked(self, pool: Sequence[str]) -> str:
        """Least-load with a rotating tie-break: equal-load replicas
        (the cold-start common case) must not all collapse onto
        list position zero — that would seed every prefix family on
        one replica."""
        loads = [self._load_locked(r) for r in pool]
        lo = min(loads)
        ties = [r for r, l in zip(pool, loads) if l == lo]
        self._rr += 1
        return ties[self._rr % len(ties)]

    # -- selection ------------------------------------------------------------

    def select(self, context: Optional[Dict[str, Any]] = None,
               candidates: Optional[Sequence[str]] = None
               ) -> Optional[str]:
        with self._lock:
            pool = list(candidates) if candidates else self.replicas
            if not pool:
                return None
            fps = self._fingerprints(context)
            if not fps:
                # No routable content (GET, opaque body): plain
                # least-load, not an affinity miss.
                return self._least_load_locked(pool)
            pool_set = set(pool)
            depth: Dict[str, int] = {}
            for d, fp in enumerate(fps):
                entry = self._index.get(fp)
                if entry is None:
                    break
                matched = False
                for url in entry:
                    if url in pool_set:
                        depth[url] = d + 1
                        matched = True
                if not matched:
                    break
            if not depth:
                obs.LB_AFFINITY_MISSES.inc()
                return self._least_load_locked(pool)
            best = max(depth.values())
            affine = [u for u, d in depth.items() if d == best]
            target = min(affine, key=self._load_locked)
            # Bounded load: ceil(c * (total + 1) / n) is the per-
            # replica capacity; an affine pick past it spills.
            total = sum(self._load_locked(r) for r in pool)
            cap = -(-self._bound * (total + 1) // len(pool))
            if self._load_locked(target) + 1 <= cap:
                obs.LB_AFFINITY_HITS.inc()
                return target
            obs.LB_AFFINITY_FALLBACKS.inc()
            spill = [r for r in pool if r != target] or pool
            return self._least_load_locked(spill)

    # -- index maintenance ----------------------------------------------------

    def on_request_start(self, url: str,
                         context: Optional[Dict[str, Any]] = None
                         ) -> None:
        super().on_request_start(url)
        with self._lock:
            if self._window > 0:
                self._recent.setdefault(
                    url, collections.deque()).append(self._now())
            self._tick += 1
            for fp in self._fingerprints(context):
                entry = self._index.get(fp)
                if entry is None:
                    entry = self._index[fp] = {}
                else:
                    self._order.move_to_end(fp)
                if url not in entry:
                    self._url_entries[url] = \
                        self._url_entries.get(url, 0) + 1
                entry[url] = self._tick
                self._order[fp] = None
            while len(self._index) > self._max_entries:
                old_fp, _ = self._order.popitem(last=False)
                for gone in self._index.pop(old_fp, {}):
                    left = self._url_entries.get(gone, 0) - 1
                    if left <= 0:
                        self._url_entries.pop(gone, None)
                    else:
                        self._url_entries[gone] = left
            obs.LB_AFFINITY_ENTRIES.set(len(self._index))

    def set_replicas(self, replicas: List[str]) -> None:
        super().set_replicas(replicas)
        with self._lock:
            # Index entries for departed replicas age out via LRU;
            # only the recency deques are dropped eagerly (they are
            # per-URL and unbounded in key count otherwise).
            for gone in set(self._recent) - set(replicas):
                del self._recent[gone]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                'entries': len(self._index),
                'page_tokens': self._page,
                'bound': self._bound,
                'per_replica_entries': {
                    r: self._url_entries.get(r, 0)
                    for r in self.replicas},
                'in_flight': {r: self._in_flight.get(r, 0)
                              for r in self.replicas},
            }


POLICIES = {
    'round_robin': RoundRobinPolicy,
    'least_load': LeastLoadPolicy,
    'prefix_affinity': PrefixAffinityPolicy,
}


def make_policy(name: str, now_fn=None) -> LoadBalancingPolicy:
    """`now_fn` is the affinity load-window clock seam (a fake clock in
    tests); policies that keep no clocks ignore it."""
    cls = POLICIES.get(name)
    if cls is None:
        raise ValueError(
            f'unknown load-balancing policy {name!r}; valid: '
            f'{", ".join(sorted(POLICIES))}')
    if cls is PrefixAffinityPolicy and now_fn is not None:
        return cls(now_fn=now_fn)
    return cls()
