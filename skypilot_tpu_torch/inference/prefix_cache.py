"""Radix-tree prefix index over the paged KV pool (host-side).

The port's own copy of `skypilot_tpu/inference/prefix_cache.py`
(`MatchResult` :45, `_Node` :53, `RadixPrefixCache` :68-304), line for
line: importing the reference would load JAX through its package. The
engine's FIFO page allocator takes pages back in the order `insert`,
`evict_lru` and `clear` return them, so the two copies must stay
identical in behaviour or the page pools drift apart; a test runs the
same scripted operations through both.

Division of labour with the engine: this module is pure host
bookkeeping over page *ids*. Mapping a matched page into a slot's block
table, copying a shared page before a write (copy-on-write) and freeing
pages are the engine's moves. Only FULL pages are indexed; refcounts are
per page (`acquire`/`release`); eviction is LRU over refcount-0 leaves,
trimming each victim from its tail, so a page with refcount > 0 is never
reclaimed.
"""
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class MatchResult:
    """One lookup: `pages[i]` holds tokens
    [i*page_size, (i+1)*page_size) of the prompt; `tokens` is
    len(pages) * page_size — the span prefill can skip."""
    pages: List[int]
    tokens: int


class _Node:
    __slots__ = ('label', 'pages', 'children', 'last_use', 'parent')

    def __init__(self, label: Tuple[int, ...], pages: List[int],
                 parent: Optional['_Node']) -> None:
        self.label = label            # len == len(pages) * page_size
        self.pages = pages
        self.children: Dict[Tuple[int, ...], '_Node'] = {}
        self.last_use = 0
        self.parent = parent

    def key_of(self, page_size: int) -> Tuple[int, ...]:
        return self.label[:page_size]


class RadixPrefixCache:
    """Token-sequence -> cached-page-ids radix tree.

    Invariants:
      * every edge label is a whole number of `page_size`-token pages
        and no two siblings share their first page of tokens (a
        shared full first page would have been split into a common
        parent);
      * a page id appears in exactly one node;
      * `refcount(page) > 0` iff some live slot's block table maps it.
    """

    def __init__(self, page_size: int) -> None:
        if page_size <= 0:
            raise ValueError('page_size must be positive')
        self.page_size = page_size
        self._root = _Node((), [], None)
        self._ref: Dict[int, int] = {}
        self._owned: set = set()
        self._tick = 0

    # -- introspection --------------------------------------------------------

    def num_pages(self) -> int:
        """Pages the tree currently indexes (pinned + reclaimable)."""
        return len(self._owned)

    def owns(self, page: int) -> bool:
        """Is `page` indexed by the tree? A released page the tree no
        longer owns (post-`clear`) must return to the pool; one it
        still owns stays cached."""
        return page in self._owned

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    # -- matching -------------------------------------------------------------

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_use = self._tick

    def match(self, tokens: Sequence[int]) -> MatchResult:
        """Longest cached full-page prefix of `tokens`.

        Splits edges at the match boundary as it walks (the standard
        radix move), so the matched path always ends exactly at a
        node boundary; matched nodes' LRU stamps refresh. Does NOT
        take references — call `acquire` on the returned pages once
        the caller commits to mapping them.
        """
        ps = self.page_size
        pages: List[int] = []
        node = self._root
        off = 0
        tokens = tuple(tokens)
        while off + ps <= len(tokens):
            child = node.children.get(tokens[off:off + ps])
            if child is None:
                break
            # Full pages of this edge matched by the remaining tokens.
            j = 0
            while (j < len(child.pages)
                   and off + (j + 1) * ps <= len(tokens)
                   and child.label[j * ps:(j + 1) * ps]
                   == tokens[off + j * ps:off + (j + 1) * ps]):
                j += 1
            partial = j < len(child.pages)
            if partial:
                child = self._split(child, j)
            pages.extend(child.pages)
            off += len(child.pages) * ps
            self._touch(child)
            if partial:
                # Diverged (or ran out of prompt) inside the edge: no
                # deeper node can match.
                break
            node = child
        return MatchResult(pages=pages, tokens=off)

    def _split(self, node: _Node, j: int) -> _Node:
        """Split `node`'s edge after its first j pages (0 < j < len);
        returns the new prefix node. The original object keeps the
        suffix and its children, so descendants never re-parent."""
        ps = self.page_size
        prefix = _Node(node.label[:j * ps], list(node.pages[:j]),
                       node.parent)
        prefix.last_use = node.last_use
        parent = node.parent
        del parent.children[node.key_of(ps)]
        node.label = node.label[j * ps:]
        node.pages = node.pages[j:]
        node.parent = prefix
        prefix.children[node.key_of(ps)] = node
        parent.children[prefix.key_of(ps)] = prefix
        return prefix

    # -- reference lifecycle --------------------------------------------------

    def acquire(self, pages: Sequence[int]) -> None:
        """A slot mapped `pages` into its block table: pin them
        against eviction until `release`."""
        for p in pages:
            self._ref[p] = self._ref.get(p, 0) + 1

    def release(self, pages: Sequence[int]) -> None:
        """A slot stopped mapping `pages` (evict, abort, or a COW
        copy replaced one). Pages stay in the tree, reclaimable once
        their refcount is zero."""
        for p in pages:
            left = self._ref.get(p, 0) - 1
            if left <= 0:
                self._ref.pop(p, None)
            else:
                self._ref[p] = left

    # -- insert ---------------------------------------------------------------

    def insert(self, tokens: Sequence[int],
               pages: Sequence[int]) -> List[int]:
        """Publish a finished request's pages: `pages[i]` holds tokens
        [i*page_size, (i+1)*page_size). Only full pages are accepted
        (len(tokens) >= len(pages) * page_size; extra tokens are
        ignored). Returns the pages the tree did NOT adopt —
        already-present duplicates, i.e. another request published
        the same span first under different page ids — which the
        caller must free back to the pool. Pages the slot matched
        FROM this tree re-walk their own nodes and are never
        reported as duplicates (identical ids are kept, not freed).
        """
        ps = self.page_size
        tokens = tuple(tokens)
        pages = list(pages)
        if len(tokens) < len(pages) * ps:
            raise ValueError(
                f'{len(pages)} pages need {len(pages) * ps} tokens, '
                f'got {len(tokens)}')
        leftover: List[int] = []
        node = self._root
        off = 0
        i = 0
        while i < len(pages):
            child = node.children.get(tokens[off:off + ps])
            if child is None:
                adopt = pages[i:]
                new = _Node(tokens[off:off + len(adopt) * ps],
                            adopt, node)
                node.children[new.key_of(ps)] = new
                self._touch(new)
                self._owned.update(adopt)
                return leftover
            j = 0
            while (j < len(child.pages) and i + j < len(pages)
                   and child.label[j * ps:(j + 1) * ps]
                   == tokens[off + j * ps:off + (j + 1) * ps]):
                j += 1
            # The dict key IS the first page's tokens, so j >= 1.
            for k in range(j):
                if child.pages[k] != pages[i + k]:
                    # Same tokens cached under a different page id:
                    # the tree keeps its copy, ours is a duplicate.
                    leftover.append(pages[i + k])
            if j < len(child.pages):
                # Our run ends (or diverges) inside this edge: split
                # so the shared prefix is its own node; a divergent
                # suffix attaches under it on the next iteration.
                child = self._split(child, j)
            self._touch(child)
            node = child
            off += j * ps
            i += j
        return leftover

    # -- eviction -------------------------------------------------------------

    def evict_lru(self, n_pages: int) -> List[int]:
        """Reclaim up to `n_pages` pages from refcount-0 leaves in
        LRU order, trimming each victim from its TAIL (the deepest,
        least-matchable end — the shared prefix head stays warm and
        matchable). Returns the freed page ids (the caller returns
        them to the pool allocator). Never touches a page with
        refcount > 0 — such leaves are skipped, and interior nodes
        are untouchable by construction."""
        import heapq
        ps = self.page_size

        def evictable(node: _Node) -> bool:
            return (node is not self._root and not node.children
                    and not any(self._ref.get(p, 0) > 0
                                for p in node.pages))

        # ONE DFS collects every refcount-0 leaf (this runs on the
        # request-admission path — a per-victim rescan would be
        # O(victims x tree)); parents that BECOME evictable leaves as
        # their children evict are pushed as they surface.
        heap: List[Tuple[int, int, _Node]] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if evictable(node):
                heapq.heappush(heap, (node.last_use, id(node), node))
        freed: List[int] = []
        while heap and len(freed) < n_pages:
            _lu, _nid, victim = heapq.heappop(heap)
            take = min(len(victim.pages), n_pages - len(freed))
            if take == len(victim.pages):
                parent = victim.parent
                del parent.children[victim.key_of(ps)]
                freed.extend(victim.pages)
                self._owned.difference_update(victim.pages)
                if evictable(parent):
                    heapq.heappush(
                        heap, (parent.last_use, id(parent), parent))
            else:
                tail = victim.pages[-take:]
                victim.pages = victim.pages[:-take]
                victim.label = victim.label[:len(victim.pages) * ps]
                freed.extend(tail)
                self._owned.difference_update(tail)
        return freed

    def clear(self) -> List[int]:
        """Drop the whole index (engine error recovery): returns
        every non-pinned page for the pool. Pinned pages stay with
        their holders' tables (the engine releases them as it frees
        the slots) and are simply forgotten by the tree."""
        freed: List[int] = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            freed.extend(p for p in node.pages
                         if self._ref.get(p, 0) <= 0)
        self._root = _Node((), [], None)
        self._owned.clear()
        return freed
