"""Prefix cache: hash-keyed shared KV pages over the paged pool, the port
of ``repro.serve.prefix``.

Shared-system-prompt traffic re-prefills the same leading tokens into
private pages on every admission; at sub-1-bit weights the KV pool is the
serving-memory bottleneck, so that duplication is the bytes worth
deduplicating. This index makes prompt-prefix KV a shared, refcounted
resource:

- The unit of sharing is one page-aligned token chunk (``page_size``
  tokens, one KV page). Chunk ``i`` of a prompt is keyed by a chained hash
  over every chunk up to and including it, so two prompts share page
  ``i`` only if they agree on all ``(i+1) * page_size`` leading tokens
  (the audio family's tokens are frames: a chunk is (page_size, K) ids).
  Entries keep the raw chunk bytes (int32, whatever the prompt's integer
  type) and compare them on every lookup, so a hash collision, a reused
  uid or any other aliasing degrades to a miss, never to wrong KV.
- :meth:`PrefixCache.match` walks the chain for an incoming prompt and
  returns the longest indexed prefix with its page ids; the engine maps
  those pages read-only (``PagedKVState.admit(shared=...)``) and prefills
  only the suffix.
- :meth:`PrefixCache.register` adopts a freshly prefilled slot's
  full-chunk pages (``mark_cached``). They hold only rows below the
  owner's committed frontier, so its decode writes never land in them;
  the one write that would (a full-cover admission re-emitting from the
  prompt's last token) copies the page on write first.
- Eviction is LRU at refcount zero only: :meth:`PrefixCache.reclaim`, the
  allocator's ``reclaim_cb``, takes the least recently matched leaf
  entries whose pages no slot maps. An interior entry leaves only after
  every indexed extension has, so a surviving key has its whole chain.

Keys are Python ``hash`` values of ``(parent key, chunk bytes)``. The hash
of bytes is salted per process, so keys mean something only inside the
process that made them; the index lives in one engine, in one process, as
in the reference, and is never saved or sent.

The index holds token -> page mappings, never KV values. In the dense
family KV for a token sequence is a function of the tokens alone, so
serving through the index is token-identical to the engine without it.
In the MoE family it is not: an expert's capacity depends on the rows of
the call, so a token's KV depends on what it was batched with, and a
hit's suffix prefill (padded as the reference pads it) is held against
the reference's prefix engine, not against the unshared engine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.serve.paging import PageAccountingError, PagedKVState


@dataclasses.dataclass
class _Entry:
    """One indexed chunk: `key` = chained hash of chunks[0..i], `page` =
    the pool page holding its KV rows. `tokens` (raw bytes) guards against
    hash collisions; `children` counts indexed extensions (leaf <=> 0);
    `tick` is the LRU clock (bumped on match and register)."""
    key: int
    parent: Optional[int]
    tokens: bytes
    page: int
    children: int = 0
    tick: int = 0


def _chunk_key(parent: Optional[int], chunk: np.ndarray) -> Tuple[int, bytes]:
    b = np.ascontiguousarray(chunk, np.int32).tobytes()
    return hash((parent, b)), b


class PrefixCache:
    """Host-side prefix index over one :class:`PagedKVState`; wires itself
    in as the allocator's reclaim / evictable callbacks. `stats` is the
    engine's counter dict: eviction bumps ``evicted_pages``."""

    def __init__(self, kv: PagedKVState, stats: Optional[Dict] = None):
        self.kv = kv
        self.page_size = kv.page_size
        self.stats = stats if stats is not None else {"evicted_pages": 0}
        self.entries: Dict[int, _Entry] = {}
        self._tick = 0
        # keys pinned for the current admission batch: matched in the gate
        # but not yet ref'd by kv.admit, so reclaim must not evict them
        # (the engine clears them after the batch)
        self.protected: Set[int] = set()
        kv.reclaim_cb = self.reclaim
        kv.evictable_cb = self.evictable_count

    def __len__(self) -> int:
        return len(self.entries)

    # ---- lookup -----------------------------------------------------------

    def match(self, tokens: np.ndarray, probe: bool = False
              ) -> Tuple[int, List[int], List[int]]:
        """Longest indexed prefix of `tokens` (full chunks only). Returns
        ``(matched_tokens, page_ids, keys)``. Bumps the LRU tick of every
        matched entry unless `probe` (victim costing must not distort
        recency)."""
        toks = np.asarray(tokens)
        pages: List[int] = []
        keys: List[int] = []
        parent: Optional[int] = None
        self._tick += 1
        for i in range(toks.shape[0] // self.page_size):
            chunk = toks[i * self.page_size:(i + 1) * self.page_size]
            key, b = _chunk_key(parent, chunk)
            e = self.entries.get(key)
            if e is None or e.tokens != b:
                break
            if not probe:
                e.tick = self._tick
            pages.append(e.page)
            keys.append(key)
            parent = key
        return len(pages) * self.page_size, pages, keys

    def match_len(self, tokens: np.ndarray) -> int:
        """Probe only: the indexed prefix length in tokens (the part of a
        re-prefill the index would cover; preemption victim costing)."""
        return self.match(tokens, probe=True)[0]

    # ---- registration -----------------------------------------------------

    def register(self, tokens: np.ndarray, n: int,
                 table_row: np.ndarray) -> int:
        """Adopt the full-chunk pages of `tokens[:n]`, just prefilled into
        a slot whose block-table row is `table_row`. Chunks already indexed
        are skipped: the existing entry's page is canonical. Returns the
        number of pages newly adopted."""
        toks = np.asarray(tokens)
        parent: Optional[int] = None
        adopted = 0
        self._tick += 1
        for i in range(min(int(n), toks.shape[0]) // self.page_size):
            chunk = toks[i * self.page_size:(i + 1) * self.page_size]
            key, b = _chunk_key(parent, chunk)
            e = self.entries.get(key)
            if e is not None:
                if e.tokens != b:          # hash collision: stop the chain
                    break
                e.tick = self._tick
                parent = key
                continue
            page = int(table_row[i])
            if page == 0:
                raise PageAccountingError("registering an unmapped page")
            self.entries[key] = _Entry(key, parent, b, page, tick=self._tick)
            self.kv.mark_cached(page)
            if parent is not None:
                self.entries[parent].children += 1
            adopted += 1
            parent = key
        return adopted

    # ---- pinning (admission-batch window) ---------------------------------

    def protect(self, keys: Sequence[int]) -> None:
        self.protected.update(keys)

    def unprotect_all(self) -> None:
        self.protected.clear()

    # ---- eviction ---------------------------------------------------------

    def _evictable(self, e: _Entry) -> bool:
        return (e.children == 0 and e.key not in self.protected
                and self.kv.ref[e.page] == 0)

    def evictable_count(self) -> int:
        """How many pages :meth:`reclaim` could free now, counted
        transitively: evicting a leaf may expose its parent."""
        extra: Dict[int, int] = {}
        out = 0
        frontier = [e for e in self.entries.values() if self._evictable(e)]
        seen: Set[int] = set()
        while frontier:
            nxt: List[_Entry] = []
            for e in frontier:
                if e.key in seen:
                    continue
                seen.add(e.key)
                out += 1
                if e.parent is not None:
                    p = self.entries[e.parent]
                    extra[p.key] = extra.get(p.key, 0) + 1
                    if (p.children - extra[p.key] == 0
                            and p.key not in self.protected
                            and self.kv.ref[p.page] == 0):
                        nxt.append(p)
            frontier = nxt
        return out

    def reclaim(self, k: int) -> int:
        """Evict least recently matched leaf entries with refcount-zero
        pages until `k` pages are freed or nothing is evictable (the
        allocator's ``reclaim_cb``). Returns the pages freed."""
        freed = 0
        while freed < k:
            cands = [e for e in self.entries.values() if self._evictable(e)]
            if not cands:
                break
            e = min(cands, key=lambda c: c.tick)
            del self.entries[e.key]
            if e.parent is not None:
                self.entries[e.parent].children -= 1
            if self.kv.uncache(e.page):
                freed += 1
                self.stats["evicted_pages"] = \
                    self.stats.get("evicted_pages", 0) + 1
        return freed

    def check_invariants(self) -> None:
        """Audit index <-> pool consistency: every indexed page is marked
        cached in the pool and not free, no two entries claim one page,
        every parent exists, and the children counts match the index.
        Raises :class:`PageAccountingError`."""
        def fail(msg):
            raise PageAccountingError(f"prefix index violated: {msg}")

        owner: Dict[int, int] = {}
        kids: Dict[int, int] = {}
        free = set(self.kv._free)
        for e in self.entries.values():
            if not self.kv.cached[e.page]:
                fail(f"entry {e.key} page {e.page} not marked cached")
            if e.page in free:
                fail(f"entry {e.key} page {e.page} is on the free list")
            if e.page in owner:
                fail(f"page {e.page} indexed by entries {owner[e.page]} "
                     f"and {e.key}")
            owner[e.page] = e.key
            if e.parent is not None:
                if e.parent not in self.entries:
                    fail(f"entry {e.key} parent {e.parent} missing")
                kids[e.parent] = kids.get(e.parent, 0) + 1
        for e in self.entries.values():
            if e.children != kids.get(e.key, 0):
                fail(f"entry {e.key} children {e.children} != indexed "
                     f"extensions {kids.get(e.key, 0)}")
        if len(owner) != self.kv.cached_page_count:
            fail(f"{self.kv.cached_page_count} pages marked cached but "
                 f"{len(owner)} indexed")

    def clear(self) -> int:
        """Drop every entry. Every page must be at refcount zero (the
        engine is drained). Returns the pages freed."""
        total = 0
        while True:
            freed = self.reclaim(len(self.entries) + 1)
            total += freed
            if not freed:
                break
        if self.entries:
            raise PageAccountingError("clear() with live sharers still mapped")
        return total
