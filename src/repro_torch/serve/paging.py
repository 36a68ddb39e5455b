"""Paged KV cache: one pool of fixed-size KV pages plus per-slot block
tables — the parts of ``repro.serve.paging`` the engine uses.

- :class:`PagedKVState` — host-side free-list allocator and block tables.
  Pages are reserved at admission for the prompt (``admit``), lazily as
  decode crosses a page boundary (``ensure`` / ``reserve_rows``), given
  back when a speculative cycle rejects drafted rows (``trim``), and
  freed when the slot completes or is preempted (``release``); an external
  holder can borrow pages and give them back (``borrow_pages`` /
  ``return_pages``, the dry-pool fault seam). Page 0 is the
  *null page*: unmapped table entries point at it, so inactive slots'
  decode writes land in trash instead of in a neighbour's page. Pages are
  refcounted, so the prefix cache (``serve.prefix``) can map one page
  into several slots and copy it on write (``cow``).
- :func:`init_paged_cache` — the device pool: each block stack's cache
  leaves become ``(n_layers, n_pages, page_size, *row)``, K/V rows of
  ``(Hkv, D)`` or MLA's compressed latent ``c_kv`` ``(dc,)`` and shared
  RoPE key ``k_rope`` ``(1, dr)`` (the MoE family's ``dense_layers`` have
  a pool of their own, read through the same block tables). The hybrid's
  cache is mixed: its shared block's K/V pool ``(n_apps, n_pages,
  page_size, Hkv, D)`` sits next to the Mamba2 stack's state leaves,
  which have no sequence extent and stay slot-indexed ``(L, B, ...)``.
  The VLM's is mixed too: its self layers' pool ``(groups, per, n_pages,
  page_size, Hkv, D)`` (two leading layer axes) beside ``cross_kv``, each
  cross layer's image K/V ``(groups, B, n_img, Hkv, D)``, slot-indexed:
  its leaves carry pool names (k / v), so what is pooled is decided by
  stack and leaf (:func:`is_pool_leaf`), as the reference decides it by
  path.
- :func:`paged_insert_slot` / :func:`paged_select_active` — the paged
  twins of the scheduler's slot cache ops (pool leaves through the block
  tables, state leaves by slot); :func:`copy_page` — the device side of a
  copy-on-write.

Two page kinds exist, as in the reference: ``"linear"`` (page ``j`` of a
slot holds rows ``[j*page_size, (j+1)*page_size)``, mapped as the slot
grows) and ``"ring"`` (the hybrid's shared-attention sliding-window ring:
``ring_pages`` pages mapped in full at admission, writes wrapping modulo
the slot's virtual ring ``ring_pages * page_size``). Block tables are
ordered by logical page, so a slot's gathered pages form a virtual
rectangle whose row index equals the (possibly ring-wrapped) cache
position — the decode read is the rectangular decode mask over the
gather.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.models.config import check_family
from repro_torch.models.transformer import (cache_leaves, image_cache,
                                             lead_axes, n_shared_apps,
                                             stack_lead, state_cache,
                                             torch_dtype)

# leaf names of the attention cache: GQA's k / v, MLA's c_kv / k_rope
_POOL_LEAVES = ("k", "v", "c_kv", "k_rope")
# stacks whose attention-cache leaves have no sequence extent and stay
# slot-indexed (B at axis 1): the VLM's image K/V
_SLOT_STACKS = ("cross_kv",)


def is_pool_leaf(stack: str, name: str) -> bool:
    """Whether leaf `name` of cache stack `stack` is paged (read through
    the block tables) rather than slot-indexed: the reference's
    ``page_kind(path) is not None``."""
    return name in _POOL_LEAVES and stack not in _SLOT_STACKS


def _layers_flat(stack: str, t):
    """A stack's leaf with its leading layer axes flattened into one (a
    view: the VLM's self layers (groups, per, ...) -> (groups·per, ...))."""
    return t.flatten(0, lead_axes(stack) - 1)


def page_kind(stack: str) -> str:
    """The page kind of a stack's pool: the hybrid's shared-attention ring,
    or linear pages."""
    return "ring" if stack == "shared_attn" else "linear"


def cache_page_kinds(cfg) -> Set[str]:
    """Which page kinds `cfg`'s cache contains: ``{"linear"}`` for the
    attention families, ``{"ring"}`` for the hybrid (its shared block's
    sliding-window ring), the empty set for the SSM family, whose
    recurrent state does not grow with the sequence (the engine then keeps
    the per-slot state cache, as the reference's does)."""
    check_family(cfg)
    return {"ssm": set(), "hybrid": {"ring"}}.get(cfg.family, {"linear"})


class PageAccountingError(AssertionError):
    """A page-pool invariant was violated (leaked page, refcount
    mismatch, block table mapping a page its slot does not own)."""


def init_paged_cache(cfg, n_pages: int, page_size: int, device="cuda",
                     batch: Optional[int] = None, mesh=None):
    """Pool-shaped cache, one pool per block stack: {stack: {leaf: (*lead,
    n_pages, page_size, *row)}} over ``transformer.cache_leaves`` (k / v
    rows (Hkv, D); MLA's c_kv (dc,) and k_rope (1, dr)) in the model
    dtype, `lead` the stack's layer axes (``transformer.stack_lead``).
    Every stack's pool is indexed by the same page ids. The hybrid's is
    mixed: {"layers": the Mamba2 state of `batch` slots
    (``transformer.state_cache``), "shared_attn": {"k" / "v": (n_apps,
    n_pages, page_size, Hkv, D)}}; so is the VLM's: {"self_layers": the
    pool of (groups, per) layers, "cross_kv": the image K/V of `batch`
    slots (``transformer.image_cache``)}.

    With a tensor-parallel `mesh` the pools hold this rank's kv heads
    (``quant.surgery.local_cache``: the placement of
    ``sharding.rules.cache_pspecs(paged=True)``), so
    :func:`kv_cache_bytes` reports this rank's bytes."""
    if mesh is not None:
        from repro_torch.quant.surgery import local_cache
        return local_cache(lambda dev: init_paged_cache(
            cfg, n_pages, page_size, dev, batch), cfg, mesh, device)
    kinds = cache_page_kinds(cfg)
    if not kinds:
        raise ValueError(f"family {cfg.family!r} has no pageable KV cache")
    dt = torch_dtype(cfg)

    def pool(lead):
        return {leaf: torch.zeros(lead + (n_pages, page_size) + row,
                                  dtype=dt, device=device)
                for leaf, row in cache_leaves(cfg).items()}
    if batch is None and cfg.family in ("hybrid", "vlm"):
        raise ValueError(f"the {cfg.family}'s pool sits beside per-slot "
                         f"leaves: pass batch")
    if "ring" in kinds:
        return {"layers": state_cache(cfg, batch, device),
                "shared_attn": pool((n_shared_apps(cfg),))}
    cache = {name: pool(lead) for name, lead in stack_lead(cfg).items()}
    if cfg.family == "vlm":
        cache["cross_kv"] = image_cache(cfg, batch, device)
    return cache


def _pools(cache):
    """(stack name, leaf name, pool) of every pooled leaf, its layer axes
    flattened into one: (L, n_pages, page_size, ...) views."""
    return [(st, name, _layers_flat(st, pool))
            for st, leaves in cache.items()
            for name, pool in leaves.items() if is_pool_leaf(st, name)]


def paged_insert_slot(cache, single, tables: Dict[str, torch.Tensor],
                      slot: Optional[int] = None):
    """Scatter a freshly prefilled batch-1 rectangular cache (``single``:
    per stack, each leaf (L, 1, rows, *row)) into slot `slot`, in place.
    Pool leaves go into the slot's pages: ``tables[kind]`` is the slot's
    (pages,) page-id vector of the stack's page kind (:func:`page_kind`),
    unmapped tail entries 0 — rows in those pages land on the null page,
    which is trash by design; rows past the rectangle (a ring of
    ``ring_pages * page_size`` rows longer than the window) are zero.
    Slot-indexed leaves (the hybrid's Mamba2 state, the VLM's image K/V)
    are copied whole into slot `slot`, so nothing of its previous occupant
    survives there. Returns `cache`."""
    for stack, leaves in cache.items():
        for name, leaf in leaves.items():
            if not is_pool_leaf(stack, name):
                if slot is None:
                    raise ValueError("a cache with per-slot leaves needs "
                                     "the slot to insert into")
                leaf[:, slot] = single[stack][name][:, 0].to(leaf.dtype)
    for stack, name, pool in _pools(cache):
        ids = tables[page_kind(stack)].long()
        ps = pool.shape[2]
        x = _layers_flat(stack, single[stack][name])[:, 0]  # (L, rows, ...)
        pad = ids.shape[0] * ps - x.shape[1]
        if pad > 0:
            x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
        x = x[:, :ids.shape[0] * ps]
        pool[:, ids] = x.reshape(x.shape[0], ids.shape[0], ps,
                                 *x.shape[2:]).to(pool.dtype)
    return cache


def copy_page(cache, src: int, dst: int):
    """Copy-on-write on the device: duplicate page `src` into page `dst`
    across every layer of every stack's pooled leaves, in place
    (slot-indexed leaves untouched). Returns `cache`."""
    for _, _, pool in _pools(cache):
        pool[:, dst] = pool[:, src]
    return cache


def kv_cache_bytes(cache) -> int:
    """Bytes held by the attention cache's leaves (k / v, or MLA's c_kv /
    k_rope; the hybrid's ring pool; the VLM's pool and its per-slot image
    K/V) of a pool or a rectangle, keyed on the leaf name as in the
    reference; the state leaves do not count (0 for the SSM family's
    state cache)."""
    return sum(t.numel() * t.element_size() for leaves in cache.values()
               for name, t in leaves.items() if name in _POOL_LEAVES)


def paged_select_active(new, old, active):
    """Per-slot active select for a paged cache: pool leaves pass through
    (paged decode writes are slot-isolated by construction — inactive
    slots map the null page); slot-indexed leaves (batch axis 1) keep
    their old entries for inactive slots."""
    def sel(stack, name, n):
        if is_pool_leaf(stack, name):
            return n
        shape = [1] * n.dim()
        shape[1] = -1
        return torch.where(active.reshape(shape), n, old[stack][name])

    return {st: {k: sel(st, k, n) for k, n in leaves.items()}
            for st, leaves in new.items()}


class PagedKVState:
    """Host-side page allocator + per-slot block tables of each page kind
    (``kinds``: ``{"linear"}``, or the hybrid's ``{"ring"}`` with its
    ``window``).

    Pages [1, n_pages) are allocatable; page 0 is the null page. The
    default pool (``n_pages=None``) holds one worst-case slot footprint
    per slot (no overcommit): ``lin_pages`` linear pages for max_len rows
    plus ``ring_pages`` ring pages for ``min(max_len, window)`` rows, the
    ring mapped whole at admission. A smaller ``n_pages`` overcommits:
    admission gates on available pages, decode reserves lazily
    (``ensure``, ``reserve_rows``) and the engine preempts a slot when
    the pool runs dry.

    Pages are **refcounted** (the prefix cache, ``serve.prefix``): ``ref``
    counts slot block-table mappings and ``cached`` marks pages the prefix
    index holds. ``admit`` can map already-filled shared pages
    (``shared=``) read-only into a new slot, and a page returns to the
    free list only when its last mapping drops *and* the index no longer
    holds it: ``release`` and ``trim`` only ever decrement, so a page with
    live sharers is never reused. Writes into a shared page go through
    :meth:`cow` first (a fresh private copy, the table rewired). When the
    free list runs short, ``reclaim_cb`` (the index's LRU eviction) runs
    before an allocation fails.
    """

    def __init__(self, max_batch: int, max_len: int, page_size: int,
                 n_pages: Optional[int] = None, watermark: int = 0,
                 kinds: Set[str] = frozenset({"linear"}), window: int = 0):
        if not kinds or set(kinds) - {"linear", "ring"}:
            raise ValueError(f"page kinds {sorted(kinds)}: linear and/or "
                             f"ring")
        ps = max(1, min(int(page_size), max_len))
        self.page_size = ps
        self.has_linear = "linear" in kinds
        self.has_ring = "ring" in kinds
        self.lin_pages = -(-max_len // ps) if self.has_linear else 0
        win = min(max_len, window or max_len)
        self.ring_pages = -(-win // ps) if self.has_ring else 0
        per_slot = self.lin_pages + self.ring_pages
        if n_pages is None:
            n_pages = max_batch * per_slot + 1
        if n_pages < per_slot + 1:
            raise ValueError(
                f"kv_pool_pages={n_pages} cannot hold one slot's worst "
                f"case ({per_slot} pages + the null page); a lone "
                f"request could never complete")
        self.n_pages = int(n_pages)
        self.watermark = int(watermark)
        self.tables: Dict[str, np.ndarray] = {}
        if self.has_linear:
            self.tables["linear"] = np.zeros((max_batch, self.lin_pages),
                                             np.int32)
        if self.has_ring:
            self.tables["ring"] = np.zeros((max_batch, self.ring_pages),
                                           np.int32)
        self._free = list(range(self.n_pages - 1, 0, -1))  # pop() ascending
        self._slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self._mapped = [0] * max_batch        # linear pages mapped per slot
        # ref = live slot mappings, cached = the prefix index holds the
        # page; free <=> ref == 0 and not cached. The null page is neither.
        self.ref = np.zeros(self.n_pages, np.int32)
        self.cached = np.zeros(self.n_pages, bool)
        # pages borrowed by an external holder (fault injection): each
        # holds one reference, which check_invariants accounts for
        self.external: Set[int] = set()
        # wired by the prefix index: reclaim_cb(k) evicts up to k
        # refcount-zero cached pages (LRU) to the free list; evictable_cb()
        # counts how many it could (admission headroom)
        self.reclaim_cb: Optional[Callable[[int], int]] = None
        self.evictable_cb: Optional[Callable[[], int]] = None
        self.peak_used_pages = 0
        self._device_tables: Optional[Dict[str, torch.Tensor]] = None

    # ---- accounting -------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    @property
    def available_pages(self) -> int:
        """Pages obtainable now: the free list plus the cached pages the
        prefix index could evict on demand (refcount zero)."""
        ev = self.evictable_cb() if self.evictable_cb is not None else 0
        return len(self._free) + ev

    @property
    def shared_page_count(self) -> int:
        """Pages mapped by more than one slot."""
        return int((self.ref > 1).sum())

    @property
    def cached_page_count(self) -> int:
        """Pages the prefix index holds."""
        return int(self.cached.sum())

    def pages_for_prompt(self, n: int) -> int:
        """Pages an `n`-token prompt maps at admission: its linear pages
        and the whole ring."""
        lin = -(-n // self.page_size) if self.has_linear else 0
        return lin + self.ring_pages

    # ---- lifecycle --------------------------------------------------------

    def _ensure_free(self, k: int) -> bool:
        """Grow the free list to >= k pages, evicting refcount-zero cached
        pages through ``reclaim_cb`` if needed. False => the pool is dry
        (every page is mapped or held by a live sharer)."""
        if len(self._free) < k and self.reclaim_cb is not None:
            self.reclaim_cb(k - len(self._free))
        return len(self._free) >= k

    def _alloc(self, k: int) -> List[int]:
        if not self._ensure_free(k):
            raise PageAccountingError(
                f"allocating {k} pages with {len(self._free)} free")
        out = [self._free.pop() for _ in range(k)]
        for p in out:
            if self.ref[p] or self.cached[p]:
                raise PageAccountingError(
                    f"page {p} on the free list with live sharers")
            self.ref[p] = 1
        self.peak_used_pages = max(self.peak_used_pages, self.used_pages)
        return out

    def _unref(self, page: int) -> bool:
        """Drop one mapping of `page`; True when that freed it (its last
        mapping, and the index does not hold it)."""
        self.ref[page] -= 1
        if self.ref[page] < 0:
            raise PageAccountingError(f"page {page} refcount underflow")
        if self.ref[page] == 0 and not self.cached[page]:
            self._free.append(page)
            return True
        return False

    def admit(self, slot: int, n: int,
              shared: Sequence[int] = ()) -> Dict[str, np.ndarray]:
        """Reserve pages for an `n`-token prompt entering `slot`; returns
        the slot's fresh block-table row per kind (for
        :func:`paged_insert_slot`).

        shared: already-filled page ids (a prefix-index match) mapped
        read-only as the slot's leading linear pages; only the suffix pages
        are allocated. The refs are taken before any allocation, so a
        reclaim that the allocation triggers cannot evict the pages being
        shared. A ring is mapped whole, ``ring_pages`` fresh pages."""
        if self._slot_pages[slot]:
            raise PageAccountingError(f"slot {slot} pages leaked")
        self._device_tables = None
        ids: Dict[str, np.ndarray] = {}
        if self.has_linear:
            k = -(-n // self.page_size)
            if len(shared) > k:
                raise ValueError("shared prefix longer than the prompt")
            for p in shared:
                self.ref[p] += 1
            pages = list(shared) + self._alloc(k - len(shared))
            self._slot_pages[slot].extend(pages)
            self._mapped[slot] = k
            row = self.tables["linear"][slot]
            row[:] = 0
            row[:k] = pages
            ids["linear"] = row.copy()
        elif shared:
            raise ValueError("shared pages need a linear table")
        if self.has_ring:
            pages = self._alloc(self.ring_pages)
            self._slot_pages[slot].extend(pages)
            self.tables["ring"][slot] = pages
            ids["ring"] = np.asarray(pages, np.int32)
        return ids

    def ensure(self, slot: int, row: int) -> bool:
        """Map the linear page that will hold cache row `row` (the next
        decode write). False => pool exhausted (the caller preempts). Ring
        pages are mapped whole at admission: nothing to map."""
        return self.reserve_rows(slot, row + 1)

    def reserve_rows(self, slot: int, n_rows: int) -> bool:
        """Map pages so rows ``[0, n_rows)`` of `slot` are mapped; the
        speculative cycle writes up to k+1 rows before the next host read,
        so this may map several pages. False => pool exhausted even after
        reclaim, with the reservation partially applied: the caller
        preempts somebody and retries (pages already mapped stay mapped,
        so a retry is idempotent). A mapped page may still be shared:
        the engine copies it on write (:meth:`cow`). Without a linear
        table there is nothing to map."""
        if not self.has_linear:
            return True
        need = -(-n_rows // self.page_size)
        while self._mapped[slot] < need:
            if not self._ensure_free(1):
                return False
            page = self._alloc(1)[0]
            self._slot_pages[slot].append(page)
            self.tables["linear"][slot, self._mapped[slot]] = page
            self._mapped[slot] += 1
            self._device_tables = None
        return True

    def trim(self, slot: int, n_rows: int) -> int:
        """Rollback: unmap the pages past the one holding row
        ``n_rows - 1`` (the last committed write) and zero their table
        entries. Returns the count unmapped. Refcount-aware: a page
        reaches the free list only if this slot held its last mapping and
        the index does not hold it. The rejected rows need no cleanup on
        the device: rows past the committed frontier reconstruct to
        negative positions in the decode mask and are never read
        (``kernels.ref.paged_attention_ref``)."""
        if not self.has_linear:
            return 0
        keep = -(-n_rows // self.page_size)
        mapped = self._mapped[slot]
        if keep >= mapped:
            return 0
        row = self.tables["linear"][slot]
        dropped = [int(p) for p in row[keep:mapped]]
        row[keep:mapped] = 0
        for p in dropped:
            # by value: _slot_pages interleaves linear and ring pages
            self._slot_pages[slot].remove(p)
        for p in reversed(dropped):
            self._unref(p)
        self._mapped[slot] = keep
        self._device_tables = None
        return len(dropped)

    def release(self, slot: int) -> None:
        """Drop the slot's mappings (linear and ring) and zero its block
        table rows (a later occupant can never read a stale mapping).
        Pages with other sharers or held by the index survive; the others
        return to the free list."""
        for p in reversed(self._slot_pages[slot]):
            self._unref(p)
        self._slot_pages[slot] = []
        self._mapped[slot] = 0
        for t in self.tables.values():
            t[slot] = 0
        self._device_tables = None

    def borrow_pages(self, k: int) -> List[int]:
        """Take up to `k` pages out of the pool for an external holder
        (reclaiming cached pages if needed) and return their ids. Each
        holds one reference, so accounting stays exact while they are out;
        no block table maps them. Give them back with
        :meth:`return_pages`."""
        out: List[int] = []
        while len(out) < k and self._ensure_free(1):
            page = self._alloc(1)[0]
            self.external.add(page)
            out.append(page)
        return out

    def return_pages(self, pages: Sequence[int]) -> None:
        """Give borrowed pages back to the pool."""
        for p in pages:
            if p not in self.external:
                raise PageAccountingError(f"page {p} was not borrowed")
            self.external.discard(p)
            self._unref(p)

    def check_invariants(self) -> None:
        """Audit the pool; raise :class:`PageAccountingError` on the first
        violation. Checked: free <=> (ref == 0 and not cached); each ref
        equals the number of slots mapping the page plus one if it is
        borrowed; table rows of every kind map only pages their slot owns
        (never a borrowed one), each once; linear rows as a dense prefix
        of exactly ``_mapped`` pages, which are all the slot's pages but
        its ring's; no page is leaked."""
        def fail(msg: str):
            raise PageAccountingError(f"page accounting violated: {msg}")

        free = set(self._free)
        if len(free) != len(self._free):
            fail("duplicate pages on the free list")
        if 0 in free:
            fail("null page on the free list")
        if self.ref[0] != 0 or self.cached[0]:
            fail("null page acquired a reference")
        counts = np.zeros(self.n_pages, np.int64)
        for slot, pages in enumerate(self._slot_pages):
            if len(set(pages)) != len(pages):
                fail(f"slot {slot} maps a page twice")
            for p in pages:
                if not 0 < p < self.n_pages:
                    fail(f"slot {slot} owns out-of-range page {p}")
                counts[p] += 1
        for p in self.external:
            if not 0 < p < self.n_pages:
                fail(f"out-of-range page {p} borrowed")
            counts[p] += 1
        for p in range(1, self.n_pages):
            if counts[p] != self.ref[p]:
                fail(f"page {p}: ref={int(self.ref[p])} but "
                     f"{int(counts[p])} live mappings")
            if p in free and (self.ref[p] != 0 or self.cached[p]):
                fail(f"page {p} free with live sharers "
                     f"(ref={int(self.ref[p])}, "
                     f"cached={bool(self.cached[p])})")
            if p not in free and self.ref[p] == 0 and not self.cached[p]:
                fail(f"page {p} leaked (unreferenced, uncached, not on "
                     f"the free list)")
        for kind, tab in self.tables.items():
            for slot in range(tab.shape[0]):
                own = set(self._slot_pages[slot])
                mapped = [int(p) for p in tab[slot] if p != 0]
                for p in mapped:
                    if p not in own:
                        fail(f"slot {slot} {kind} table maps page {p} it "
                             f"does not own"
                             + (" (freed)" if p in free else "")
                             + (" (borrowed)" if p in self.external
                                else ""))
                if len(set(mapped)) != len(mapped):
                    fail(f"slot {slot} {kind} table maps a page twice")
        if self.has_linear:
            for slot, row in enumerate(self.tables["linear"]):
                m = self._mapped[slot]
                if (row[:m] == 0).any() or (row[m:] != 0).any():
                    fail(f"slot {slot} linear row not a dense prefix of {m} "
                         f"pages")
                ring = int((self.tables["ring"][slot] != 0).sum()) \
                    if self.has_ring else 0
                if len(self._slot_pages[slot]) - ring != m:
                    fail(f"slot {slot} owns "
                         f"{len(self._slot_pages[slot]) - ring} linear "
                         f"pages but maps {m}")

    # ---- prefix-cache sharing (serve.prefix) ------------------------------

    def mark_cached(self, page: int) -> None:
        """The prefix index now holds `page`: it stays off the free list
        even at refcount zero, until :meth:`uncache`."""
        if page == 0 or self.ref[page] <= 0:
            raise PageAccountingError(
                f"page {page} must be live when the index adopts it")
        self.cached[page] = True

    def uncache(self, page: int) -> bool:
        """The index drops `page`; True when that freed it (refcount was
        already zero)."""
        if not self.cached[page]:
            raise PageAccountingError(f"page {page} not index-held")
        self.cached[page] = False
        if self.ref[page] == 0:
            self._free.append(page)
            return True
        return False

    def next_shared_write_page(self, slot: int, row0: int,
                               row1: int) -> Optional[int]:
        """First logical page covering rows [row0, row1) that `slot`
        cannot write privately (shared with another slot or held by the
        index); None when the whole range is private (or there is no linear
        table: ring pages are never shared)."""
        if not self.has_linear or row0 >= row1:
            return None
        row = self.tables["linear"][slot]
        for i in range(row0 // self.page_size, -(-row1 // self.page_size)):
            p = int(row[i])
            if p and (self.ref[p] > 1 or self.cached[p]):
                return i
        return None

    def cow(self, slot: int, page_idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write logical page `page_idx` of `slot`: map a fresh
        private page in its place and return ``(src, dst)`` for the device
        copy (:func:`copy_page`). The source keeps its other references.
        None => pool dry even after reclaim (the caller preempts and
        retries)."""
        if not self._ensure_free(1):
            return None
        src = int(self.tables["linear"][slot, page_idx])
        if src == 0:
            raise PageAccountingError(f"slot {slot} page {page_idx} unmapped")
        dst = self._alloc(1)[0]
        self.tables["linear"][slot, page_idx] = dst
        self._slot_pages[slot].remove(src)
        self._slot_pages[slot].append(dst)
        self._unref(src)
        self._device_tables = None
        return src, dst

    def device_tables(self, device) -> Dict[str, torch.Tensor]:
        """Block tables as device tensors; reused until a table changes,
        so steady-state decode does no host-to-device copy."""
        if self._device_tables is None:
            self._device_tables = {k: torch.from_numpy(v.copy()).to(device)
                                   for k, v in self.tables.items()}
        return self._device_tables
