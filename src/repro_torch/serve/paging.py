"""Paged KV cache: one pool of fixed-size KV pages plus per-slot block
tables — the parts of ``repro.serve.paging`` the engine uses.

- :class:`PagedKVState` — host-side free-list allocator and block tables.
  Pages are reserved at admission for the prompt (``admit``), lazily as
  decode crosses a page boundary (``ensure`` / ``reserve_rows``), given
  back when a speculative cycle rejects drafted rows (``trim``), and
  freed when the slot completes or is preempted (``release``). Page 0 is the
  *null page*: unmapped table entries point at it, so inactive slots'
  decode writes land in trash instead of in a neighbour's page.
- :func:`init_paged_cache` — the device pool: the dense family's K/V
  leaves become ``(n_layers, n_pages, page_size, Hkv, D)``.
- :func:`paged_insert_slot` / :func:`paged_select_active` — the paged
  twins of the scheduler's slot cache ops.

Block tables are ordered by logical page, so a slot's gathered pages form
a virtual rectangle whose row index equals the cache position — the
decode read is the rectangular decode mask over the gather.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.transformer import torch_dtype

# leaf names of the paged attention cache
_POOL_LEAVES = ("k", "v")


class PageAccountingError(AssertionError):
    """A page-pool invariant was violated (leaked page, refcount
    mismatch, block table mapping a page its slot does not own)."""


def init_paged_cache(cfg, n_pages: int, page_size: int, device="cuda"):
    """Pool-shaped cache {"layers": {"k", "v": (L, n_pages, page_size,
    Hkv, D)}} in the model dtype."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg)
    return {"layers": {k: torch.zeros(shape, dtype=dt, device=device)
                       for k in _POOL_LEAVES}}


def paged_insert_slot(cache, single, tables: Dict[str, torch.Tensor]):
    """Scatter a freshly prefilled batch-1 rectangular cache (``single``:
    k/v (L, 1, rows, Hkv, D)) into the slot's pages, in place.
    ``tables["linear"]``: the slot's (pages,) page-id vector, unmapped
    tail entries 0 — rows in those pages land on the null page, which is
    trash by design. Returns `cache`."""
    ids = tables["linear"].long()
    for name in _POOL_LEAVES:
        pool = cache["layers"][name]
        ps = pool.shape[2]
        x = single["layers"][name][:, 0]                  # (L, rows, ...)
        pad = ids.shape[0] * ps - x.shape[1]
        if pad > 0:
            x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
        x = x[:, :ids.shape[0] * ps]
        pool[:, ids] = x.reshape(x.shape[0], ids.shape[0], ps,
                                 *x.shape[2:]).to(pool.dtype)
    return cache


def paged_select_active(new, old, active):
    """Per-slot active select for a paged cache: pool leaves pass through
    (paged decode writes are slot-isolated by construction — inactive
    slots map the null page); slot-indexed leaves (batch axis 1) keep
    their old entries for inactive slots."""
    def sel(name, n):
        if name in _POOL_LEAVES:
            return n
        shape = [1] * n.dim()
        shape[1] = -1
        return torch.where(active.reshape(shape), n, old["layers"][name])

    return {"layers": {k: sel(k, n) for k, n in new["layers"].items()}}


class PagedKVState:
    """Host-side page allocator + per-slot linear block tables.

    Pages [1, n_pages) are allocatable; page 0 is the null page. The
    default pool (``n_pages=None``) holds one worst-case slot footprint
    per slot (no overcommit). A smaller ``n_pages`` overcommits:
    admission gates on free pages, decode reserves lazily (``ensure``,
    ``reserve_rows``)
    and the engine preempts a slot when the pool runs dry.
    """

    def __init__(self, max_batch: int, max_len: int, page_size: int,
                 n_pages: Optional[int] = None, watermark: int = 0):
        ps = max(1, min(int(page_size), max_len))
        self.page_size = ps
        self.lin_pages = -(-max_len // ps)
        if n_pages is None:
            n_pages = max_batch * self.lin_pages + 1
        if n_pages < self.lin_pages + 1:
            raise ValueError(
                f"kv_pool_pages={n_pages} cannot hold one slot's worst "
                f"case ({self.lin_pages} pages + the null page); a lone "
                f"request could never complete")
        self.n_pages = int(n_pages)
        self.watermark = int(watermark)
        self.tables: Dict[str, np.ndarray] = {
            "linear": np.zeros((max_batch, self.lin_pages), np.int32)}
        self._free = list(range(self.n_pages - 1, 0, -1))  # pop() ascending
        self._slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self._mapped = [0] * max_batch        # linear pages mapped per slot
        self.ref = np.zeros(self.n_pages, np.int32)
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
        return len(self._free)

    def pages_for_prompt(self, n: int) -> int:
        return -(-n // self.page_size)

    # ---- lifecycle --------------------------------------------------------

    def _alloc(self, k: int) -> List[int]:
        if len(self._free) < k:
            raise PageAccountingError(
                f"allocating {k} pages with {len(self._free)} free")
        out = [self._free.pop() for _ in range(k)]
        for p in out:
            self.ref[p] = 1
        return out

    def admit(self, slot: int, n: int) -> Dict[str, np.ndarray]:
        """Reserve pages for an `n`-token prompt entering `slot`; returns
        the slot's fresh block-table row per kind (for
        :func:`paged_insert_slot`)."""
        if self._slot_pages[slot]:
            raise PageAccountingError(f"slot {slot} pages leaked")
        self._device_tables = None
        k = self.pages_for_prompt(n)
        pages = self._alloc(k)
        self._slot_pages[slot].extend(pages)
        self._mapped[slot] = k
        row = self.tables["linear"][slot]
        row[:] = 0
        row[:k] = pages
        return {"linear": row.copy()}

    def ensure(self, slot: int, row: int) -> bool:
        """Map the page that will hold cache row `row` (the next decode
        write). False => pool exhausted (the caller preempts)."""
        return self.reserve_rows(slot, row + 1)

    def reserve_rows(self, slot: int, n_rows: int) -> bool:
        """Map pages so rows ``[0, n_rows)`` of `slot` are writable; the
        speculative cycle writes up to k+1 rows before the next host read,
        so this may map several pages. False => pool exhausted with the
        reservation partially applied: the caller preempts somebody and
        retries (pages already mapped stay mapped, so a retry is
        idempotent)."""
        need = -(-n_rows // self.page_size)
        while self._mapped[slot] < need:
            if not self._free:
                return False
            page = self._alloc(1)[0]
            self._slot_pages[slot].append(page)
            self.tables["linear"][slot, self._mapped[slot]] = page
            self._mapped[slot] += 1
            self._device_tables = None
        return True

    def trim(self, slot: int, n_rows: int) -> int:
        """Rollback: unmap the pages past the one holding row
        ``n_rows - 1`` (the last committed write), zero their table
        entries and return them to the pool. Returns the count. The
        rejected rows need no cleanup on the device: rows past the
        committed frontier reconstruct to negative positions in the
        decode mask and are never read (``kernels.ref.
        paged_attention_ref``)."""
        keep = -(-n_rows // self.page_size)
        mapped = self._mapped[slot]
        if keep >= mapped:
            return 0
        row = self.tables["linear"][slot]
        dropped = [int(p) for p in row[keep:mapped]]
        row[keep:mapped] = 0
        for p in dropped:
            self._slot_pages[slot].remove(p)
        for p in reversed(dropped):
            self._unref(p)
        self._mapped[slot] = keep
        self._device_tables = None
        return len(dropped)

    def _unref(self, page: int) -> None:
        """Drop one mapping of `page`; the last one frees it."""
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self._free.append(page)

    def release(self, slot: int) -> None:
        """Return the slot's pages to the free list and zero its block
        table row (a later occupant can never read a stale mapping)."""
        for p in reversed(self._slot_pages[slot]):
            self._unref(p)
        self._slot_pages[slot] = []
        self._mapped[slot] = 0
        self.tables["linear"][slot] = 0
        self._device_tables = None

    def check_invariants(self) -> None:
        """Audit the pool; raise :class:`PageAccountingError` on the
        first violation: the free list holds distinct pages with no
        mapping, every other page is mapped by exactly one slot, and each
        slot's table row is a dense prefix of the pages it owns."""
        def fail(msg: str):
            raise PageAccountingError(f"page accounting violated: {msg}")

        free = set(self._free)
        if len(free) != len(self._free):
            fail("duplicate pages on the free list")
        if 0 in free or self.ref[0] != 0:
            fail("null page on the free list or mapped")
        counts = np.zeros(self.n_pages, np.int64)
        for slot, pages in enumerate(self._slot_pages):
            for p in pages:
                if not 0 < p < self.n_pages:
                    fail(f"slot {slot} owns out-of-range page {p}")
                counts[p] += 1
        for p in range(1, self.n_pages):
            if counts[p] != self.ref[p]:
                fail(f"page {p}: ref={int(self.ref[p])} but "
                     f"{int(counts[p])} mappings")
            if counts[p] > 1:
                fail(f"page {p} mapped by {int(counts[p])} slots")
            if (p in free) == bool(counts[p]):
                fail(f"page {p} is {'free and mapped' if counts[p] else 'leaked'}")
        tab = self.tables["linear"]
        for slot in range(tab.shape[0]):
            m = self._mapped[slot]
            row = tab[slot]
            if (row[:m] == 0).any() or (row[m:] != 0).any():
                fail(f"slot {slot} linear row not a dense prefix of {m} pages")
            if sorted(int(p) for p in row[:m]) != sorted(self._slot_pages[slot]):
                fail(f"slot {slot} table maps pages it does not own")

    def device_tables(self, device) -> Dict[str, torch.Tensor]:
        """Block tables as device tensors; reused until a table changes,
        so steady-state decode does no host-to-device copy."""
        if self._device_tables is None:
            self._device_tables = {k: torch.from_numpy(v.copy()).to(device)
                                   for k, v in self.tables.items()}
        return self._device_tables
