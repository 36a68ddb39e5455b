"""Paged gather decode attention: the CUDA kernel
``csrc/paged_attention.cu`` (replacing the TPU kernel
``repro/kernels/paged_attention.py::paged_decode_attention``), its wrapper,
its launch planner and its plain version (``ref.paged_attention_ref``).

Single-token GQA attention: each slot walks its block table over
``(n_pages, page_size, Hkv, D)`` K/V pools with an f32 online softmax;
virtual row r is valid when ``q_pos - ((cache_pos - r) mod rows) >= 0``
(and inside ``window`` when set), so unmapped entries pointing at the
null page 0 mask out.

The kernel runs the split page walk of ``csrc/paged_walk.cuh``, which
the decode megakernel shares: work items (slot, kv head, split), the
split count from :func:`_plan_paged`, pages without a valid row never
loaded, QKᵀ and PV on the tensor cores for bf16 pools (the CUDA cores
for f32), and the splits merged in split order in the same launch.
:func:`split_walk_model` is that walk and merge in plain PyTorch, for
the CPU tests.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SMS = 132                  # H100 SXM streaming multiprocessors
_ITEMS_TARGET = 2 * _SMS    # work items the plan aims for: two per SM
_MAX_SPLITS = 64            # splits per (slot, head) at most
_MAX_HEAD_ELEMS = 4096      # G * D at most (PV items per thread)

_CLUSTER = 8                # kernel #2: splits per (slot, head), one cluster
_SIGNATURES = {
    "nq_paged_attention": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]),
    "nq_paged_attention_clusters": [ctypes.c_int] * 6 + [ctypes.c_void_p]}


def _plan_paged(B: int, Hkv: int, pages: int, sms: int = _SMS,
                max_splits: int = _MAX_SPLITS) -> dict:
    """The split page walk's plan: each (slot, kv head)'s ``pages`` table
    entries are cut into ``splits`` contiguous runs of at most
    ``entries_per_split``, none empty, so that the B * Hkv * splits work
    items reach ``sms`` (the blocks the card runs at once) where the
    table allows it; one split when the (slot, head) pairs alone fill
    the card or the table has one entry. At most ``max_splits`` splits
    (kernel #2: a cluster's 8; the megakernel: _MAX_SPLITS)."""
    if min(B, Hkv, pages, sms) < 1:
        raise ValueError(f"cannot plan a walk of B={B}, Hkv={Hkv}, "
                         f"pages={pages} on {sms} blocks")
    base = B * Hkv
    want = max(1, min(pages, max_splits, -(-sms // base)))
    eps = -(-pages // want)
    for e in range(eps, 0, -1):           # the longest runs that reach want
        n = -(-pages // e)
        if n > max_splits:
            break
        if n >= want:
            eps = e
            break
    splits = -(-pages // eps)
    return {"splits": splits, "entries_per_split": eps,
            "items": base * splits, "sms": sms, "max_splits": max_splits}


_clusters_cache: dict = {}


def _cluster_cap(lib, pairs: int, G: int, D: int, PS: int, pages: int,
                 code: int) -> int:
    """The most splits per (slot, head), at most _CLUSTER, whose clusters
    all fit on the current card at once for ``pairs`` (slot, head) pairs
    (the occupancy query for each cluster size, cached): a second wave of
    clusters would cost more than the splits save (measured on the H100:
    llama3.2-1b B = 8 at 4 splits holds 62 of its 64 clusters, and took
    0.0251 ms in f32 against 0.0182 at 2 splits)."""
    key = (G, D, PS, pages, code)
    if key not in _clusters_cache:
        fits = []
        for splits in range(1, _CLUSTER + 1):
            n = ctypes.c_int(0)
            build.check_launch("paged_decode_attention occupancy",
                               lib.nq_paged_attention_clusters(
                                   G, D, PS, pages, splits, code,
                                   ctypes.byref(n)))
            fits.append(n.value)
        _clusters_cache[key] = fits
    fits = _clusters_cache[key]
    return max([1] + [s + 1 for s, n in enumerate(fits) if n >= pairs])


def _row_valid(r, q_pos, cache_pos, rows: int, window: int,
               exclude_cache_row: bool):
    """(B, V) mask of the virtual rows ``r`` each slot attends."""
    qp, cp = q_pos.long()[:, None], cache_pos.long()[:, None]
    abs_pos = qp - torch.remainder(cp - r[None, :], rows)
    m = abs_pos >= 0
    if window:
        m = m & (abs_pos > qp - window)
    if exclude_cache_row:
        m = m & (r[None, :] != cp)
    return m


def split_walk_model(q, k_pool, v_pool, block_table, q_pos, cache_pos, *,
                     window: int = 0, scale: float = 1.0, splits: int = 1,
                     exclude_cache_row: bool = False,
                     skip_masked_pages: bool = True):
    """The kernel's split page walk and ordered merge in plain PyTorch.

    q: (B, Hq, D) f32; pools, block table and positions as for
    :func:`paged_decode_attention`. Each (slot, kv head)'s table is cut as
    :func:`_plan_paged` cuts it into ``splits`` runs; each run folds its
    pages one at a time into an f32 online softmax (m, l, acc), skipping
    a page with no valid row when ``skip_masked_pages``; the runs merge in
    split order. Without ``skip_masked_pages`` every page is loaded and
    its masked rows score -1e30, as the Pallas kernel does.
    ``exclude_cache_row`` leaves out row r == cache_pos (the megakernel's
    walk). Returns the merged (m (B, Hkv, G), l (B, Hkv, G),
    acc (B, Hkv, G, D)), unnormalised."""
    B, Hq, D = q.shape
    NP, PS, Hkv, _ = k_pool.shape
    pages = block_table.shape[1]
    G = Hq // Hkv
    rows = pages * PS
    eps = -(-pages // splits)
    qg = q.float().reshape(B, Hkv, G, D)
    valid = _row_valid(torch.arange(rows), q_pos, cache_pos, rows, window,
                       exclude_cache_row).reshape(B, pages, PS)
    parts = []
    for s in range(-(-pages // eps)):
        m = torch.full((B, Hkv, G), -torch.inf)
        l = torch.zeros((B, Hkv, G))
        acc = torch.zeros((B, Hkv, G, D))
        for e in range(s * eps, min(pages, (s + 1) * eps)):
            ok = valid[:, e]                                   # (B, PS)
            need = ok.any(dim=1)
            if skip_masked_pages and not bool(need.any()):
                continue
            k = k_pool[block_table[:, e].long()].float()       # (B, PS, Hkv, D)
            v = v_pool[block_table[:, e].long()].float()
            sc = torch.einsum("bhgd,bphd->bhgp", qg, k) * scale
            sc = torch.where(ok[:, None, None], sc, -1e30)  # the Pallas mask
            m_new = torch.maximum(m, sc.amax(dim=-1))
            if skip_masked_pages:       # slots without a valid row here
                m_new = torch.where(need[:, None, None], m_new, m)
            p = torch.where(ok[:, None, None],
                            torch.exp(sc - m_new[..., None]), 0.0)
            alpha = torch.where(m_new == m, 1.0, torch.exp(m - m_new))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgp,bphd->bhgd",
                                                        p, v)
            m = m_new
        parts.append((m, l, acc))
    mt = torch.stack([p[0] for p in parts]).amax(dim=0)
    l_t = torch.zeros_like(mt)
    acc_t = torch.zeros((B, Hkv, G, D))
    for m, l, acc in parts:                       # in split order
        wt = torch.where(torch.isinf(m), 0.0, torch.exp(m - mt))
        l_t = l_t + l * wt
        acc_t = acc_t + acc * wt[..., None]
    return mt, l_t, acc_t


def paged_decode_attention(q, k_pool, v_pool, block_table, q_pos, cache_pos,
                           *, window: int = 0, scale: float = 1.0):
    """q: (B, 1, Hq, D); k_pool / v_pool: (n_pages, page_size, Hkv, D);
    block_table: (B, pages) int32; q_pos / cache_pos: (B,) int32.
    Returns (B, 1, Hq, D) in q's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    B, S, Hq, D = q.shape
    NP, PS, Hkv, Dk = k_pool.shape
    if S != 1:
        raise ValueError("paged_decode_attention reads one token per slot")
    if Dk != D or Hq % Hkv or tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError(f"q {tuple(q.shape)} does not match pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(q_pos.shape) != (B,) or tuple(cache_pos.shape) != (B,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / "
                         f"positions do not match batch {B}")
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_table, q_pos,
                                       cache_pos, window=window, scale=scale)
    name = "paged_decode_attention"
    build.check_cuda(name, q.dtype, q=q, k_pool=k_pool, v_pool=v_pool)
    build.check_cuda(name, torch.int32, block_table=block_table,
                     q_pos=q_pos, cache_pos=cache_pos)
    build.check_cuda(name, q=q, block_table=block_table)
    check_walk_shapes(name, k_pool, v_pool, Hq // Hkv, block_table.shape[1])
    code = build.dtype_code(q)
    pages = block_table.shape[1]
    G = Hq // Hkv
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = build.library("paged_attention", _SIGNATURES)
    plan = _plan_paged(B, Hkv, pages, _ITEMS_TARGET,
                       _cluster_cap(lib, B * Hkv, G, D, PS, pages, code))
    err = lib.nq_paged_attention(
        build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
        build.ptr(block_table), build.ptr(q_pos), build.ptr(cache_pos),
        build.ptr(out), B, pages, PS, Hkv, G, D, int(window), float(scale),
        plan["entries_per_split"], plan["splits"], code,
        build.current_stream(q.device))
    build.check_launch(name, err)
    paged_decode_attention.launches += 1
    paged_decode_attention.plan = plan
    return out


def check_walk_shapes(name: str, k_pool, v_pool, G: int, pages: int) -> None:
    """Raise on a pool or table the split walk does not take: 16-byte
    copies need D a multiple of 8 and 16-byte aligned pools; at most
    _MAX_HEAD_ELEMS query values per kv head; at least one table entry."""
    D = k_pool.shape[-1]
    if D % 8 or G * D > _MAX_HEAD_ELEMS or G > 16 or pages < 1:
        raise ValueError(f"{name}: head_dim {D} (a multiple of 8), "
                         f"{G} query heads per kv head and {pages} table "
                         f"entries are outside what the kernel takes")
    for nm, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} must be 16-byte aligned")


paged_decode_attention.launches = 0
paged_decode_attention.plan = None           # the last launch's plan
