"""Decode-step megakernel: the CUDA kernel ``csrc/megakernel.cu``
(replacing the TPU kernel ``repro/kernels/megakernel.py::
decode_step_megakernel_raw``), its wrapper and its plain version
(``ref.decode_step_ref``).

One launch runs the attention half of a decode step for B slots:
merged-QKV packed matmul → RoPE at q_pos → page walk excluding the row
``== cache_pos mod rows`` → fold of the fresh k/v → normalise → packed
wo. It
returns ``y`` plus the fresh ``k_new`` / ``v_new`` rows in the pool
dtype for the caller's paged cache write; the pools are only read.

The kernel takes the B <= 8 slots as the rows of one tile of the ±1
tensor-core routine (``csrc/binary_mma.cuh``), so every packed word is
read once per launch, and walks the pages with the split walk of
``csrc/paged_walk.cuh``; its phases are work items of one cooperative
launch planned by :func:`_plan_mega`, meeting through per-item flags.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import binary_matmul, build, paged_attention, ref
from repro_torch.kernels.build import KernelError
from repro_torch.kernels.binary_matmul import _aligned

_SLOTS = 8                  # slots per launch: the rows of one n8 tile
_TILE = 128                 # columns per tile of the ±1 routine (BN)

_SIGNATURES = {
    "nq_decode_megakernel": ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 23
                             + [ctypes.c_uint, ctypes.c_float,
                                ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p]),
    "nq_decode_megakernel_blocks": [ctypes.c_int] * 6 + [ctypes.c_void_p]}


def _slices(base: int, kw: int, blocks: int):
    """K slices of a stage 1 with ``base`` items per slice, as kernel #1
    cuts them (``binary_matmul._plan_fused``): while the items fall short
    of ``blocks``, at least _MIN_SLICE_WORDS words each, none empty.
    Returns (slices, words per slice)."""
    want = max(1, min(blocks // base, kw // binary_matmul._MIN_SLICE_WORDS))
    per = -(-kw // want)
    return -(-kw // per), per


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def _plan_mega(B: int, K: int, r_eff: int, nq: int, nkv: int, Ko: int,
               ro_eff: int, No: int, Hkv: int, G: int, D: int, pages: int,
               blocks: int, *, terms: int = 3) -> dict:
    """The megakernel's plan for B <= 8 slots. ``blocks``: how many blocks
    fit on the card at once (the occupancy query times the SMs); the
    cooperative grid is never larger, so its barriers cannot deadlock.

    Phase items: QKV stage 1 (group, rank tile, K slice), QKV stage 2
    (group, output tile, each group over its own width: nq, nkv, nkv),
    the walk (slot, kv head, split; ``paged_attention._plan_paged`` on
    ``blocks``), wo stage 1 (rank tile, K slice), wo stage 2 (output
    tile). The phases meet through per-item flags, not grid barriers.
    The workspace (f32 words) mirrors ``Work`` in ``csrc/megakernel.cu``;
    ``tickets`` counts the self-resetting arrival counters, ``flags`` the
    flags."""
    r_tiles, ro_tiles = -(-r_eff // _TILE), -(-ro_eff // _TILE)
    s1, s1_kw = _slices(3 * r_tiles, K // 32, blocks)
    so, o_kw = _slices(ro_tiles, Ko // 32, blocks)
    walk = paged_attention._plan_paged(B, Hkv, pages, blocks)
    items = {"qkv_stage1": 3 * r_tiles * s1,
             "qkv_stage2": -(-nq // _TILE) + 2 * -(-nkv // _TILE),
             "walk": walk["items"], "wo_stage1": ro_tiles * so,
             "wo_stage2": -(-No // _TILE)}
    ws = (_up4(3 * s1 * B * r_eff) + _up4(3 * terms * B * r_eff // 2)
          + _up4(B * (nq + 2 * nkv)) + _up4(B * Ko) + _up4(so * B * ro_eff)
          + _up4(terms * B * ro_eff // 2)
          + _up4(B * Hkv * walk["splits"] * (2 * G + G * D)))
    return {"blocks": blocks, "B": B, "terms": terms, "r_tiles": r_tiles,
            "ro_tiles": ro_tiles, "s1_slices": s1, "s1_kw": s1_kw,
            "o_slices": so, "o_kw": o_kw, "walk": walk, "items": items,
            "grid": max(1, min(blocks, max(items.values()))),
            "grid_barriers": 0, "workspace_floats": ws,
            "tickets": 3 * r_tiles + B * Hkv + ro_tiles,
            "flags": 3 * r_tiles + items["qkv_stage2"] + _SLOTS * Hkv
            + ro_tiles}


_blocks_cache: dict = {}
_epoch = 0


def _next_epoch() -> int:
    """A launch number for the kernel's flags: new for every launch and
    never 0 (a zeroed flag buffer holds no launch's number)."""
    global _epoch
    _epoch = _epoch % 0xFFFFFFFF + 1
    return _epoch


def _coresident_blocks(lib, B: int, G: int, D: int, PS: int, pages: int,
                       code: int) -> int:
    """Blocks of the megakernel that fit on the current card at once for
    these shapes (the occupancy query times the SMs), cached."""
    key = (B, G, D, PS, pages, code)
    if key not in _blocks_cache:
        n = ctypes.c_int(0)
        build.check_launch("decode_step_megakernel_raw occupancy",
                           lib.nq_decode_megakernel_blocks(
                               B, G, D, PS, pages, code, ctypes.byref(n)))
        _blocks_cache[key] = n.value
    return _blocks_cache[key]


def decode_step_megakernel_raw(x, mqkv, wo, k_pool, v_pool, block_table,
                               q_pos, cache_pos, *, dims, head_dim: int,
                               theta: float, scale: float, window: int = 0,
                               eff_rank: Optional[int] = None,
                               eff_rank_o: Optional[int] = None):
    """x: (B, K) one token per slot, K equal to the packed QKV operand's;
    mqkv: merged QKV group (qv (3, K//32, R), qu_t (3, R//32, Nmax),
    s1 (3, Nmax), s2 (3, K), rmask (3, R)); wo: packed output projection
    (qv (Ko//32, Ro), qu_t (Ro//32, No), s1 (No,), s2 (Ko,)); dims:
    (Hq*D, Hkv*D). Returns (y (B, No), k_new (B, Hkv, D), v_new
    (B, Hkv, D)). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    B, K = x.shape
    nq, nkv = dims
    hkv = nkv // head_dim
    NP, PS, Hkv_p, D_p = k_pool.shape
    if (Hkv_p, D_p) != (hkv, head_dim) or nq % nkv:
        raise KernelError(f"pools {tuple(k_pool.shape)} do not match dims "
                          f"{tuple(dims)} / head_dim {head_dim}")
    qv3, qu3 = mqkv["qv"], mqkv["qu_t"]
    R, Nmax = qv3.shape[-1], qu3.shape[-1]
    if qv3.shape != (3, K // 32, R) or K % 32 or qu3.shape != (3, R // 32, Nmax) \
            or Nmax < nq or Nmax < nkv:
        raise KernelError(f"merged QKV {tuple(qv3.shape)} / "
                          f"{tuple(qu3.shape)} does not match x "
                          f"{tuple(x.shape)}")
    Ko, Ro = wo["qv"].shape[0] * 32, wo["qv"].shape[1]
    No = wo["qu_t"].shape[1]
    if Ko < nq or wo["qu_t"].shape[0] * 32 != Ro:
        raise KernelError(f"wo {tuple(wo['qv'].shape)} / "
                          f"{tuple(wo['qu_t'].shape)} does not match dims")
    r_eff = R if eff_rank is None else int(eff_rank)
    ro_eff = Ro if eff_rank_o is None else int(eff_rank_o)
    if not (0 < r_eff <= R and r_eff % 32 == 0
            and 0 < ro_eff <= Ro and ro_eff % 32 == 0):
        raise KernelError(f"eff_rank {eff_rank} / eff_rank_o {eff_rank_o} "
                          f"must be multiples of 32 within ({R}, {Ro})")
    if x.device.type == "cpu":
        return ref.decode_step_ref(
            x, mqkv, wo, k_pool, v_pool, block_table, q_pos, cache_pos,
            head_dim=head_dim, dims=dims, theta=theta, scale=scale,
            window=window, eff_rank=eff_rank, eff_rank_o=eff_rank_o)
    name = "decode_step_megakernel_raw"
    rmask = mqkv.get("rmask")
    if rmask is None:
        rmask = torch.ones((3, R), dtype=torch.float32, device=x.device)
    build.check_cuda(name, x.dtype, x=x, k_pool=k_pool, v_pool=v_pool)
    build.check_cuda(name, torch.int32, qv3=qv3, qu3=qu3, qvo=wo["qv"],
                     quo=wo["qu_t"], block_table=block_table, q_pos=q_pos,
                     cache_pos=cache_pos)
    build.check_cuda(name, torch.float32, s1_3=mqkv["s1"], s2_3=mqkv["s2"],
                     rmask=rmask, s1o=wo["s1"], s2o=wo["s2"])
    build.check_cuda(name, x=x, qv3=qv3, s1o=wo["s1"])
    if tuple(block_table.shape[:1]) != (B,) or tuple(q_pos.shape) != (B,) \
            or tuple(cache_pos.shape) != (B,):
        raise KernelError("block_table / positions do not match the batch")
    G = nq // nkv
    pages = block_table.shape[1]
    paged_attention.check_walk_shapes(name, k_pool, v_pool, G, pages)
    code = build.dtype_code(x)
    y = torch.empty((B, No), dtype=x.dtype, device=x.device)
    k_new = torch.empty((B, hkv, head_dim), dtype=x.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    lib = build.library("megakernel", _SIGNATURES)
    x, s2_3, s2o, rmask = (_aligned(x), _aligned(mqkv["s2"]),
                           _aligned(wo["s2"]), _aligned(rmask))
    es = x.element_size()
    stream = build.current_stream(x.device)
    # the kernel's tile holds 8 slots: a larger batch runs 8 at a time,
    # each launch on its rows of x, the table, the positions and outputs
    for b0 in range(0, B, _SLOTS):
        n = min(B, b0 + _SLOTS) - b0
        plan, bufs, ints = _setup(
            lib, x, n, K, R, r_eff, Nmax, Ko, Ro, ro_eff, No, nq, nkv, hkv,
            head_dim, pages, PS, int(window), code)
        err = lib.nq_decode_megakernel(
            x.data_ptr() + b0 * K * es, qv3.data_ptr(), qu3.data_ptr(),
            s2_3.data_ptr(), mqkv["s1"].data_ptr(), rmask.data_ptr(),
            wo["qv"].data_ptr(), wo["qu_t"].data_ptr(), s2o.data_ptr(),
            wo["s1"].data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr() + b0 * pages * 4,
            q_pos.data_ptr() + b0 * 4, cache_pos.data_ptr() + b0 * 4,
            y.data_ptr() + b0 * No * es, k_new.data_ptr() + b0 * nkv * es,
            v_new.data_ptr() + b0 * nkv * es, *bufs, *ints, _next_epoch(),
            float(scale), float(theta), code, stream)
        build.check_launch(name, err)
        decode_step_megakernel_raw.launches += 1
        decode_step_megakernel_raw.plan = plan
    return y, k_new, v_new


_setups: dict = {}


def _setup(lib, x, n, K, R, r_eff, Nmax, Ko, Ro, ro_eff, No, nq, nkv, hkv,
           D, pages, PS, window, code):
    """Once per shape and device: the plan, its workspace, tickets and
    flags (reused by every launch of the shape on the device's stream, as
    the tickets are; the workspace holds nothing between launches) and
    the launch's integer arguments. Returns (plan, buffer pointers, ints);
    the host cost of a launch is then the kernel's arguments alone."""
    G = nq // nkv
    blocks = _coresident_blocks(lib, n, G, D, PS, pages, code)
    key = (x.get_device(), n, K, R, r_eff, Nmax, Ko, Ro, ro_eff, No, nq, nkv,
           D, pages, PS, window, code, blocks)
    hit = _setups.get(key)
    if hit is None:
        name = "decode_step_megakernel_raw"
        plan = _plan_mega(
            n, K, r_eff, nq, nkv, Ko, ro_eff, No, hkv, G, D, pages, blocks,
            terms=binary_matmul._terms(torch.float32, x.dtype))
        ws = torch.empty(plan["workspace_floats"], dtype=torch.float32,
                         device=x.device)
        tickets = build.tickets(name, x.device, plan["tickets"])
        flags = build.tickets(name + " flags", x.device, plan["flags"])
        ints = (n, K, R, r_eff, Nmax, Ko, Ro, ro_eff, No, nq, nkv, D, hkv,
                pages, PS, window, plan["s1_slices"], plan["s1_kw"],
                plan["o_slices"], plan["o_kw"],
                plan["walk"]["entries_per_split"], plan["walk"]["splits"],
                plan["grid"])
        hit = (plan, (ws.data_ptr(), tickets.data_ptr(), flags.data_ptr()),
               ints, (ws, tickets, flags))   # the last keeps them alive
        _setups[key] = hit
    return hit[:3]


decode_step_megakernel_raw.launches = 0
decode_step_megakernel_raw.plan = None       # the last launch's plan
