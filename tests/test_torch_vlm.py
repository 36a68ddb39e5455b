"""The port's VLM family (llama-3.2-vision: groups of self-attention
blocks, each followed by a gated cross-attention block over per-slot image
K/V) against the JAX reference, on llama-3.2-vision-90b's smoke config (4
layers as 2 groups of 1 self block and 1 cross block, d 64, 4 query heads
over 2 kv heads of 16, d_ff 128, 16 image tokens) packed with
``min_dim=16``, so that every linear packs (wk / wv 64 -> 32 included).
The scalar gates are drawn N(1, 0.1) (``testing.GATE_LAWS``), away from
the reference's init of 0, which makes every cross block the identity.

Covered: the full-size template leaf for leaf (20 x 4 self blocks and 20
cross blocks, the ranks 4064 / 864 / 6336 at 1.0 bpw) and the smoke
template at ``min_dim`` 16 and 8; the merge (no ``wqkv`` in the cross
blocks, where JAX's merge builds one no layer reads) and a forward's
launches of #1; ``cross_attention`` and ``image_kv`` alone; the forward
with an image in f32 and in bf16 block by block; the rectangular prefill
with and without an image (logits, the self layers' rows, the image
K/V); the paged decode of three slots (one inactive) over the pool and
per-slot image K/V; the pool (its shapes, ``kv_cache_bytes``, insert,
select and copy on write against JAX's, other slots' image K/V left
alone) and the scheduler's slot ops on a rectangular VLM cache; the
engine's tokens against JAX's engine (image K/V zero in both) with its
``kv_cache_bytes``; no prefix index; ``generate`` with a seeded image
against JAX's ``generate`` (the image changes the tokens) and
``generate`` of every served family's smoke config against JAX's; the
speculative engine against JAX's ``SpecDecodeController`` (packed at 6
bpw, so that the draft truncates); drain, snapshot and restore; artifacts
both ways; ``launch.serve --arch llama-3.2-vision-90b``.

Inputs come from ``np.random.default_rng``; tolerances are
``_torch_common.tol`` (relative max-abs f32 1e-5, bf16 3e-2) per layer
and 1e-4 for whole-model logits (``tests/test_torch_model.py``); f32
engine and ``generate`` tokens are identical.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, cast_jax, draw_prompts, f32,
                           flat_templates, jax_engine, jax_tree,
                           leaves_equal, packed_model, pair, same_tokens,
                           serve_engine, tokens, tol, torch_params)
from repro import api as japi
from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant import surgery as jsurgery
from repro.serve import InferenceEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import paging as jpaging
from repro.serve import recovery as jrecovery
from repro.serve import scheduler as jscheduler
from repro.serve.engine import generate as jgenerate
from repro_torch import configs as tconfigs
from repro_torch.api import NanoQuantModel
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.quant import surgery as tsurgery
from repro_torch.serve import paging, recovery
from repro_torch.serve.engine import InferenceEngine, ServeConfig, generate
from repro_torch.serve.scheduler import (Request, cache_insert_slot,
                                         cache_select_active)
from repro_torch.testing import image_embeds

ARCH = "llama-3.2-vision-90b"
MIN_DIM = 16
LOGITS_TOL = 1e-4
MODES = {"ref": ops.KernelPolicy(mode="ref"),
         "kernels": ops.KernelPolicy(mode="cuda"),
         "unfused": ops.KernelPolicy(mode="cuda", megakernel=False)}
PS = 8                       # rows per page of the engine and pool tests


def _configs():
    cj, ct = f32(jconfigs.get_smoke(ARCH)), f32(tconfigs.get_smoke(ARCH))
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert ct.family == "vlm" and ct.cross_attn_every == 2
    return cj, ct


def _model(bpw=1.0, seed=0):
    cj, ct = _configs()
    tree = packed_model(ct, seed=seed, min_dim=MIN_DIM, bpw=bpw)
    for gate in (tree["cross_layers"]["xattn"]["gate"],
                 tree["cross_layers"]["ffn_gate"]):
        assert (np.abs(np.tanh(gate)) > 0.1).all(), gate
    return cj, ct, tree, jax_tree(tree), torch_params(tree)


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def jax_results():
    """JAX's results, each computed once and shared by the port's modes."""
    return {}


def _image(cfg, batch, seed):
    img = image_embeds(cfg, batch, seed)
    return jnp.asarray(img), torch.from_numpy(img)


# ---------------------------------------------------------------------------
# templates and the merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_full_size_template_matches_jax(dtype):
    """llama-3.2-vision-90b at full size, shapes only: the port's template
    equals JAX's leaf for leaf: 100 layers as 20 groups of 4 self blocks
    (two leading axes) and 20 cross blocks, the scalar gates one per cross
    layer, and the ranks at 1.0 bpw: wq / wo 4064, wk / wv 864 (self and
    cross), every FFN linear 6336 (past 4096: the two-call route, #4)."""
    cfg_t = dataclasses.replace(tconfigs.get_config(ARCH), dtype=dtype)
    cfg_j = dataclasses.replace(jconfigs.get_config(ARCH), dtype=dtype)
    flat_w, flat_g = flat_templates(
        jsurgery.abstract_quantized_params(cfg_j),
        tsurgery.abstract_quantized_params(cfg_t))
    assert flat_w == flat_g
    t = tsurgery.abstract_quantized_params(cfg_t)
    selfs, cross = t["self_layers"], t["cross_layers"]
    ranks = {"wq": 4064, "wk": 864, "wv": 864, "wo": 4064}
    assert {k: selfs["attn"][k]["qv"].shape for k in ranks} == \
        {k: (20, 4, 256, r) for k, r in ranks.items()}
    assert {k: cross["xattn"][k]["qv"].shape for k in ranks} == \
        {k: (20, 256, r) for k, r in ranks.items()}
    for blk, lead in ((selfs, (20, 4)), (cross, (20,))):
        assert {k: v["qv"].shape[-1] for k, v in blk["ffn"].items()} == \
            {"w_gate": 6336, "w_up": 6336, "w_down": 6336}
        assert blk["ln1"] == tsurgery.LeafSpec(lead + (8192,), dtype)
    for gate in (cross["xattn"]["gate"], cross["ffn_gate"]):
        assert gate == tsurgery.LeafSpec((20,), dtype)
    assert cross["xattn"]["k_norm"] == tsurgery.LeafSpec((20, 128), dtype)
    assert t["lm_head"]["w"] == tsurgery.LeafSpec((8192, 128256), dtype)
    assert TT.stack_lead(cfg_t) == {"self_layers": (20, 4)}


@pytest.mark.parametrize("min_dim", [16, 8])
def test_smoke_template_matches_jax(min_dim):
    """The smoke config at ``min_dim`` 16 and 8: JAX's selection rule packs
    every linear, wk / wv (64 -> 32) included."""
    cj, ct = _configs()
    w, g = flat_templates(jsurgery.abstract_quantized_params(cj, 1.0,
                                                             min_dim=min_dim),
                          tsurgery.abstract_quantized_params(ct, 1.0,
                                                             min_dim=min_dim))
    assert w == g
    t = tsurgery.abstract_quantized_params(ct, 1.0, min_dim=min_dim)
    assert t["cross_layers"]["xattn"]["wk"]["qv"].shape == (2, 2, 32)
    assert t["self_layers"]["attn"]["wq"]["qv"].shape == (2, 1, 2, 32)


def test_merge_skips_the_cross_attention_group(model):
    """The merge adds ``wqkv`` and ``wgu`` to the self blocks (two leading
    axes) and ``wgu`` to the cross blocks, and no ``wqkv`` to a cross
    block, whose wq reads the hidden state while wk / wv read the image:
    JAX's merge builds that group, which no layer reads; otherwise the two
    merges add the same leaves. A kernel-path forward (S = 3, with an
    image) launches #1 for the merged QKV, wo, merged gate-up and w_down of
    each self block, and for wq, wk, wv, wo, merged gate-up and w_down of
    each cross block."""
    cj, ct, _, jparams, tparams = model
    merged = tsurgery.merge_projection_groups(tparams)
    assert set(merged["self_layers"]["attn"]) - set(
        tparams["self_layers"]["attn"]) == {"wqkv"}
    assert merged["self_layers"]["attn"]["wqkv"]["qv"].shape[:3] == (2, 1, 3)
    assert set(merged["self_layers"]["ffn"]) - set(
        tparams["self_layers"]["ffn"]) == {"wgu"}
    assert merged["cross_layers"]["xattn"] is tparams["cross_layers"]["xattn"]
    assert set(merged["cross_layers"]["ffn"]) - set(
        tparams["cross_layers"]["ffn"]) == {"wgu"}
    jm = jsurgery.merge_projection_groups(jparams)
    assert "wqkv" in jm["cross_layers"]["xattn"]
    jm["cross_layers"]["xattn"] = dict(jm["cross_layers"]["xattn"])
    del jm["cross_layers"]["xattn"]["wqkv"]
    keys = [[jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
            for tree in (jm, merged)]
    assert keys[0] == keys[1]
    calls = []
    real = (ops.lowrank_binary_matmul, ops.lowrank_binary_matmul_merged)

    def spy(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped
    ops.lowrank_binary_matmul, ops.lowrank_binary_matmul_merged = \
        map(spy, real)
    try:
        with ops.kernel_policy(MODES["kernels"]):
            TT.forward(merged, ct, torch.zeros((1, 3), dtype=torch.long),
                       _image(ct, 1, 0)[1])
    finally:
        ops.lowrank_binary_matmul, ops.lowrank_binary_matmul_merged = real
    groups = ct.n_layers // ct.cross_attn_every
    n_self = ct.n_layers - groups
    assert len(calls) == 4 * n_self + 6 * groups
    assert calls.count("lowrank_binary_matmul_merged") == 2 * n_self + groups


# ---------------------------------------------------------------------------
# the layers and the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cross_attention_and_image_kv_match_jax(model, dt):
    """``image_kv`` (k per-head RMS-normed, v as projected) and
    ``cross_attention`` (per-head RMS-normed q, plain sdpa over all 16
    image keys, wo scaled by tanh(gate) in x's dtype) of the first cross
    layer, alone, on the plain oracles."""
    cj, ct, tree, _, _ = model
    cjd, ctd = (dataclasses.replace(c, dtype="bfloat16" if dt == "bf16"
                                    else "float32") for c in (cj, ct))
    jp = cast_jax(jax_tree(tree), jnp.bfloat16 if dt == "bf16"
                  else jnp.float32)
    tp = NanoQuantModel.from_numpy(
        tree, ctd, device="cpu",
        dtype=torch.bfloat16 if dt == "bf16" else None).params
    jx = jax.tree.map(lambda a: a[0], jp["cross_layers"]["xattn"])
    tx = TT.split_layers(tp)["cross_layers"][0]["xattn"]
    assert tx["gate"].dim() == 0
    rng = np.random.default_rng(11)
    img = pair(rng.standard_normal((2, ct.n_image_tokens, ct.d_model)
                                   ).astype(np.float32), dt)
    x = pair(rng.standard_normal((2, 5, ct.d_model)).astype(np.float32), dt)
    jkv = jax.jit(lambda p, i: JL.image_kv(p, cjd, i))(jx, img[0])
    with ops.kernel_policy(MODES["ref"]):
        tkv = TL.image_kv(tx, ctd, img[1])
        got = TL.cross_attention(tx, ctd, x[1], tkv)
    for nm, a, b in zip("kv", jkv, tkv):
        assert tuple(b.shape) == (2, ct.n_image_tokens, ct.n_kv_heads,
                                  ct.head_dim)
        assert_close(a, b, tol(dt), f"image_kv {nm} {dt}")
    want = jax.jit(lambda p, h, kv: JL.cross_attention(p, cjd, h, kv))(
        jx, x[0], jkv)
    assert got.dtype == x[1].dtype
    assert_close(want, got, tol(dt), f"cross_attention {dt}")
    assert float(got.float().abs().max()) > 0.1


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_forward_with_an_image_matches_jax(model, jax_results, mode):
    """The full-sequence forward in f32 with an image of 16 patches per
    row; without image_embeds the VLM's forward refuses, as the
    reference's asserts."""
    cj, ct, _, jparams, tparams = model
    toks = tokens(ct, (2, 11), 1)
    jimg, timg = _image(ct, 2, 3)
    if "forward" not in jax_results:
        jax_results["forward"] = jax.jit(lambda p, t, i: JT.forward(
            p, cj, t, i))(jparams, toks, jimg)
    with ops.kernel_policy(MODES[mode]):
        got = TT.forward(tparams, ct, torch.from_numpy(toks).long(), timg)
    assert_close(jax_results["forward"], got, LOGITS_TOL, f"forward {mode}")
    with pytest.raises(ValueError, match="image_embeds"):
        TT.forward(tparams, ct, torch.from_numpy(toks).long())


def test_bf16_backbone_matches_jax_block_by_block(model):
    """The bf16 model on the plain oracles, block by block: each self block
    and each cross block (its image K/V from JAX's bf16 projection) gets
    JAX's bf16 input and its output is held against JAX's at the bf16
    tolerance; then the final norm and the head. (Whole-model bf16 logits
    drift by bf16 rounding in both packages over the blocks, so the
    per-layer tolerance is applied per block, as for the hybrid.)"""
    cj, ct, tree, jparams, _ = model
    cjb, ctb = (dataclasses.replace(c, dtype="bfloat16") for c in (cj, ct))
    tp = NanoQuantModel.from_numpy(tree, ctb, device="cpu",
                                   dtype=torch.bfloat16).params
    jp = cast_jax(jparams, jnp.bfloat16)
    assert tp["cross_layers"]["xattn"]["gate"].dtype == torch.bfloat16
    toks = draw_prompts(ct, [11], seed=1)[0][None]
    img = image_embeds(ct, 1, 2)
    jimg = jnp.asarray(img, jnp.bfloat16)
    timg = torch.from_numpy(img).to(torch.bfloat16)
    x = JT.embed_tokens(jp, cjb, toks)
    pos_j, pos_t = jnp.arange(11), torch.arange(11)
    per = ct.cross_attn_every - 1
    attn = jax.jit(lambda p, h: JT._apply_attn_block(p, cjb, h, pos_j)[0])
    cross = jax.jit(lambda p, h, i: JT._apply_cross_block(
        p, cjb, h, JL.image_kv(p["xattn"], cjb, i)))
    with ops.kernel_policy(MODES["ref"]):
        for g, selfs, cp in TT._vlm_groups(tp, ctb):
            for j, tl in enumerate(selfs):
                jl = jax.tree.map(lambda a: a[g, j], jp["self_layers"])
                want = attn(jl, x)
                got = TT._apply_attn_block(tl, ctb, pair(
                    np.asarray(x, np.float32), "bf16")[1], pos_t)
                assert got.dtype == torch.bfloat16
                assert_close(want, got, tol("bf16"), f"bf16 self {g}.{j}")
                x = want
            want = cross(jax.tree.map(lambda a: a[g], jp["cross_layers"]), x,
                         jimg)
            got = TT._apply_cross_block(cp, ctb, pair(
                np.asarray(x, np.float32), "bf16")[1],
                TL.image_kv(cp["xattn"], ctb, timg))
            assert_close(want, got, tol("bf16"), f"bf16 cross {g}")
            x = want
        assert g * per + j + 1 == ct.n_layers - ct.n_layers // (per + 1)
        xt = pair(np.asarray(x, np.float32), "bf16")[1]
        want = JT.logits_fn(jp, cjb, JT.L.rms_norm(x, jp["ln_f"],
                                                   cjb.norm_eps))
        got = TT.logits_fn(tp, ctb, TT.L.rms_norm(xt, tp["ln_f"],
                                                  ctb.norm_eps))
    assert_close(want, got, tol("bf16"), "bf16 head")


@pytest.mark.parametrize("image", [True, False])
@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_rect_prefill_matches_jax(model, jax_results, image, mode):
    """A bucket-padded prefill of two prompts (13 real tokens of 16) into a
    rectangular cache of 24 rows: the logits at the last real token, the
    self layers' k / v (groups, per, B, rows, Hkv, D) and the image K/V
    (groups, B, n_img, Hkv, D): projected once from the image when one is
    given, read from the cache (zero) otherwise, as the reference's."""
    cj, ct, _, jparams, tparams = model
    toks = tokens(ct, (2, 16), 2)
    jimg, timg = _image(ct, 2, 4) if image else (None, None)
    key = ("prefill", image)
    if key not in jax_results:
        jax_results[key] = jax.jit(lambda p, t, i: JT.prefill(
            p, cj, t, JT.init_cache(cj, 2, 24), i, last_idx=12))(
                jparams, toks, jimg)
    want, jcache = jax_results[key]
    with ops.kernel_policy(MODES[mode]):
        got, tcache = TT.prefill(tparams, ct, torch.from_numpy(toks).long(),
                                 TT.init_cache(ct, 2, 24, "cpu"), last_idx=12,
                                 image_embeds=timg)
    assert_close(want, got, LOGITS_TOL, f"prefill logits {mode}")
    assert sorted(jcache) == sorted(tcache) == ["cross_kv", "self_layers"]
    for stack in tcache:
        for leaf, t in tcache[stack].items():
            assert tuple(t.shape) == tuple(jcache[stack][leaf].shape)
            assert_close(jcache[stack][leaf], t, tol("f32"),
                         f"prefill {stack}/{leaf} {mode}")
    assert bool(tcache["cross_kv"]["v"].any()) == image


@pytest.mark.parametrize("mode", ["ref", "kernels", "unfused"])
def test_paged_decode_matches_jax(model, jax_results, mode):
    """One paged decode step of three slots over the self layers' pool
    (ragged linear tables, slot 2 inactive: all-null) and the per-slot
    image K/V, from random pages and random image K/V: logits and the
    mapped pages equal JAX's ``decode_step``, and the image K/V is only
    read."""
    cj, ct, _, jparams, tparams = model
    rng = np.random.default_rng(3)
    lead = TT.stack_lead(ct)["self_layers"]
    pool = {leaf: rng.standard_normal(lead + (10, PS, ct.n_kv_heads,
                                              ct.head_dim)
                                      ).astype(np.float32)
            for leaf in ("k", "v")}
    img = {leaf: rng.standard_normal(tuple(t.shape)).astype(np.float32)
           for leaf, t in TT.image_cache(ct, 3, "cpu").items()}
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([19, 13, 2], np.int32)
    tok = tokens(ct, (3, 1), 4)
    if "decode" not in jax_results:
        jcache = {"self_layers": {k: jnp.asarray(v) for k, v in pool.items()},
                  "cross_kv": {k: jnp.asarray(v) for k, v in img.items()}}
        jax_results["decode"] = jax.jit(lambda p, t, c, q, b: JT.decode_step(
            p, cj, t, c, q, block_tables={"linear": b}))(
                jparams, tok, jcache, pos, bt)
    want, jc = jax_results["decode"]
    tc = {"self_layers": {k: torch.from_numpy(v.copy())
                          for k, v in pool.items()},
          "cross_kv": {k: torch.from_numpy(v.copy()) for k, v in img.items()}}
    params = tparams if mode == "ref" else \
        tsurgery.merge_projection_groups(tparams)
    with ops.kernel_policy(MODES[mode]):
        got, tc = TT.decode_step(params, ct, torch.from_numpy(tok).long(), tc,
                                 torch.from_numpy(pos).long(),
                                 block_tables={"linear": torch.from_numpy(bt)})
    assert_close(want[:2], got[:2], LOGITS_TOL, f"decode logits {mode}")
    for leaf in ("k", "v"):
        # page 0 is the inactive slot's trash
        assert_close(jc["self_layers"][leaf][:, :, 1:],
                     tc["self_layers"][leaf][:, :, 1:], tol("f32"),
                     f"decode pool {leaf} {mode}")
        np.testing.assert_array_equal(tc["cross_kv"][leaf].numpy(), img[leaf])


# ---------------------------------------------------------------------------
# the pool and the slot ops
# ---------------------------------------------------------------------------


def test_pool_insert_select_and_copy_match_jax(model):
    """The VLM's pool cache: the self layers' pool ``(groups, per, n_pages,
    PS, Hkv, D)`` beside the slot-indexed image K/V ``(groups, B, n_img,
    Hkv, D)``, as JAX's ``init_paged_cache`` lays it out, with JAX's
    ``kv_cache_bytes`` (image K/V included). ``paged_insert_slot`` scatters
    a prefilled rectangle's rows into the slot's pages and its image K/V
    into the slot, and leaves the other slots' image K/V alone;
    ``copy_page`` copies a page of every self layer and no image K/V;
    ``paged_select_active`` selects the image K/V by slot and passes the
    pool through."""
    cj, ct, _, jparams, tparams = model
    jpool = jpaging.init_paged_cache(cj, 3, 32, n_pages=9, page_size=PS)
    tpool = paging.init_paged_cache(ct, 9, PS, "cpu", batch=3)
    assert sorted(tpool) == sorted(jpool) == ["cross_kv", "self_layers"]
    for stack in tpool:
        for leaf, t in tpool[stack].items():
            assert tuple(t.shape) == tuple(jpool[stack][leaf].shape), leaf
    assert paging.kv_cache_bytes(tpool) == jpaging.kv_cache_bytes(jpool)
    assert paging.is_pool_leaf("self_layers", "k")
    assert not paging.is_pool_leaf("cross_kv", "k")
    with pytest.raises(ValueError, match="batch"):
        paging.init_paged_cache(ct, 9, PS, "cpu")
    rng = np.random.default_rng(7)
    for leaf, t in tpool["cross_kv"].items():
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape))))
    jpool = dict(jpool, cross_kv={k: jnp.asarray(v.numpy())
                                  for k, v in tpool["cross_kv"].items()})
    before = {k: v.clone() for k, v in tpool["cross_kv"].items()}
    toks = draw_prompts(ct, [13], seed=9)[0][None]
    jimg, timg = _image(ct, 1, 5)
    _, jsingle = jax.jit(lambda p, t, i: JT.prefill(
        p, cj, t, JT.init_cache(cj, 1, 32), i))(jparams, toks, jimg)
    _, tsingle = TT.prefill(tparams, ct, torch.from_numpy(toks).long(),
                            TT.init_cache(ct, 1, 32, "cpu"),
                            image_embeds=timg)
    ids = np.array([4, 2, 0, 0], np.int32)
    jpool = jpaging.paged_insert_slot(jpool, jsingle, 1,
                                      {"linear": jnp.asarray(ids)})
    paging.paged_insert_slot(tpool, tsingle,
                             {"linear": torch.from_numpy(ids)}, slot=1)
    for stack in tpool:
        for leaf, t in tpool[stack].items():
            # page 0: the null page takes the unmapped tail's rows
            a, b = np.asarray(jpool[stack][leaf]), t.numpy()
            if stack == "self_layers":
                a, b = a[:, :, 1:], b[:, :, 1:]
            assert_close(a, b, tol("f32"), f"insert {stack}/{leaf}")
    for leaf, t in tpool["cross_kv"].items():
        assert torch.equal(t[:, [0, 2]], before[leaf][:, [0, 2]])
        assert not torch.equal(t[:, 1], before[leaf][:, 1])
    img_before = {k: v.clone() for k, v in tpool["cross_kv"].items()}
    assert paging.copy_page(tpool, 4, 6) is tpool
    for leaf, t in tpool["self_layers"].items():
        assert torch.equal(t[:, :, 6], t[:, :, 4])
    for leaf, t in tpool["cross_kv"].items():
        assert torch.equal(t, img_before[leaf])
    new = {s: {k: v + 1 for k, v in leaves.items()}
           for s, leaves in tpool.items()}
    active = torch.tensor([False, True, False])
    want = jpaging.paged_select_active(
        jax.tree.map(lambda a: jnp.asarray(a.numpy()), new),
        jax.tree.map(lambda a: jnp.asarray(a.numpy()), tpool),
        jnp.asarray(active.numpy()))
    got = paging.paged_select_active(new, tpool, active)
    for stack in tpool:
        for leaf, t in got[stack].items():
            np.testing.assert_array_equal(np.asarray(want[stack][leaf]),
                                          t.numpy())
    assert torch.equal(got["cross_kv"]["k"][:, 0],
                       tpool["cross_kv"]["k"][:, 0])
    assert got["self_layers"]["k"] is new["self_layers"]["k"]


def test_scheduler_slot_ops_on_a_rectangular_cache_match_jax(model):
    """The scheduler's ``cache_insert_slot`` / ``cache_select_active`` on a
    rectangular VLM cache of 3 slots (the self layers' batch at axis 2,
    the image K/V's at axis 1) against JAX's."""
    _, ct, _, _, _ = model
    rng = np.random.default_rng(8)

    def draw(batch, rows):
        return {s: {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
                    for k, v in leaves.items()}
                for s, leaves in TT.init_cache(ct, batch, rows, "cpu").items()}
    pool, single, new = draw(3, 12), draw(1, 12), draw(3, 12)
    tt = {s: {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
          for s, leaves in pool.items()}
    cache_insert_slot(tt, {s: {k: torch.from_numpy(v) for k, v in l.items()}
                           for s, l in single.items()}, 1)
    want = jscheduler.cache_insert_slot(jax_tree(pool), jax_tree(single), 1)
    for s in pool:
        for k in pool[s]:
            np.testing.assert_array_equal(np.asarray(want[s][k]),
                                          tt[s][k].numpy())
    active = np.array([True, False, True])
    want = jscheduler.cache_select_active(jax_tree(new), jax_tree(pool),
                                          jnp.asarray(active))
    got = cache_select_active(
        {s: {k: torch.from_numpy(v) for k, v in l.items()}
         for s, l in new.items()},
        {s: {k: torch.from_numpy(v) for k, v in l.items()}
         for s, l in pool.items()}, torch.from_numpy(active))
    for s in pool:
        for k in pool[s]:
            np.testing.assert_array_equal(np.asarray(want[s][k]),
                                          got[s][k].numpy())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

# mid-flight admissions into reused slots (2 slots for 4 requests)
LENS, BUDGETS = [5, 9, 3, 12], [6, 8, 5, 7]
SPEC_KEYS = ("spec_cycles", "spec_draft_tokens", "spec_accepted_tokens",
             "spec_rollback_tokens", "spec_rollback_pages", "decode_steps",
             "tokens_emitted", "preemptions")


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's engine runs, each made once and shared by the port's modes."""
    return {}


def _port_engine(ct, tparams, mode, **kw):
    return InferenceEngine(tparams, ct, ServeConfig(greedy=True, debug=True,
                                                    page_size=PS, **kw),
                           max_batch=2, max_len=48, device="cpu",
                           policy=MODES[mode])


def _drained(eng):
    assert not eng.kv.ref.any() and eng.kv.used_pages == 0
    assert not eng.kv.tables["linear"].any()
    assert not eng.active.any() and not eng.scheduler.pending
    eng.check_invariants()


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax_engine(model, jax_runs, mode):
    """The engine over the pool and the per-slot image K/V: greedy tokens
    identical to JAX's engine's (neither request carries an image, so
    every cross layer reads zero image K/V in both), admission steps
    equal; no prefix index under ``prefix_cache=True`` (the default) in
    either package; the pool drained. At max_batch 2 and max_len 32 the
    engine's ``kv_cache_bytes`` equals JAX's, 65536 in f32: the pool of 3
    pages of 32 rows and the image K/V of 2 slots."""
    cj, ct, _, jparams, tparams = model
    prompts = draw_prompts(ct, LENS, seed=4)
    want, _, jsteps = jax_engine(jax_runs, cj, jparams, prompts, BUDGETS,
                                 page_size=PS)
    eng = _port_engine(ct, tparams, mode)
    assert eng.prefix is None and set(eng.kv.tables) == {"linear"}
    same_tokens(want, serve_engine(eng, Request, prompts, BUDGETS))
    assert eng.admission_step == jsteps
    _drained(eng)
    j = JEngine(jparams, cj, JServeConfig(), max_batch=2, max_len=32)
    t = InferenceEngine(tparams, ct, ServeConfig(), max_batch=2, max_len=32,
                        device="cpu")
    assert j.prefix is None and t.prefix is None
    assert t.kv_cache_bytes() == j.kv_cache_bytes() == 65536
    assert t.cache_bytes() == t.kv_cache_bytes()


@pytest.mark.parametrize("mode", list(MODES))
def test_rect_engine_matches_jax_engine(model, jax_runs, mode):
    """``ServeConfig(paged=False)``: the self layers' rectangle beside the
    per-slot image K/V, greedy tokens and admission steps equal JAX's
    engine's (its pool, whose tokens the reference holds equal to its
    rectangle's); ``kv_cache_bytes`` counts the self layers' k / v rows
    of 2 slots x 48 and the image K/V, as JAX's rectangular engine's."""
    cj, ct, _, jparams, tparams = model
    prompts = draw_prompts(ct, LENS, seed=4)
    want, _, jsteps = jax_engine(jax_runs, cj, jparams, prompts, BUDGETS,
                                 page_size=PS)
    eng = _port_engine(ct, tparams, mode, paged=False)
    assert eng.kv is None and set(eng.cache) == {"self_layers", "cross_kv"}
    same_tokens(want, serve_engine(eng, Request, prompts, BUDGETS))
    assert eng.admission_step == jsteps
    assert not any(t.any() for t in eng.cache["cross_kv"].values())
    groups = ct.n_layers // ct.cross_attn_every
    rows = (ct.n_layers - groups) * 48 + groups * ct.n_image_tokens
    assert eng.kv_cache_bytes() == eng.cache_bytes() == (
        2 * 2 * rows * ct.n_kv_heads * ct.head_dim * 4)


@pytest.fixture(scope="module")
def spec_model():
    """The smoke model packed at 6 bpw, so that its ranks truncate."""
    return _model(bpw=6.0)


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_spec_engine_matches_jax_engine(spec_model, jax_runs, mode):
    """Self-speculative decoding (half-rank draft, k pinned at 3) on the
    VLM, accepted as in the reference: the draft view truncates the self
    and cross layers, the verify (S = 4) reads the image K/V per slot.
    Tokens equal JAX's ``SpecDecodeController`` engine's and the plain
    engine's; in the unmerged layout its counters too."""
    cj, ct, _, jparams, tparams = spec_model
    kw = dict(prefix_cache=False, spec_rank_frac=0.5, spec_k=3,
              spec_k_min=3)
    prompts = draw_prompts(ct, LENS, seed=4)
    want, jstats, _ = jax_engine(jax_runs, cj, jparams, prompts, BUDGETS,
                                 page_size=PS, **kw)
    plain, _, _ = jax_engine(jax_runs, cj, jparams, prompts, BUDGETS,
                             page_size=PS, prefix_cache=False)
    same_tokens(plain, want)
    eng = _port_engine(ct, tparams, mode, **kw)
    draft = eng.spec.draft_params
    for blk, nm in ((draft["self_layers"][0]["attn"], "wq"),
                    (draft["cross_layers"][0]["xattn"], "wk")):
        assert blk[nm]["eff_rank"] < blk[nm]["qv"].shape[-1]
    same_tokens(want, serve_engine(eng, Request, prompts, BUDGETS))
    st = {k: eng.stats[k] for k in SPEC_KEYS}
    assert st["spec_cycles"] > 0 and st["spec_rollback_tokens"] > 0
    if mode == "ref":
        assert st == {k: jstats[k] for k in SPEC_KEYS}
    _drained(eng)


DRAIN_LENS = [6, 9, 4]


@pytest.fixture(scope="module")
def undisturbed(model):
    """The port's engine on the drain test's requests, undisturbed."""
    _, ct, _, _, tparams = model
    return serve_engine(_port_engine(ct, tparams, "ref"), Request,
                        draw_prompts(ct, DRAIN_LENS, seed=8), [8, 8, 8],
                        midflight=False)


@pytest.mark.parametrize("dest", ["port", "jax"])
def test_drain_snapshot_restore(model, undisturbed, tmp_path, dest):
    """``drain(timeout=0)`` preempts the live slots, releasing their pages;
    the snapshot restores into a fresh engine of either package, whose
    resume re-prefills prompt plus emitted tokens, and every request ends
    with the undisturbed engine's tokens. The port's destination starts
    with stale image K/V in every slot (a previous occupant's): each
    resume overwrites its slot's with the zero image K/V of its prefill,
    as the reference's."""
    cj, ct, _, jparams, tparams = model
    prompts = draw_prompts(ct, DRAIN_LENS, seed=8)
    eng = _port_engine(ct, tparams, "ref")
    for u, p in enumerate(prompts):
        eng.submit(Request(u, p, max_new_tokens=8))
    for _ in range(3):
        eng.step()
    before = dict(eng.drain(timeout=0))
    assert eng.stats["preemptions"] == 2 and eng.kv.used_pages == 0
    path = os.path.join(str(tmp_path), "snap.json")
    recovery.save_snapshot(eng, path)
    if dest == "port":
        dst, rec = _port_engine(ct, tparams, "kernels"), recovery
        for t in dst.cache["cross_kv"].values():
            t.fill_(5.0)
    else:
        dst = JEngine(jparams, cj, JServeConfig(greedy=True, page_size=PS),
                      max_batch=2, max_len=48)
        rec = jrecovery
    restored = rec.restore(dst, rec.load_snapshot(path))
    assert set(restored) | set(before) == {0, 1, 2}
    after = dst.run()
    for u in undisturbed:
        out = (before.get(u) or after[u]).output
        assert [int(t) for t in out] == list(undisturbed[u]), f"request {u}"
    if dest == "port":
        _drained(dst)
        assert not any(t.any() for t in dst.cache["cross_kv"].values())


# ---------------------------------------------------------------------------
# generate: the image entry point, and every served family
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_generate(model):
    """JAX's ``generate`` of 3 prompts of 7 tokens with their seeded images
    and with images of zeros, 6 new tokens."""
    cj, ct, _, jparams, _ = model
    toks = tokens(ct, (3, 7), 12)
    jimg, _ = _image(ct, 3, 13)
    out = {}
    for name, img in (("image", jimg), ("zeros", jnp.zeros_like(jimg))):
        gen, logits = jgenerate(jparams, cj, jnp.asarray(toks),
                                JServeConfig(greedy=True, max_new_tokens=6),
                                image_embeds=img)
        out[name] = (np.asarray(gen), np.asarray(logits, np.float32))
    return toks, out


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_with_an_image_matches_jax(model, jax_generate, mode):
    """The port's ``generate`` with a seeded image per prompt: one batched
    prefill projecting the image K/V once, then 6 decode steps over a pool
    of 3 slots: tokens identical to JAX's ``generate`` and its last logits
    within the tolerance; the image changes the tokens (against images of
    zeros, which give the engine's tokens: JAX's generate there too)."""
    _, ct, _, _, tparams = model
    toks, want = jax_generate
    _, timg = _image(ct, 3, 13)
    scfg = ServeConfig(greedy=True, max_new_tokens=6, page_size=4)
    for name, img in (("image", timg), ("zeros", torch.zeros_like(timg))):
        got, logits = generate(tparams, ct, toks, scfg, image_embeds=img,
                               policy=MODES[mode])
        assert got.dtype == torch.long and tuple(got.shape) == (3, 6)
        np.testing.assert_array_equal(want[name][0], got.numpy(),
                                      err_msg=name)
        assert_close(want[name][1], logits, LOGITS_TOL, f"logits {name}")
    assert (want["image"][0] != want["zeros"][0]).any()


# every family the port serves, at its smoke config: (arch, min_dim)
FAMILIES = {"llama3.2-1b": 16, "qwen1.5-0.5b": 16, "qwen3-4b": 16,
            "qwen3-moe-235b-a22b": 16, "deepseek-v2-lite-16b": 8,
            "mamba2-370m": 16, "zamba2-1.2b": 8, ARCH: 16,
            "musicgen-medium": 16}


def test_generate_covers_every_served_family():
    """The families of :data:`FAMILIES` are all the port serves."""
    assert {tconfigs.get_smoke(a).family for a in FAMILIES} == \
        {"dense", "moe", "ssm", "hybrid", "vlm", "audio"}
    assert set(FAMILIES) >= set(tconfigs.list_archs()) - {"qwen1.5-110b"}


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_generate_matches_jax_per_family(arch):
    """``generate`` of each served family's smoke config (f32, packed at
    1.0 bpw from a seed), 2 prompts of 6 tokens and 4 new tokens on the
    kernel wrappers' dispatch, against JAX's ``generate``: tokens
    identical, last logits within the tolerance. The port decodes over a
    pool of 2 slots (linear tables; the hybrid's rings), the SSM family on
    its state cache; the VLM's prompts carry images, the audio family's
    are frames of 4 codebook ids (2, 6, 4). With ``paged=False`` it
    decodes on the prefilled rectangle, as JAX's does: the same tokens."""
    cj = f32(jconfigs.get_smoke(arch))
    ct = f32(tconfigs.get_smoke(arch))
    tree = packed_model(ct, seed=1, min_dim=FAMILIES[arch])
    toks = tokens(ct, (2, 6) + ((ct.n_codebooks,) if ct.family == "audio"
                                else ()), 3)
    jimg = timg = None
    if ct.family == "vlm":
        jimg, timg = _image(ct, 2, 4)
    want, wl = jgenerate(jax_tree(tree), cj, jnp.asarray(toks),
                         JServeConfig(greedy=True, max_new_tokens=4),
                         image_embeds=jimg)
    for paged in (True, False):
        got, gl = generate(torch_params(tree), ct, toks,
                           ServeConfig(greedy=True, max_new_tokens=4,
                                       page_size=4, paged=paged),
                           image_embeds=timg, policy=MODES["kernels"])
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        assert_close(wl, gl, LOGITS_TOL, f"{arch} last logits {paged}")


# ---------------------------------------------------------------------------
# artifacts, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifacts_cross_the_packages(tmp_path, dtype):
    """A JAX-saved VLM artifact (the two-axis self stack and the scalar
    gates among the leaves) loads leaf for leaf in the port, and the
    port's ``save`` of it loads leaf for leaf in JAX."""
    cj, ct = (dataclasses.replace(c, dtype=dtype) for c in _configs())
    tree = packed_model(ct, seed=5, min_dim=MIN_DIM)
    jparams = jax_tree(tree)
    if dtype == "bfloat16":
        jparams = cast_jax(jparams, jnp.bfloat16)
    qcfg = japi.QuantConfig(target_bpw=1.0, min_dim=MIN_DIM)
    japi.NanoQuantModel(jparams, cj, qcfg, {"ranks": {}}).save(
        str(tmp_path / "jax"))
    m = NanoQuantModel.load(str(tmp_path / "jax"), device="cpu")
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(cj)
    leaves_equal(jparams, m.params)
    want = torch.float32 if dtype == "float32" else torch.bfloat16
    cross = m.params["cross_layers"]
    assert cross["xattn"]["gate"].dtype == cross["ffn_gate"].dtype == want
    assert tuple(cross["ffn_gate"].shape) == (2,)
    assert m.params["self_layers"]["attn"]["wq"]["qv"].dim() == 4
    m.save(str(tmp_path / "port"))
    back = japi.NanoQuantModel.load(str(tmp_path / "port"))
    leaves_equal(jparams, back.params)


def test_serve_cli_serves_vision():
    """``python -m repro_torch.launch.serve --arch llama-3.2-vision-90b``
    quantizes the smoke teacher on the CPU (the demo, in the config's
    bf16) and serves it over the pool beside the per-slot image K/V (2
    groups x 16 patches x 2 kv heads x 16 x 2 leaves x 2 bytes = 4096
    bytes per slot)."""
    # the CLI quantizes its demo teacher first: one thread, as the
    # test workers share the cores
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--requests", "3", "--prompt-len", "6",
         "--max-new", "4", "--max-batch", "2", "--page-size", "4"],
        capture_output=True, text=True, env=env, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "llama-vision-smoke (bfloat16) teacher from seed 0" in out.stdout
    assert "[serve] quantized random-init teacher (demo)" in out.stdout
    assert "image K/V of 2 slots beside it (4096 bytes per slot)" in \
        out.stdout
    assert "3 requests, 12 tokens" in out.stdout
