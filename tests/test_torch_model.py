"""Parity of the port's model, surgery, configs and artifact loader with
the JAX reference, plus the port's import and device hygiene. The dense
model runs on llama3.2-1b's smoke config and, for qwen3's per-head
``qk_norm`` (which also rules out the decode megakernel), on qwen3-4b's.

Logit comparisons are f32 with a relative max-abs tolerance of 1e-4:
the two packages run the same math, but their sums (matmuls, RMSNorm,
softmax) accumulate in different orders, and the differences compound
over the layers and the vocabulary-wide lm head — far above one kernel's
1e-5 and far below a changed result."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (assert_close, check_forward, check_paged_decode,
                           check_prefill, f32, flat_templates, jax_tree,
                           packed_model, pair, torch_params)
from repro import api as japi
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.quant import surgery as jsurgery
from repro_torch import configs as tconfigs
from repro_torch.api import NanoQuantModel
from repro_torch.kernels.ops import KernelPolicy, kernel_policy
from repro_torch.models import transformer as TT
from repro_torch.quant import surgery as tsurgery

LOGITS_TOL = 1e-4
MODES = {"ref": KernelPolicy(mode="ref"),
         "kernels": KernelPolicy(mode="cuda"),
         "kernels-no-mega": KernelPolicy(mode="cuda", megakernel=False)}


@pytest.fixture(scope="module")
def model():
    cfg = f32(jconfigs.get_smoke("llama3.2-1b"))
    tree = packed_model(cfg, seed=0)
    return cfg, tree, jax_tree(tree), torch_params(tree)


def _tparams(tparams, mode):
    if MODES[mode].use_merged_projections("cpu"):
        return tsurgery.merge_projection_groups(tparams)
    return tparams


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_forward_matches_jax(model, mode):
    cfg, _, jparams, tparams = model
    toks = _tokens(cfg, (2, 11), 1)
    want = jax.jit(lambda p, t: JT.forward(p, cfg, t))(jparams, toks)
    with kernel_policy(MODES[mode]):
        got = TT.forward(_tparams(tparams, mode), cfg,
                         torch.from_numpy(toks).long())
    assert_close(want, got, LOGITS_TOL, f"forward ({mode})")


def test_prefill_matches_jax(model):
    cfg, _, jparams, tparams = model
    toks = _tokens(cfg, (1, 16), 2)
    n = 13                                  # right-padded to a bucket
    want, jcache = jax.jit(lambda p, t: JT.prefill(
        p, cfg, t, JT.init_cache(cfg, 1, 24), last_idx=n - 1))(jparams, toks)
    got, tcache = TT.prefill(tparams, cfg, torch.from_numpy(toks).long(),
                             TT.init_cache(cfg, 1, 24, "cpu"), last_idx=n - 1)
    assert_close(want, got, LOGITS_TOL, "prefill logits")
    for leaf in ("k", "v"):
        assert_close(jcache["layers"][leaf], tcache["layers"][leaf],
                     LOGITS_TOL, f"prefill cache {leaf}")


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_decode_step_matches_jax(model, mode):
    """One batched decode step over a paged pool with ragged tables and
    an inactive (all-null) slot, in every dispatch structure."""
    cfg, _, jparams, tparams = model
    rng = np.random.default_rng(3)
    L, PS, hkv, hd = cfg.n_layers, 4, cfg.n_kv_heads, cfg.head_dim
    pool = rng.standard_normal((2, L, 10, PS, hkv, hd)).astype(np.float32)
    bt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([9, 5, 2], np.int32)
    tok = _tokens(cfg, (3, 1), 4)

    def cache(lib):
        conv = jnp.asarray if lib == "jax" else torch.from_numpy
        return {"layers": {"k": conv(pool[0].copy()),
                           "v": conv(pool[1].copy())}}

    want, jc = jax.jit(lambda p, t, c, q, b: JT.decode_step(
        p, cfg, t, c, q, block_tables={"linear": b}))(
            jparams, tok, cache("jax"), pos, bt)
    with kernel_policy(MODES[mode]):
        got, tc = TT.decode_step(
            _tparams(tparams, mode), cfg, torch.from_numpy(tok).long(),
            cache("torch"), torch.from_numpy(pos).long(),
            block_tables={"linear": torch.from_numpy(bt)})
    assert_close(want, got, LOGITS_TOL, f"decode logits ({mode})")
    for leaf in ("k", "v"):
        # the inactive slot's write lands on the null page 0, whose
        # content is trash by design: compare the real pages only
        assert_close(jc["layers"][leaf][:, 1:], tc["layers"][leaf][:, 1:],
                     LOGITS_TOL, f"decode pool {leaf} ({mode})")


def test_merged_groups_match_jax(model):
    _, _, jparams, tparams = model
    jm = jsurgery.merge_projection_groups(jparams)["layers"]
    tm = tsurgery.merge_projection_groups(tparams)["layers"]
    for blk, key in (("attn", "wqkv"), ("ffn", "wgu")):
        for leaf, a in jm[blk][key].items():
            b = tm[blk][key][leaf]
            assert tuple(a.shape) == tuple(b.shape), (key, leaf)
            a = np.asarray(a)
            np.testing.assert_array_equal(
                a.view(np.int32) if a.dtype == np.uint32 else a, b.numpy())


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_configs_and_templates_match_jax(arch):
    assert dataclasses.asdict(tconfigs.get_config(arch)) == \
        dataclasses.asdict(jconfigs.get_config(arch))
    cfg_j = jconfigs.get_smoke(arch)
    assert dataclasses.asdict(tconfigs.get_smoke(arch)) == \
        dataclasses.asdict(cfg_j)
    want = jsurgery.abstract_quantized_params(cfg_j, 1.0, min_dim=16)
    got = tsurgery.abstract_quantized_params(tconfigs.get_smoke(arch), 1.0,
                                             min_dim=16)
    flat_w, flat_g = flat_templates(want, got)
    assert flat_w == flat_g


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_full_size_moe_template_matches_jax(dtype):
    """qwen3-moe-235b-a22b at full size, shapes only (no weights): the
    port's template equals JAX's leaf for leaf. Its routers (4096, 128)
    are wide enough to pack by shape, but the selection rule excludes
    them by name: they stay FP32 in a bf16 model."""
    arch = "qwen3-moe-235b-a22b"
    cfg_t = dataclasses.replace(tconfigs.get_config(arch), dtype=dtype)
    cfg_j = dataclasses.replace(jconfigs.get_config(arch), dtype=dtype)
    flat_w, flat_g = flat_templates(
        jsurgery.abstract_quantized_params(cfg_j),
        tsurgery.abstract_quantized_params(cfg_t))
    assert flat_w == flat_g
    t = tsurgery.abstract_quantized_params(cfg_t)["layers"]
    assert t["moe"]["router"] == {
        "w": tsurgery.LeafSpec((94, 4096, 128), "float32")}
    ranks = {k: t[blk][k]["qv"].shape[-1]
             for blk, ks in (("attn", ("wq", "wk", "wv", "wo")),
                             ("moe", ("w_gate", "w_up", "w_down")))
             for k in ks}
    assert ranks == {"wq": 2688, "wo": 2688, "wk": 416, "wv": 416,
                     "w_gate": 1088, "w_up": 1088, "w_down": 1088}
    assert t["moe"]["w_gate"]["qv"].shape == (94, 128, 128, 1088)
    assert t["moe"]["w_down"]["qu_t"].shape == (94, 128, 34, 4096)
    assert "dense_layers" not in tsurgery.abstract_quantized_params(cfg_t)


# ---------------------------------------------------------------------------
# qwen3's per-head qk_norm (qwen3-4b smoke config)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen3():
    cfg = f32(jconfigs.get_smoke("qwen3-4b"))
    assert cfg.qk_norm
    tree = packed_model(cfg, seed=1)
    return cfg, tree, jax_tree(tree), torch_params(tree)


@pytest.mark.parametrize("mode", ["ref", "kernels"])
def test_qwen3_forward_matches_jax(qwen3, mode):
    cfg, _, jparams, tparams = qwen3
    check_forward(cfg, jparams, _tparams(tparams, mode), MODES[mode],
                  LOGITS_TOL, f"qwen3-4b {mode}")


def test_qwen3_prefill_matches_jax(qwen3):
    cfg, _, jparams, tparams = qwen3
    check_prefill(cfg, jparams, tparams, MODES["ref"], LOGITS_TOL,
                  "qwen3-4b")


@pytest.mark.parametrize("mode", list(MODES))
def test_qwen3_paged_decode_step_matches_jax(qwen3, mode, monkeypatch):
    """qk_norm's decode: the megakernel's gate refuses it (the kernel has
    no per-head norm), so every kernel mode runs the unfused chain."""
    from repro_torch.kernels import megakernel
    cfg, _, jparams, tparams = qwen3
    calls = []
    real = megakernel.decode_step_megakernel_raw
    monkeypatch.setattr(megakernel, "decode_step_megakernel_raw",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    check_paged_decode(cfg, jparams, _tparams(tparams, mode), MODES[mode],
                       LOGITS_TOL, f"qwen3-4b {mode}")
    assert not calls


def test_full_size_ranks_match_issue_shapes():
    t = tsurgery.abstract_quantized_params(tconfigs.get_config("llama3.2-1b"))
    ranks = {k: t["layers"][blk][k]["qv"].shape[-1]
             for blk, ks in (("attn", ("wq", "wk", "wv", "wo")),
                             ("ffn", ("w_gate", "w_up", "w_down")))
             for k in ks}
    assert ranks == {"wq": 992, "wo": 992, "wk": 384, "wv": 384,
                     "w_gate": 1600, "w_up": 1600, "w_down": 1600}


# ---------------------------------------------------------------------------
# artifacts written by the JAX package
# ---------------------------------------------------------------------------


def _save_artifact(path, cfg, tree, dtype):
    jparams = jax_tree(tree)
    if dtype == "bfloat16":
        jparams = jax.tree_util.tree_map_with_path(
            lambda kp, a: a.astype(jnp.bfloat16)
            if a.dtype == jnp.float32 and not _in_packed(kp) else a, jparams)
    qcfg = japi.QuantConfig(target_bpw=1.0, min_dim=16)
    japi.NanoQuantModel(jparams, cfg, qcfg, {"ranks": {}}).save(str(path))
    return jparams


def _in_packed(kp):
    names = [getattr(k, "key", None) for k in kp]
    return names[-1] in ("qv", "qu_t", "s1", "s2")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifact_restores_leaf_for_leaf(tmp_path, dtype):
    cfg = dataclasses.replace(jconfigs.get_smoke("llama3.2-1b"), dtype=dtype)
    tree = packed_model(cfg, seed=5)
    jparams = _save_artifact(tmp_path, cfg, tree, dtype)
    m = NanoQuantModel.load(str(tmp_path), device="cpu")
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(cfg)
    assert m.quant["min_dim"] == 16
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = jax.tree_util.tree_flatten_with_path(m.params)[0]
    assert [jax.tree_util.keystr(k) for k, _ in want] == \
        [jax.tree_util.keystr(k) for k, _ in got]
    for (kp, a), (_, b) in zip(want, got):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(a.view(np.int32), b.numpy())
        elif a.dtype.name == "bfloat16":
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(np.int16),
                                          b.view(torch.int16).numpy())
        else:
            assert str(b.dtype) == f"torch.{a.dtype.name}", kp
            np.testing.assert_array_equal(a, b.numpy())


def test_v1_manifest_loads_with_unaligned_packing(tmp_path):
    """A v1 manifest has no pack_k_align: it loads as the old layout
    (K aligned to the 32-bit word)."""
    import json
    cfg = f32(jconfigs.get_smoke("llama3.2-1b"))
    _save_artifact(tmp_path, cfg, packed_model(cfg, seed=7), "float32")
    path = os.path.join(tmp_path, "nanoquant.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["version"] = 1
    del manifest["quant_config"]["pack_k_align"]
    with open(path, "w") as f:
        json.dump(manifest, f)
    m = NanoQuantModel.load(str(tmp_path), device="cpu")
    assert m.params["layers"]["attn"]["wq"]["qv"].shape[1] * 32 == cfg.d_model
    manifest["version"] = 3
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="newer"):
        NanoQuantModel.load(str(tmp_path), device="cpu")


def test_corrupt_artifact_names_the_leaf(tmp_path):
    cfg = f32(jconfigs.get_smoke("llama3.2-1b"))
    _save_artifact(tmp_path, cfg, packed_model(cfg, seed=6), "float32")
    step = os.path.join(tmp_path, "step_00000000")
    shard = os.path.join(step, "arrays-0.npz")
    with np.load(shard) as z:
        arrays = {n: z[n].copy() for n in z.files}
    arrays["leaf_000003"].view(np.uint8).reshape(-1)[5] ^= 0x10
    np.savez(shard, **arrays)
    with pytest.raises(ValueError, match=r"corrupt/truncated artifact.*"
                       r"leaf 3 \(layers/attn/wk/s1\) checksum mismatch"):
        NanoQuantModel.load(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port imports torch only: no jax*, no repro.*."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules if n == "jax"
                     or n.startswith(("jax.", "jaxlib"))
                     or n == "repro" or n.startswith("repro."))
        assert not bad, bad
        print(len([n for n in sys.modules if n.startswith("repro_torch")]))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


def test_default_device_is_the_card(model, tmp_path):
    """Entry points default to device='cuda' and raise without a card —
    nothing falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg, tree, _, tparams = model
    from repro_torch.serve.engine import InferenceEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tparams, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NanoQuantModel.from_numpy(tree, cfg)
    _save_artifact(tmp_path, cfg, tree, "float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NanoQuantModel.load(str(tmp_path))
