"""Dense-family model assembly: forward / prefill / decode, the port of
the dense paths of ``repro.models.transformer``.

The layer stack keeps the JAX package's stacked layout (every leaf of
``params["layers"]`` has a leading ``n_layers`` axis); a Python loop
takes the place of ``lax.scan`` and reads one layer's views per step.
``params["layers"]`` may also be given pre-split as a list of per-layer
dicts (:func:`split_layers`), which saves the slicing on every call.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port serves the dense family, not {cfg.family!r}")


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def split_layers(params) -> Dict:
    """Same params with the layer stack as a list of per-layer views."""
    stack = params["layers"]
    if isinstance(stack, list):
        return params
    n = stack["ln1"].shape[0]
    return {**params, "layers": [_index(stack, i) for i in range(n)]}


def _layers(params) -> List[Dict]:
    return split_layers(params)["layers"]


def _apply_attn_block(p, cfg, x, positions, cache=None, cache_pos=None,
                      block_table=None):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = L.attention(p["attn"], cfg, h, positions, cache, cache_pos,
                       block_table)
    x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.ffn(p["ffn"], h)


def embed_tokens(params, cfg, tokens):
    return params["embed"][tokens]


def backbone(params, cfg: ModelConfig, tokens):
    """Full-sequence forward to final hidden states (B, S, d)."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in _layers(params):
        x = _apply_attn_block(lp, cfg, x, positions)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps)


def logits_fn(params, cfg, hidden):
    """The lm head stays a plain matmul (tied to the embedding or not)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    return hidden @ w.to(hidden.dtype)


def forward(params, cfg, tokens):
    return logits_fn(params, cfg, backbone(params, cfg, tokens))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Rectangular KV cache {"layers": {"k", "v": (L, B, max_len, Hkv,
    D)}} in the model dtype."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg)
    return {"layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}


def _cached_forward(params, cfg, tokens, cache, pos, block_tables=None):
    """Prefill (rectangular cache, pos 0) or paged decode (per-slot (B,)
    pos and ``block_tables={"linear": (B, pages)}``). Writes the cache
    in place; returns (hidden, cache)."""
    _check_family(cfg)
    x = embed_tokens(params, cfg, tokens)
    S = x.shape[1]
    steps = torch.arange(S, device=x.device)
    if isinstance(pos, torch.Tensor) and pos.dim():
        positions = pos.long()[:, None] + steps[None, :]          # (B, S)
    else:
        positions = int(pos) + steps                              # (S,)
    bt = block_tables.get("linear") if block_tables else None
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(_layers(params)):
        x = _apply_attn_block(lp, cfg, x, positions,
                              {"k": ck[i], "v": cv[i]}, pos, bt)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps), cache


def prefill(params, cfg, tokens, cache, last_idx: Optional[int] = None):
    """Process the prompt into a rectangular cache; returns (last-token
    logits, cache). `last_idx`: the final real prompt token when
    `tokens` is right-padded to a bucket (causality makes its logits
    and the cache rows up to it identical to an unpadded prefill)."""
    h, cache = _cached_forward(params, cfg, tokens, cache, 0)
    h = h[:, -1:] if last_idx is None else h[:, last_idx:last_idx + 1]
    return logits_fn(params, cfg, h), cache


def decode_step(params, cfg, token, cache, pos, block_tables=None):
    """One decode step over a paged pool: token (B, S) (S == 1 normally),
    pos (B,) per-slot positions, block_tables {"linear": (B, pages)}.
    Returns (logits (B, S, V), cache)."""
    if not block_tables:
        raise NotImplementedError("decode runs over the paged pool: pass "
                                  "block_tables")
    h, cache = _cached_forward(params, cfg, token, cache, pos,
                               block_tables=block_tables)
    return logits_fn(params, cfg, h), cache
