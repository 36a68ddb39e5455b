"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256, gated cross-attention image layers every 5th
layer [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

The vision frontend is a stub, as in the JAX package: the model takes
precomputed patch embeddings (B, n_image_tokens, d_model), and every
cross-attention layer projects them to its own image K/V.
"""
from repro_torch.api.archs import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    cross_attn_every=5,
    n_image_tokens=1024,
)

SMOKE = scaled_down(
    CONFIG, name="llama-vision-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    cross_attn_every=2, n_image_tokens=16, loss_chunk=0, remat=False)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@register_arch("llama-3.2-vision-90b")
def _arch() -> ArchSpec:
    return ArchSpec("llama-3.2-vision-90b", CONFIG, SMOKE, tuple(SHAPES))
