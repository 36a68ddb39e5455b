"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048 per codebook
[arXiv:2306.05284; hf]. The EnCodec frontend is a stub: the backbone
consumes precomputed 4-codebook token streams (tokens of shape (B, S,
4), one frame per position); the embedding sums one table per codebook
and the head predicts all 4 codebooks of the next frame in parallel. The
block is the JAX package's llama-style one (RoPE, SwiGLU, no delay
pattern), kept here.
"""
from repro_torch.api.archs import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    n_codebooks=4,
    head_dim=64,
    rope_theta=10000.0,
)

SMOKE = scaled_down(
    CONFIG, name="musicgen-medium-smoke", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128, head_dim=16,
    loss_chunk=0, remat=False)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@register_arch("musicgen-medium")
def _arch() -> ArchSpec:
    return ArchSpec("musicgen-medium", CONFIG, SMOKE, tuple(SHAPES))
