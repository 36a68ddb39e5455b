"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.api.archs import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=64,
    rope_theta=500000.0,
    tie_embeddings=True,
)

SMOKE = scaled_down(
    CONFIG, name="llama3.2-1b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    loss_chunk=0, remat=False)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@register_arch("llama3.2-1b")
def _arch() -> ArchSpec:
    return ArchSpec("llama3.2-1b", CONFIG, SMOKE, tuple(SHAPES))
