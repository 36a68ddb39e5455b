"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.api.archs import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
)

SMOKE = scaled_down(
    CONFIG, name="qwen3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    loss_chunk=0, remat=False)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@register_arch("qwen3-4b")
def _arch() -> ArchSpec:
    return ArchSpec("qwen3-4b", CONFIG, SMOKE, tuple(SHAPES))
