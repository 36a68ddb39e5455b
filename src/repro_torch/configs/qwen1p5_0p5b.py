"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936, QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.api.archs import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
)

SMOKE = scaled_down(
    CONFIG, name="qwen1.5-0.5b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
    loss_chunk=0, remat=False)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@register_arch("qwen1.5-0.5b")
def _arch() -> ArchSpec:
    return ArchSpec("qwen1.5-0.5b", CONFIG, SMOKE, tuple(SHAPES))
