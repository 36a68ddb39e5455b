"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias [hf:Qwen/Qwen1.5-0.5B family scaling; hf]."""
from repro_torch.api.archs import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = scaled_down(
    CONFIG, name="qwen1.5-110b-smoke", n_layers=2, d_model=64, n_heads=8,
    n_kv_heads=1, d_ff=192, vocab_size=256, head_dim=8,
    loss_chunk=0, remat=False)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@register_arch("qwen1.5-110b")
def _arch() -> ArchSpec:
    return ArchSpec("qwen1.5-110b", CONFIG, SMOKE, tuple(SHAPES))
