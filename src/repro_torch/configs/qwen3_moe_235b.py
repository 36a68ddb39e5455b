"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936, MoE 128 experts top-8, qk_norm
[hf:Qwen/Qwen3-30B-A3B family scaling; hf]."""
from repro_torch.api.archs import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    moe_d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    n_experts=128,
    n_experts_per_tok=8,
    rope_theta=1000000.0,
)

SMOKE = scaled_down(
    CONFIG, name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, moe_d_ff=96, vocab_size=256, head_dim=16,
    n_experts=8, n_experts_per_tok=2, loss_chunk=0, remat=False)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@register_arch("qwen3-moe-235b-a22b")
def _arch() -> ArchSpec:
    return ArchSpec("qwen3-moe-235b-a22b", CONFIG, SMOKE, tuple(SHAPES))
