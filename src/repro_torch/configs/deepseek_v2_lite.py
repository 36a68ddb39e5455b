"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H, MLA kv_lora=512,
expert d_ff=1408, vocab=102400, MoE 64 routed top-6 + 2 shared experts,
first layer dense (d_ff=10944) [arXiv:2405.04434; hf]."""
from repro_torch.api.archs import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    dense_d_ff=10944,
    first_k_dense=1,
    vocab_size=102400,
    n_experts=64,
    n_experts_per_tok=6,
    n_shared_experts=2,
    # MLA
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
)

SMOKE = scaled_down(
    CONFIG, name="deepseek-v2-lite-smoke", n_layers=3, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=96, moe_d_ff=96, dense_d_ff=160,
    first_k_dense=1, vocab_size=256, n_experts=8, n_experts_per_tok=2,
    n_shared_experts=1, kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16,
    v_head_dim=16, loss_chunk=0, remat=False)

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@register_arch("deepseek-v2-lite-16b")
def _arch() -> ArchSpec:
    return ArchSpec("deepseek-v2-lite-16b", CONFIG, SMOKE, tuple(SHAPES))
