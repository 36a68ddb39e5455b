"""zamba2-1.2b [hybrid] — Mamba2 backbone + one *shared* attention block.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]. The shared attention+FFN block is applied every
``attn_every`` SSM layers (weights shared across applications, zamba2
style). The shared block has a 4096 sliding window so the arch stays
sub-quadratic at long context (the JAX package's adaptation, kept here).
"""
from repro_torch.api.archs import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,
    sliding_window=4096,
)

SMOKE = scaled_down(
    CONFIG, name="zamba2-1.2b-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16, ssm_state=16,
    ssm_head_dim=16, ssm_chunk=16, attn_every=2, sliding_window=64,
    loss_chunk=0, remat=False)

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


@register_arch("zamba2-1.2b")
def _arch() -> ArchSpec:
    return ArchSpec("zamba2-1.2b", CONFIG, SMOKE, tuple(SHAPES))
