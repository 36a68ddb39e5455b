"""mamba2-370m [ssm] — 48L d_model=1024, attn-free, vocab=50280,
ssm_state=128, SSD state-space duality [arXiv:2405.21060; unverified]."""
from repro_torch.api.archs import ArchSpec, register_arch
from repro_torch.models.config import ModelConfig, scaled_down

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = scaled_down(
    CONFIG, name="mamba2-370m-smoke", n_layers=3, d_model=64,
    vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
    loss_chunk=0, remat=False)

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


@register_arch("mamba2-370m")
def _arch() -> ArchSpec:
    return ArchSpec("mamba2-370m", CONFIG, SMOKE, tuple(SHAPES))
