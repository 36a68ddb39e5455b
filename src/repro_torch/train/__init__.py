"""Optimizer substrate of the quantization pipeline (the trainer loop is
not ported yet)."""
from repro_torch.train.optim import AdamW, cosine_schedule  # noqa: F401
