"""The trainer (the FP teacher's train step, checkpointed host loop and
gradient compression) and its optimizer substrate, the port of
``repro.train``."""
from repro_torch.train.loop import (  # noqa: F401
    TrainConfig, Trainer, init_train_state, make_optimizer, make_train_step)
from repro_torch.train.optim import AdamW, cosine_schedule  # noqa: F401
