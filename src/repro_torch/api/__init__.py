"""The port's public surface: the NanoQuant model artifact."""
from repro_torch.api.model import NanoQuantModel  # noqa: F401
