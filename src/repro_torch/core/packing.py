"""Bit packing of ±1 factors (paper Fig. 2c): -1 -> 0, +1 -> 1, 32 values
per 32-bit word, kept as int32 in the port. Re-exports the kernel-layer
implementation so the convention is defined in exactly one place."""
from repro_torch.kernels.ref import pack_signs, unpack_signs  # noqa: F401
