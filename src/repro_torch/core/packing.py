"""Bit packing of ±1 factors (paper Fig. 2c): -1 -> 0, +1 -> 1, 32 values
per 32-bit word, kept as int32 in the port. Re-exports the kernel-layer
implementation so the convention is defined in exactly one place; the
port of ``repro.core.packing``."""
import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import pack_signs, unpack_signs  # noqa: F401


def _signs(lat):
    return torch.sign(torch.where(lat == 0, torch.ones_like(lat), lat))


def pack_quantized(lat_u, lat_v, s1, s2, dtype=torch.float32,
                   k_align: int = 32):
    """Finalize a quantized linear: latents -> the packed dict ``dense``
    reads (weights layout (d_in, d_out), so U (d_out, r) is stored
    transposed as packed Uᵀ).

    k_align: pad the packed d_in (reduction) dim up to this multiple at
    pack time; the padded rows pack to 0-bits and their s2 entries are 0,
    so they contribute nothing. 32 (the packing word) pads nothing.
    Stacked experts (a leading expert axis on all four) pack each expert
    alike (the JAX package's ``vmap``)."""
    u = _signs(lat_u)                                  # (d_out, r)
    v = _signs(lat_v)                                  # (d_in, r)
    k_align = max(32, k_align)
    d_in = v.shape[-2]
    kp = -(-d_in // k_align) * k_align
    s2 = s2.to(dtype)
    if kp != d_in:
        v = F.pad(v, (0, 0, 0, kp - d_in))
        s2 = F.pad(s2, (0, kp - d_in))
    return {
        "qu_t": pack_signs(u.mT),                       # (r//32, d_out)
        "qv": pack_signs(v),                           # (kp//32, r)
        "s1": s1.to(dtype),
        "s2": s2,
    }


def packed_nbytes(q) -> int:
    """Storage bytes of a packed linear (scales counted as fp16)."""
    return int(q["qu_t"].numel() * 4 + q["qv"].numel() * 4
               + (q["s1"].numel() + q["s2"].numel()) * 2)
