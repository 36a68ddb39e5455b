"""Param-tree layout: which linears NanoQuant packs. The port's copy of
``repro.core.layout``, so that the port's templates select exactly the
linears the JAX package's quantizer packs."""
from __future__ import annotations

# param-tree keys holding transformer blocks (per family)
BLOCK_STACKS = ("layers", "dense_layers", "self_layers", "cross_layers",
                "shared_attn")

# router: FP by design (paper; <0.01% of params). w_uk/w_uv: the MLA
# absorbed-decode path contracts these into the latent cache space, so
# they stay FP.
EXCLUDE_LINEARS = frozenset({"router", "w_uk", "w_uv"})

# sign bits are packed 32 per 32-bit word along d_in, so only
# d_in % 32 == 0 linears are packable
PACK_ALIGN = 32


def quantizable_linear(name: str, w_shape, min_dim: int) -> bool:
    """Selection rule for one linear leaf ``{"w": w_shape}`` named
    ``name``: not excluded, 2D (or stacked-expert 3D), both matmul dims
    >= ``min_dim``, and a packable d_in."""
    return (name not in EXCLUDE_LINEARS
            and len(w_shape) >= 2
            and min(w_shape[-2:]) >= min_dim
            and w_shape[-2] % PACK_ALIGN == 0)
