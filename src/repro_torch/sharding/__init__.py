"""Partition-spec rules for every parallelism axis (DP / FSDP / TP / EP)
and the collectives of tensor-parallel serving — the port of
``repro.sharding``. See :mod:`repro_torch.sharding.rules` for the mesh
contract and the Megatron col/row pairing of packed linears, and
:mod:`repro_torch.sharding.comm` for the collectives.
"""
from repro_torch.sharding.rules import (  # noqa: F401
    DEFAULT, SERVE, ShardingPolicy, batch_pspecs, cache_pspecs, data_axes,
    local_shape, local_shard, param_pspecs, replicate_specs, tp_role)

__all__ = [
    "ShardingPolicy", "DEFAULT", "SERVE",
    "param_pspecs", "batch_pspecs", "cache_pspecs", "replicate_specs",
    "data_axes", "tp_role", "local_shard", "local_shape",
]
