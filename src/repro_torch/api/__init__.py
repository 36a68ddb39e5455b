"""``repro_torch.api``: the port's public surface, re-exporting the names
of ``repro.api`` that the port has from the layers that implement them.

    from repro_torch import api

    cfg   = api.get_smoke("llama3.2-1b")
    model = api.NanoQuantModel.quantize(params, cfg, calib,
                                        api.QuantConfig(target_bpw=1.0))
    model.save("/ckpt/nq")
    model = api.NanoQuantModel.load("/ckpt/nq")

Of the reference's names the port lacks only its kernel tuning tables
(``load_block_table``, ``load_paged_table``): the port's launch planners
size every grid from the occupancy query and read no table.
"""
from repro_torch.api.archs import (  # noqa: F401
    ARCHS, ArchSpec, get_arch, get_config, get_smoke, list_archs,
    register_arch, shapes_for)
from repro_torch.api.init_methods import (  # noqa: F401
    INIT_METHODS, get_init_method, list_init_methods, register_init_method)
from repro_torch.api.model import (  # noqa: F401
    MANIFEST_NAME, MANIFEST_VERSION, NanoQuantModel)
from repro_torch.api.registry import Registry, UnknownNameError  # noqa: F401
from repro_torch.checkpoint.journal import (  # noqa: F401
    JournalError, QuantJournal)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.core.admm import QuantizationError  # noqa: F401
from repro_torch.core.pipeline import (  # noqa: F401
    QuantConfig, nanoquant_quantize, tune_scales_kd)
from repro_torch.kernels.ops import (  # noqa: F401
    KernelPolicy, current_kernel_policy, kernel_policy,
    lowrank_binary_matmul, lowrank_binary_matmul_expert,
    lowrank_binary_matmul_merged, set_kernel_policy)
from repro_torch.quant.faults import (  # noqa: F401
    InjectedPipelineCrash, QuantFault, QuantFaultPlan)
from repro_torch.quant.preflight import PreflightError, preflight  # noqa: F401
from repro_torch.quant.surgery import (  # noqa: F401
    abstract_quantized_params, merge_projection_groups, packed_model_bytes,
    place_cache_on_mesh, place_on_mesh, quantizable_paths)
from repro_torch.serve import recovery  # noqa: F401
from repro_torch.serve.batcher import BatchServer  # noqa: F401  (deprecated)
from repro_torch.serve.engine import (  # noqa: F401
    InferenceEngine, RequestError, RequestHandle, ServeConfig,
    TERMINAL_STATUSES)
from repro_torch.serve.faults import Fault, FaultPlan  # noqa: F401
from repro_torch.serve.paging import (  # noqa: F401
    PageAccountingError, PagedKVState)
from repro_torch.serve.scheduler import Request  # noqa: F401
from repro_torch.sharding.rules import ShardingPolicy  # noqa: F401

__all__ = [
    # artifact
    "NanoQuantModel", "MANIFEST_NAME", "MANIFEST_VERSION",
    # pipeline
    "QuantConfig", "nanoquant_quantize", "tune_scales_kd",
    # registries
    "Registry", "UnknownNameError",
    "ARCHS", "ArchSpec", "register_arch", "get_arch", "get_config",
    "get_smoke", "list_archs", "shapes_for",
    "INIT_METHODS", "register_init_method", "get_init_method",
    "list_init_methods",
    # kernels
    "KernelPolicy", "kernel_policy", "current_kernel_policy",
    "lowrank_binary_matmul", "lowrank_binary_matmul_merged",
    "lowrank_binary_matmul_expert", "set_kernel_policy",
    # surgery / storage / placement
    "abstract_quantized_params", "merge_projection_groups",
    "packed_model_bytes", "quantizable_paths", "place_on_mesh",
    "place_cache_on_mesh", "ShardingPolicy",
    # serving / persistence
    "InferenceEngine", "RequestHandle", "Request", "ServeConfig",
    "PagedKVState", "CheckpointManager", "BatchServer",
    # failure handling
    "RequestError", "TERMINAL_STATUSES", "PageAccountingError",
    "Fault", "FaultPlan", "recovery",
    # fault-tolerant quantization
    "QuantizationError", "QuantJournal", "JournalError",
    "QuantFault", "QuantFaultPlan", "InjectedPipelineCrash",
    "preflight", "PreflightError",
]
