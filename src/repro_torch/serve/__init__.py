"""Continuous-batching serving over a paged KV pool, the port of
``repro.serve``: the engine (:class:`InferenceEngine`), the host-driven
``generate`` loop (the VLM's image entry point), its scheduler,
the refcounted page pool, the prefix cache, self-speculative decoding,
and the request-lifecycle layer: deadlines, ``RequestHandle.cancel()``
and the terminal statuses (:class:`RequestError`), ``engine.drain()``
with snapshot and restore (``recovery``), the pool audit
(:class:`PageAccountingError`) and deterministic fault injection
(:class:`FaultPlan`)."""
from repro_torch.serve.scheduler import (  # noqa: F401
    Request, SlotScheduler, bucket_length, pick_preemption_victim)
from repro_torch.serve.paging import (  # noqa: F401
    PageAccountingError, PagedKVState)
from repro_torch.serve.prefix import PrefixCache  # noqa: F401
from repro_torch.serve.faults import (  # noqa: F401
    Fault, FaultPlan, InjectedDeviceError)
from repro_torch.serve.engine import (  # noqa: F401
    InferenceEngine, RequestError, RequestHandle, ServeConfig,
    TERMINAL_STATUSES, generate, sample_token)
from repro_torch.serve import recovery  # noqa: F401
from repro_torch.serve.speculative import SpecDecodeController  # noqa: F401

__all__ = [
    "InferenceEngine", "RequestHandle", "ServeConfig", "Request",
    "SlotScheduler", "PagedKVState", "PrefixCache", "SpecDecodeController",
    "bucket_length", "pick_preemption_victim", "sample_token", "generate",
    "RequestError", "TERMINAL_STATUSES", "PageAccountingError",
    "Fault", "FaultPlan", "InjectedDeviceError", "recovery",
]
