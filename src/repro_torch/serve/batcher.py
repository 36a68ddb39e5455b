"""DEPRECATED: the wave-admission shim over :class:`InferenceEngine`, the
port of ``repro.serve.batcher``.

``BatchServer`` drives the engine with ``admission="wave"`` (a new batch
is admitted only once every slot is free), so callers of the old
wave-lockstep server keep working; greedy outputs are token-identical per
request to the continuous engine. New code should use
``InferenceEngine`` / ``NanoQuantModel.engine()`` directly.
"""
from __future__ import annotations

import warnings
from typing import Dict, List

from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import Request  # noqa: F401  (re-export)


class BatchServer:
    """Deprecated wave-scheduled facade over :class:`InferenceEngine`.
    Cache-layout agnostic, as the reference's: it drives whatever layout
    `scfg` gives the engine, the paged pool (an overcommitted pool's
    preemptions requeue work mid-wave) or the rectangle
    (``paged=False``). Extra engine kwargs (``device=``, ``policy=``,
    ``mesh=``: the families ``engine.check_tp_serving`` admits) pass
    straight through."""

    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig,
                 max_batch: int = 8, max_len: int = 512, seed: int = 0,
                 **engine_kwargs):
        warnings.warn(
            "BatchServer is deprecated; use InferenceEngine "
            "(NanoQuantModel.engine()) for slot-scheduled continuous "
            "batching", DeprecationWarning, stacklevel=2)
        self.engine = InferenceEngine(params, cfg, scfg,
                                      max_batch=max_batch, max_len=max_len,
                                      seed=seed, admission="wave",
                                      **engine_kwargs)
        self.params, self.cfg, self.scfg = params, cfg, scfg
        self.max_batch, self.max_len = max_batch, max_len

    @property
    def queue(self) -> List[Request]:
        # pending holds fresh handles and preempted resume records; both
        # lead back to their Request
        return [h.request if hasattr(h, "request") else h.handle.request
                for h in self.engine.scheduler.pending]

    @property
    def done(self) -> Dict[int, Request]:
        return self.engine.done

    def submit(self, req: Request) -> None:
        self.engine.submit(req)

    def step_wave(self) -> List[Request]:
        """Serve one wave to completion; returns its requests."""
        if not self.engine.in_flight:
            return []
        finished = list(self.engine.step())     # admits the wave
        while self.engine.active.any():
            finished.extend(self.engine.step())
        return finished

    def run(self) -> Dict[int, Request]:
        while self.engine.in_flight:
            self.step_wave()
        return self.engine.done
