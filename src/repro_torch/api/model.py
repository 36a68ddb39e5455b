"""The NanoQuant model artifact, serving side: the port of ``load`` /
``engine`` / ``generate`` of ``repro.api.model.NanoQuantModel``.

    model = NanoQuantModel.load("/ckpt/nq")          # on the card
    outs = model.generate(prompts, max_new_tokens=32)
    eng = model.engine(ServeConfig(greedy=True), max_batch=8)

A saved artifact is a checkpoint (``step_*/`` npz shards + meta.json)
plus a versioned ``nanoquant.json`` manifest carrying the model and quant
configs — enough to rebuild the restore template without JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.models.config import ModelConfig
from repro_torch.quant.surgery import abstract_quantized_params, param_specs
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import Request

MANIFEST_NAME = "nanoquant.json"
# v2: quant_config carries pack_k_align; v1 manifests load with the old
# unaligned layout (pack_k_align = 32).
MANIFEST_VERSION = 2


@dataclasses.dataclass
class NanoQuantModel:
    """A (possibly) NanoQuant-packed model on one device. ``quant`` is
    the manifest's quant config (None for an FP model)."""
    params: Any
    cfg: ModelConfig
    quant: Optional[Dict[str, Any]] = None
    report: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def quantized(self) -> bool:
        return self.quant is not None

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @classmethod
    def from_numpy(cls, tree, cfg: ModelConfig, device="cuda",
                   dtype: Optional[torch.dtype] = None,
                   quant: Optional[Dict[str, Any]] = None) -> "NanoQuantModel":
        """Wrap a parameter tree of numpy arrays (the JAX package's
        layout) as a model on `device`."""
        return cls(params_from_numpy(tree, resolve_device(device), dtype),
                   cfg, quant)

    @classmethod
    def load(cls, directory: str, device="cuda",
             dtype: Optional[torch.dtype] = None) -> "NanoQuantModel":
        """Restore from the JAX package's ``NanoQuantModel.save`` output.
        `dtype` optionally casts the FP leaves (packed leaves keep their
        stored dtypes)."""
        device = resolve_device(device)
        path = os.path.join(directory, MANIFEST_NAME)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} not found — is {directory!r} a NanoQuantModel "
                f"artifact?")
        with open(path) as f:
            manifest = json.load(f)
        if manifest.get("format") != "nanoquant-model":
            raise ValueError(f"{path} is not a nanoquant-model manifest")
        if manifest["version"] > MANIFEST_VERSION:
            raise ValueError(
                f"manifest version {manifest['version']} is newer than "
                f"this build supports ({MANIFEST_VERSION})")
        cfg = ModelConfig(**manifest["model_config"])
        quant = manifest.get("quant_config") if manifest.get("quantized") \
            else None
        try:
            restored = CheckpointManager(directory).restore_latest(
                _param_template(cfg, quant))
        except (ValueError, FileNotFoundError, KeyError, OSError) as e:
            raise ValueError(
                f"corrupt/truncated artifact {directory!r}: {e}") from e
        if restored is None:
            raise FileNotFoundError(f"no checkpoint steps in {directory!r}")
        _, tree = restored
        report = dict(manifest.get("report", {}))
        report["ranks"] = manifest.get("ranks", {})
        return cls(params_from_numpy(tree, device, dtype), cfg, quant, report)

    def engine(self, scfg: Optional[ServeConfig] = None, max_batch: int = 8,
               max_len: int = 512, seed: int = 0,
               admission: str = "continuous",
               spec_rank_frac: Optional[float] = None,
               spec_k: Optional[int] = None,
               prefix_cache: Optional[bool] = None,
               policy: Optional[KernelPolicy] = None) -> InferenceEngine:
        """The serving entry point: a slot-scheduled, continuously
        batched :class:`InferenceEngine` over this model on its device.
        `spec_rank_frac` / `spec_k` / `prefix_cache` override the
        matching ServeConfig fields, as in the JAX package."""
        scfg = scfg or ServeConfig()
        if spec_rank_frac is not None:
            scfg = dataclasses.replace(scfg, spec_rank_frac=spec_rank_frac)
        if spec_k is not None:
            scfg = dataclasses.replace(scfg, spec_k=spec_k)
        if prefix_cache is not None:
            scfg = dataclasses.replace(scfg, prefix_cache=prefix_cache)
        return InferenceEngine(self.params, self.cfg, scfg,
                               max_batch=max_batch, max_len=max_len,
                               seed=seed, admission=admission,
                               device=self.device, policy=policy)

    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: Optional[int] = None,
                 scfg: Optional[ServeConfig] = None, max_batch: int = 8,
                 seed: int = 0) -> List[np.ndarray]:
        """Batched generation on the engine; one output array per prompt,
        in order."""
        if not prompts:
            raise ValueError("generate() needs at least one prompt")
        if max_new_tokens is None:
            max_new_tokens = (scfg or ServeConfig()).max_new_tokens
        scfg = scfg or ServeConfig(max_new_tokens=max_new_tokens)
        max_len = max(len(p) for p in prompts) + max_new_tokens
        eng = self.engine(scfg, max_batch=max_batch, max_len=max_len,
                          seed=seed)
        for uid, prompt in enumerate(prompts):
            eng.submit(Request(uid, np.asarray(prompt, np.int64),
                               max_new_tokens=max_new_tokens))
        done = eng.run()
        return [done[uid].output for uid in range(len(prompts))]


def _param_template(cfg: ModelConfig, quant: Optional[Dict[str, Any]]):
    if quant is None:
        return param_specs(cfg)
    return abstract_quantized_params(
        cfg, quant.get("target_bpw", 1.0), quant.get("min_dim", 48),
        quant.get("rank_align", 32), quant.get("pack_k_align", 32))
