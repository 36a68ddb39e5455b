"""The NanoQuant model artifact, the port of ``repro.api.model.
NanoQuantModel``: quantize (every family; crash-safe with a journal),
save / load, serve, evaluate.

    model = NanoQuantModel.quantize(params, cfg, calib)  # on the card
    model.save("/ckpt/nq")                           # JAX's load reads it
    model = NanoQuantModel.load("/ckpt/nq")          # on the card
    outs = model.generate(prompts, max_new_tokens=32)
    eng = model.engine(ServeConfig(greedy=True), max_batch=8)
    model.save("/ckpt/copy")                         # JAX's load reads it

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
from repro_torch.core.pipeline import QuantConfig, nanoquant_quantize
from repro_torch.data.synthetic import calib_batches, eval_perplexity
from repro_torch.kernels.ops import KernelPolicy
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.quant.surgery import (abstract_quantized_params,
                                       packed_model_bytes, param_specs)
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

    # ---- lifecycle: quantize ---------------------------------------------

    @classmethod
    def quantize(cls, params, cfg: ModelConfig, calib,
                 qcfg: Optional[QuantConfig] = None, verbose: bool = True,
                 journal_dir: Optional[str] = None, resume: bool = False,
                 faults=None, heartbeat=None,
                 device="cuda") -> "NanoQuantModel":
        """Run the full pipeline (paper Alg. 1) on an FP teacher (tensors,
        or the JAX package's numpy tree), moved to `device` first. The
        manifest's quant config is ``dataclasses.asdict(qcfg)``, which the
        JAX package's ``load`` rebuilds with ``QuantConfig(**...)``.
        `journal_dir` journals every finished block, `resume` picks a
        killed run up from its journal (a bit-identical artifact),
        `faults` (a ``quant.faults.QuantFaultPlan``) injects a fault
        schedule and `heartbeat` is called at block and KD boundaries
        (``core.pipeline.nanoquant_quantize``). The VLM's calibration
        batches carry ``image_embeds``."""
        qcfg = qcfg or QuantConfig()
        params = params_from_numpy(params, resolve_device(device))
        qparams, report = nanoquant_quantize(
            params, cfg, calib, qcfg, verbose=verbose,
            journal_dir=journal_dir, resume=resume, faults=faults,
            heartbeat=heartbeat)
        return cls(qparams, cfg, dataclasses.asdict(qcfg), report)

    @classmethod
    def from_fp(cls, params, cfg: ModelConfig) -> "NanoQuantModel":
        """Wrap unquantized params (the FP baseline) in the artifact."""
        return cls(params, cfg, None, {})

    @property
    def quantized(self) -> bool:
        return self.quant is not None

    @property
    def ranks(self) -> Dict[str, int]:
        return dict(self.report.get("ranks", {}))

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

    def save(self, directory: str, step: int = 0) -> str:
        """Write the packed params and the versioned manifest in the JAX
        package's artifact format (which its ``NanoQuantModel.load`` and
        :meth:`load` read); returns `directory`."""
        os.makedirs(directory, exist_ok=True)
        CheckpointManager(directory).save(
            step, self.params, _param_template(self.cfg, self.quant))
        manifest = {
            "format": "nanoquant-model",
            "version": MANIFEST_VERSION,
            "arch": self.cfg.name,
            "family": self.cfg.family,
            "quantized": self.quantized,
            "target_bpw": (self.quant.get("target_bpw", 1.0)
                           if self.quantized else 16.0),
            "model_config": dataclasses.asdict(self.cfg),
            "quant_config": dict(self.quant) if self.quantized else None,
            "ranks": self.report.get("ranks", {}),
            "report": _json_safe(
                {k: v for k, v in self.report.items() if k != "ranks"}),
        }
        with open(os.path.join(directory, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=1)
        return directory

    def engine(self, scfg: Optional[ServeConfig] = None, max_batch: int = 8,
               max_len: int = 512, seed: int = 0,
               admission: str = "continuous",
               spec_rank_frac: Optional[float] = None,
               spec_k: Optional[int] = None,
               prefix_cache: Optional[bool] = None,
               policy: Optional[KernelPolicy] = None, faults=None,
               clock=None, mesh=None) -> InferenceEngine:
        """The serving entry point: a slot-scheduled, continuously
        batched :class:`InferenceEngine` over this model on its device,
        over the paged pool, or the rectangle with
        ``ServeConfig(paged=False)``. `spec_rank_frac` / `spec_k` /
        `prefix_cache` override the matching ServeConfig fields, as in the
        JAX package. `faults` (a
        ``serve.faults.FaultPlan``) injects a fault schedule and `clock`
        replaces the deadline clock (both for chaos testing). `mesh` (a
        ``launch.mesh.Mesh`` of which this process is one rank) serves
        this rank's shards of the model, placed under
        ``sharding.rules.SERVE`` (every family: an MoE's experts split E
        / N per rank, a Mamba2 mixer's SSD heads H / N, the VLM's image
        K/V by kv head); every rank makes the same calls."""
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
                               device=self.device, policy=policy,
                               faults=faults, clock=clock, mesh=mesh)

    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: Optional[int] = None,
                 scfg: Optional[ServeConfig] = None, max_batch: int = 8,
                 seed: int = 0) -> List[np.ndarray]:
        """Batched generation on the engine (on the rectangle with
        ``scfg.paged=False``); one output array per prompt, in order. The
        audio family's prompts are (S, K) frames and its
        outputs (n, K); ``max_len`` counts frames."""
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

    # ---- lifecycle: evaluate ---------------------------------------------

    def perplexity(self, batches=None, n_samples: int = 8, seq: int = 64,
                   seed: int = 99) -> float:
        """exp(mean token NLL); `batches` default to a deterministic
        synthetic eval set (the JAX package's, from the same seed)."""
        if batches is None:
            batches = calib_batches(self.cfg, n_samples, seq, seed=seed)
        return eval_perplexity(T.loss_fn, self.params, self.cfg, batches)

    def size_report(self) -> Dict[str, float]:
        """Full-scale storage accounting of this config and bpw
        (``quant.surgery.packed_model_bytes``)."""
        q = self.quant or dataclasses.asdict(QuantConfig())
        return packed_model_bytes(self.cfg, q.get("target_bpw", 1.0),
                                  q.get("min_dim", 48),
                                  q.get("rank_align", 32),
                                  q.get("pack_k_align", 32))


def _param_template(cfg: ModelConfig, quant: Optional[Dict[str, Any]]):
    if quant is None:
        return param_specs(cfg)
    return abstract_quantized_params(
        cfg, quant.get("target_bpw", 1.0), quant.get("min_dim", 48),
        quant.get("rank_align", 32), quant.get("pack_k_align", 32))


def _json_safe(obj):
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj
