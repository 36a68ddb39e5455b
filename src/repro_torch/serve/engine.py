"""Serving engine: slot-scheduled continuous batching over the paged KV
pool or the rectangular KV cache, the port of the plain path of
``repro.serve.engine``.

:class:`InferenceEngine` owns a fixed pool of ``max_batch`` decode slots
over one paged KV pool. Each slot carries its own position, budget and
EOS state; one batched decode step advances every slot (inactive slots
write to the null page and are ignored). With ``ServeConfig(paged=False)``
it serves every family on the reference's rectangle instead, ``max_batch
x max_len`` rows (the hybrid's ring of ``win`` rows per slot): admission
prefills the prompt alone and inserts its whole rectangle into the slot,
and the decode step writes each slot's row at its position and reads the
rectangle under the decode mask; there is no page gate, no prefix
sharing, no speculation and no preemption (a device fault fails its slot
and the others decode on in place, a drain timeout fails the live
slots). A family with nothing to page
(the SSM family's recurrent state) is served on a per-slot state cache
instead: admission prefills the prompt at its exact length (a pad token
would enter the state) and inserts the state into the slot; the decode
step keeps inactive slots' state bit for bit; there is no pool, no
prefix sharing, no preemption and no speculation. The hybrid (zamba2)
has both: the same per-slot state for its Mamba2 stack and a pool of ring
pages for its shared attention block, each slot's whole ring mapped at
admission (exact-length prefill, no prefix sharing, no speculation; a
prompt longer than the ring fails its request, as the reference's
prefill does). Freed slots are refilled
mid-flight: admission prefills the prompt alone, right-padded to a
power-of-two bucket, and scatters its KV rows into the slot's pages. With
the prefix cache (``serve.prefix``, on by default) an admission first maps
the longest indexed prompt prefix's pages read-only and prefills only the
suffix, straight into the pool; a write into a shared page copies it
first. A pool that runs dry mid-decode evicts unmapped cached pages, then
preempts the cheapest slot, which is requeued and re-prefilled with
prompt + emitted tokens (token-exact under greedy decoding). With
``ServeConfig(spec_rank_frac=...)`` the decode tick is a self-speculative
cycle instead (``serve.speculative``).

Request lifecycle: a handle moves "pending" → "running" → one of
:data:`TERMINAL_STATUSES`. ``handle.cancel()`` and ``Request.deadline_s``
are honoured at tick boundaries (queued requests are dropped, active
slots torn down page-exactly); a request whose own prefill fails (a
poison prompt: non-finite logits) ends "failed" while the other slots
keep decoding; ``drain()`` closes admission and checkpoints the live
slots as resumable items, which ``serve.recovery`` snapshots and
restores. A ``serve.faults.FaultPlan`` injects faults at the engine's
seams. Errors of the kernel layer (``kernels.build.KernelError``) and of
the CUDA runtime are never isolated to one request: they propagate out
of ``step()``. A real CUDA fault is sticky (the context is unusable), so
in-process recovery covers only the injected class; the supervisor and a
snapshot (``launch.supervisor``, ``launch.serve``) recover a real one.

    engine = InferenceEngine(params, cfg, ServeConfig(greedy=True))
    handle = engine.submit(Request(0, prompt), on_token=print)
    done = engine.run()

The VLM is served over the pool as the reference's engine serves it: a
request carries no image, so every cross layer reads the zero image K/V
the admission's fresh cache holds. Images reach the model through
:func:`generate` (the reference's ``generate(image_embeds=)``), which
prefills a batch of prompts with their images and decodes them.

The audio family is served as the dense family, over frames: a prompt is
(S, K), one id per codebook, a frame counts as one token against
``max_len``, the budget and the pages, each step emits one (K,) frame per
slot (``Request.output`` is (n, K)), and a request ends on EOS when
codebook 0 of a frame is its ``eos_id``, as in the reference. Its prompt
prefixes are shared through the index as the dense family's (a chunk is
``page_size`` frames).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.build import KernelError
from repro_torch.models import transformer as T
from repro_torch.models.config import FAMILIES, ModelConfig
from repro_torch.quant.surgery import (kv_layout, local_cache,
                                      merge_projection_groups,
                                      param_placement, place_on_mesh)
from repro_torch.serve import paging, speculative
from repro_torch.serve.faults import InjectedDeviceError
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.scheduler import (Request, SlotScheduler,
                                         bucket_length, cache_insert_slot,
                                         pick_preemption_victim)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The JAX package's serving config, field for field. ``paged=False``
    serves on the reference's rectangular KV cache, its identity oracle
    (no prefix cache, no speculation); the SSM family has nothing to page
    and is served on its per-slot state cache under either setting.
    ``prefix_cache=True``
    shares prompt-prefix KV pages across requests (``serve.prefix``):
    admission maps the longest cached prefix read-only and prefills only
    the suffix, writes into shared pages copy on write, and cached pages
    are evicted LRU at refcount zero under pool pressure; greedy outputs
    of the dense family stay token-identical to ``prefix_cache=False``
    (the MoE family's follow the reference's prefix engine: an expert's
    capacity depends on the rows of each call).
    ``spec_rank_frac`` turns on self-speculative decoding
    (``serve.speculative``): each tick drafts up to ``spec_k`` tokens
    (no fewer than ``spec_k_min`` as the dynamic k shrinks) through the
    rank-truncated view and verifies them in one full-rank step; it needs
    ``greedy=True``."""
    temperature: float = 0.8
    top_k: int = 32
    max_new_tokens: int = 64
    greedy: bool = False
    paged: bool = True
    page_size: int = 64
    kv_pool_pages: Optional[int] = None
    page_watermark: int = 0
    prefix_cache: bool = True
    spec_rank_frac: Optional[float] = None
    spec_k: int = 4
    spec_k_min: int = 1
    debug: bool = False
    # None defers to the kernel policy; True/False force its megakernel bit
    megakernel: Optional[bool] = None


def sample_token(logits, generator: Optional[torch.Generator],
                 scfg: ServeConfig):
    """logits (B, S, V) -> token ids (B, 1) int64 from the last position,
    or the audio family's (B, S, K, V) -> one id per codebook (B, K):
    greedy argmax, or temperature + top-k sampling (per codebook) drawn
    from `generator`."""
    lf = logits[:, -1].float()
    B, V = lf.shape[0], lf.shape[-1]
    lf = lf.reshape(B, -1, V)                    # (B, 1) or (B, K) rows
    if scfg.greedy:
        return lf.argmax(dim=-1)
    lf = lf / max(scfg.temperature, 1e-6)
    if scfg.top_k:
        kth = torch.topk(lf, scfg.top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, torch.full_like(lf, -torch.inf), lf)
    return torch.multinomial(torch.softmax(lf, dim=-1).reshape(-1, V), 1,
                             generator=generator).reshape(B, -1)


def _batch_row(cache, b: int):
    """Row `b` of a rectangular cache as a batch-1 cache (views), each
    leaf cut at its stack's batch axis (``transformer.lead_axes``)."""
    return {st: {k: v.narrow(T.lead_axes(st), b, 1) for k, v in leaves.items()}
            for st, leaves in cache.items()}


def generate(params, cfg: ModelConfig, tokens, scfg: ServeConfig,
             generator: Optional[torch.Generator] = None, image_embeds=None,
             policy: Optional[kops.KernelPolicy] = None):
    """Host-driven generation, the port of ``repro.serve.engine.generate``:
    one batched prefill of the B equal-length prompts `tokens` (B, S), or
    the audio family's frames (B, S, K), at position 0 into a rectangular
    cache (the VLM's image K/V projected once from `image_embeds` (B,
    n_img, d), zero without them), then
    ``scfg.max_new_tokens`` decode steps at positions ``S + i``, each
    sampling from the last logits (`generator` draws when not greedy).
    With ``scfg.paged=False`` the steps decode on that rectangle, as the
    reference's do; by default (``paged=True``) the prefilled rows go
    into a pool of B slots whose tables map each row's pages (linear
    tables, or the hybrid's rings), the slot-indexed leaves (the VLM's
    image K/V, the Mamba2 state) by slot, and the steps decode over the
    pool. The SSM family decodes on its state cache either way. The
    kernel policy is `policy` or the ambient one (with merged projections
    added on the kernel path, ``scfg.megakernel`` overriding its bit), on
    the params' device. Returns (generated (B, max_new) int64, or (B,
    max_new, K) frames, and the last decode step's logits (B, 1, V) or
    (B, 1, K, V)), as the reference does."""
    dev = params["embed"].device
    pol = policy if policy is not None else kops.current_kernel_policy()
    if scfg.megakernel is not None:
        pol = dataclasses.replace(pol, megakernel=scfg.megakernel)
    if pol.use_merged_projections(dev):
        params = merge_projection_groups(params)
    params = T.split_layers(params)
    tokens = torch.as_tensor(np.asarray(tokens), device=dev).long()
    B, S = tokens.shape[:2]
    max_len = S + scfg.max_new_tokens
    kinds = paging.cache_page_kinds(cfg) if scfg.paged else set()
    with kops.kernel_policy(pol), torch.inference_mode():
        rect = T.init_cache(cfg, B, max_len, dev)
        logits, rect = T.prefill(params, cfg, tokens, rect,
                                 image_embeds=image_embeds)
        kv = None
        if kinds:
            kv = paging.PagedKVState(B, max_len, scfg.page_size, kinds=kinds,
                                     window=cfg.sliding_window)
            cache = paging.init_paged_cache(cfg, kv.n_pages, kv.page_size,
                                            dev, batch=B)
            for b in range(B):
                ids = kv.admit(b, S)
                paging.paged_insert_slot(
                    cache, _batch_row(rect, b),
                    {k: torch.from_numpy(v).to(dev) for k, v in ids.items()},
                    slot=b)
            del rect
        else:
            cache = rect
        outs = []
        for i in range(scfg.max_new_tokens):
            tok = sample_token(logits, generator, scfg)
            if cfg.family == "audio":
                tok = tok[:, None]                  # (B, 1, K)
            outs.append(tok)
            pos, tables = S + i, None               # the batch's position
            if kv is not None:
                for b in range(B):
                    kv.ensure(b, S + i)
                tables = kv.device_tables(dev)
                pos = torch.full((B,), S + i, dtype=torch.long, device=dev)
            logits, cache = T.decode_step(params, cfg, tok, cache, pos,
                                          block_tables=tables)
    gen = torch.cat(outs, dim=1) if outs \
        else tokens.new_zeros((B, 0) + tokens.shape[2:])
    return gen, logits


#: Terminal request statuses. "done" is the only successful one; the
#: other three carry a :class:`RequestError` on the handle.
TERMINAL_STATUSES = ("done", "cancelled", "expired", "failed")

# torch's own errors of the CUDA runtime (the classes this torch build has)
_CUDA_ERRORS = tuple(c for c in (getattr(torch, "AcceleratorError", None),
                                 getattr(torch.cuda, "OutOfMemoryError", None),
                                 getattr(torch.cuda, "CudaError", None))
                     if c is not None)


def _device_side(err: BaseException) -> bool:
    """Whether `err` came from the kernel layer or the CUDA runtime. Such
    an error belongs to the engine, not to the request whose admission
    raised it: it propagates instead of failing one handle."""
    return isinstance(err, (KernelError,) + _CUDA_ERRORS) or (
        isinstance(err, RuntimeError) and "cuda" in str(err).lower())


# the families tensor-parallel serving covers: every family
TP_FAMILIES = FAMILIES
# the Mamba2 mixer's linears without a Megatron role: whole on every rank
MIXER_WHOLE = ("wB", "wC", "wdt")


def check_tp_serving(cfg: ModelConfig, mesh, faults=None) -> None:
    """Raise unless an engine can serve `cfg` over `mesh` (a model of any
    family): no fault plan (it fires on one process's plan, ROADMAP item
    12d), query heads that divide the model axis (the
    hybrid's shared block and the VLM's self and cross layers alike),
    and, where the kv heads do not, each rank's query heads inside one
    GQA group (``quant.surgery.kv_layout``); an MoE's routed experts and
    its shared experts' FFN width divide the model axis too, and so do a
    Mamba2 mixer's SSD heads (a head that straddled two ranks could be
    scanned by neither)."""
    n = mesh.tp
    if faults is not None:
        raise NotImplementedError(
            "a fault plan fires on one process's schedule; it is refused "
            "under a tensor-parallel mesh (ROADMAP item 12d)")
    if cfg.n_heads % n:
        raise NotImplementedError(
            f"{cfg.n_heads} query heads do not divide over {n} ranks")
    if cfg.is_ssm_layer_stack and cfg.ssm_heads % n:
        raise NotImplementedError(
            f"{cfg.ssm_heads} SSD heads do not divide over {n} ranks")
    if cfg.family == "moe":
        if cfg.n_experts % n:
            raise NotImplementedError(
                f"{cfg.n_experts} experts do not divide over {n} ranks")
        shared = cfg.n_shared_experts * cfg.moe_d_ff
        if shared % n:
            raise NotImplementedError(
                f"the shared experts' FFN width {shared} does not divide "
                f"over {n} ranks")
    kv_layout(cfg, mesh)


def check_tp_layout(cfg: ModelConfig, params, mesh) -> None:
    """Raise unless ``place_on_mesh`` splits every linear of the layers
    (the block stacks and the hybrid's unstacked ``shared_attn``) as the
    launches read it: a column-parallel one on d_out only (wk / wv whole
    where ``kv_layout`` replicates the kv heads), a row-parallel one on
    d_in only, a routed expert stack on its expert axis only (each expert
    whole: the rank's launch of #1 runs its experts' full factors), the
    Mamba2 mixer's role-less wB / wC / wdt whole. The reference falls back
    to a whole linear where a shape does not divide and lets GSPMD
    regather its activation; explicit TP has no regather, so such a model
    is refused here."""
    from repro_torch.core.util import leaves_with_path
    from repro_torch.sharding.rules import tp_role
    want = {"col": {"qu_t": -1, "s1": -1, "w": -1, "b": -1},
            "row": {"qv": -2, "s2": -1, "w": -2},
            None: {}}
    kv_whole = kv_layout(cfg, mesh)[0]
    for path, spec in leaves_with_path(param_placement(params, cfg, mesh)):
        parts = path.split("/")
        if len(parts) < 2 or parts[0] not in T.STACKS + ("shared_attn",):
            continue
        role = tp_role(parts[-2])
        if role is None and parts[-2] not in MIXER_WHOLE:
            continue
        if kv_whole and parts[-2] in ("wk", "wv"):
            continue
        on = [i for i, e in enumerate(spec)
              if e == "model" or (isinstance(e, tuple) and "model" in e)]
        if "moe" in parts and "shared" not in parts:
            # a routed expert stack (the shared experts' FFN is Megatron's)
            if on != [T.lead_axes(parts[0])]:
                raise NotImplementedError(
                    f"{path} would be placed {spec} over {mesh.shape}: "
                    f"expert-parallel serving needs each routed expert "
                    f"stack split on its expert axis only")
            continue
        dim = want[role].get(parts[-1])
        if [i - len(spec) for i in on] != ([] if dim is None else [dim]):
            how = {"col": "column-parallel linear split on its d_out only",
                   "row": "row-parallel linear split on its d_in only",
                   None: "role-less linear whole on every rank"}[role]
            raise NotImplementedError(
                f"{path} would be placed {spec} over {mesh.shape}: "
                f"tensor-parallel serving needs each {how}")


class RequestError(RuntimeError):
    """Structured terminal error of one request: it ended "cancelled",
    "expired" or "failed" while the engine kept serving the others.
    ``RequestHandle.result()`` and handle iteration raise it; it is also
    stored on ``handle.error``."""

    def __init__(self, uid: int, status: str, reason: str):
        super().__init__(f"request {uid} {status}: {reason}")
        self.uid = uid
        self.status = status
        self.reason = reason


class RequestHandle:
    """Streaming view of one submitted request: ``tokens`` grows as the
    engine emits; iterate to stream (pumping ``engine.step()``), or call
    ``result()`` to block until terminal. ``status`` moves "pending" →
    "running" (first admission; preemption does not move it back) → one
    of :data:`TERMINAL_STATUSES`. A non-"done" terminal carries a
    :class:`RequestError` on ``error``: ``result()`` raises it, and
    iteration yields the tokens emitted before the terminal, then raises
    it. ``cancel()`` takes effect at the engine's next tick boundary.
    A token is an int, or the audio family's (K,) frame of int64 ids."""

    def __init__(self, engine: "InferenceEngine", request: Request,
                 on_token: Optional[Callable] = None):
        self._engine = engine
        self.request = request
        self.uid = request.uid
        self.on_token = on_token
        self.tokens: List[Any] = []
        self.status = "pending"
        self.error: Optional[RequestError] = None
        self.cancel_requested = False
        self.cancel_reason = "cancelled by client"
        self.deadline_at: Optional[float] = None   # engine clock, absolute
        self.submit_t = time.monotonic()
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None

    @property
    def finished(self) -> bool:
        """True once the request reached any terminal status."""
        return self.status in TERMINAL_STATUSES

    @property
    def done(self) -> bool:
        """True only for the successful terminal status."""
        return self.status == "done"

    def cancel(self, reason: str = "cancelled by client") -> None:
        """Request cancellation, honoured at the engine's next tick
        boundary: a queued request is dropped, an active slot torn down
        with its pages freed exactly. No-op once terminal."""
        if not self.finished:
            self.cancel_requested = True
            self.cancel_reason = reason

    def _finalize(self, status: str,
                  error: Optional[RequestError] = None) -> None:
        if status not in TERMINAL_STATUSES:
            raise ValueError(f"{status!r} is not a terminal status")
        self.status = status
        self.error = error
        self.finish_t = time.monotonic()

    def _append(self, token) -> None:
        if self.first_token_t is None:
            self.first_token_t = time.monotonic()
        self.tokens.append(token)

    def result(self) -> np.ndarray:
        """Pump the engine until terminal; the full output, or raise this
        request's :class:`RequestError`."""
        while not self.finished:
            if not self._engine.in_flight:
                raise RuntimeError(
                    f"request {self.uid} unfinished but engine is idle")
            self._engine.step()
        if self.error is not None:
            raise self.error
        return self.request.output

    def __iter__(self):
        # a fresh iterator per call from token 0: re-iterating a finished
        # handle replays its tokens
        i = 0
        while True:
            if i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            elif self.finished:
                if self.error is not None:
                    raise self.error
                return
            else:
                if not self._engine.in_flight:
                    raise RuntimeError(
                        f"request {self.uid} unfinished but engine is idle")
                self._engine.step()

    @property
    def latency(self) -> Optional[float]:
        return None if self.finish_t is None else self.finish_t - self.submit_t

    @property
    def ttft(self) -> Optional[float]:
        """Submission -> first emitted token (queue wait + prefill)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t


class _AbortAdmission(Exception):
    """A cancel or expiry noticed between a prefill and the slot's
    activation: unwind the admission to this terminal."""

    def __init__(self, status: str, reason: str):
        super().__init__(f"{status}: {reason}")
        self.status = status
        self.reason = reason


@dataclasses.dataclass
class _SlotTask:
    """Host-side record of the request occupying one decode slot."""
    handle: RequestHandle
    budget: int                        # new tokens still allowed
    toks: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Resume:
    """A preempted request re-queued for admission: re-prefills prompt +
    already-emitted tokens and continues with the remaining budget."""
    handle: RequestHandle
    prompt: np.ndarray
    budget: int
    emitted: List[Any] = dataclasses.field(default_factory=list)

    @property
    def uid(self) -> int:
        return self.handle.uid


class InferenceEngine:
    """Slot-scheduled, continuously batched serving engine over a paged
    KV pool, over the rectangle (``ServeConfig(paged=False)``, or the
    per-slot state cache of a family with nothing to page), or over both
    (the hybrid; see the module docstring). ``paged`` says whether there
    is a pool: ``kv`` is the pool's allocator, or None.

    params: the port's parameter tree, already on `device`; device:
    ``"cuda"`` by default (raises without a card) or ``"cpu"``; policy:
    the kernel policy for this engine's steps (default: the ambient
    one). With a policy on the kernel path the engine adds merged QKV /
    gate-up operands to its own copy of the params. faults: a
    ``serve.faults.FaultPlan`` whose hooks fire at the engine's seams
    (None in production); clock: the deadline clock, monotonic seconds
    (injectable so that tests expire requests deterministically).

    mesh: a tensor-parallel mesh (``repro_torch.launch.mesh.Mesh``) over
    which this process is one rank. The engine then holds this rank's
    shards (``quant.surgery.place_on_mesh`` under
    ``sharding.rules.SERVE``), merges its own QKV / gate-up
    shards, allocates its kv heads of the pool or the rectangle (whole
    where they do not divide, ``quant.surgery.kv_layout``; MLA's latent
    pool whole) and runs every launch of ``kernels.ops`` on them, with
    the all-reduces and the logits' all-gather between (see
    :func:`check_tp_serving` for what it serves). An MoE is
    expert-parallel: each rank holds E / N whole experts, routes every
    row with the replicated router and launches #1's grid over its own
    experts (``models.layers.moe``).
    The ranks run SPMD: each receives the same ``submit`` / ``step`` /
    ``run`` calls, the scheduler is deterministic given them, and every
    rank holds the same full logits, so greedy tokens and seeded samples
    agree on every rank without further messages;
    :meth:`check_invariants` checks that the ranks' host schedules agree.
    """

    def __init__(self, params, cfg: ModelConfig,
                 scfg: Optional[ServeConfig] = None, max_batch: int = 8,
                 max_len: int = 512, seed: int = 0,
                 admission: str = "continuous", device="cuda",
                 policy: Optional[kops.KernelPolicy] = None, faults=None,
                 clock: Optional[Callable[[], float]] = None, mesh=None):
        self.device = resolve_device(device)
        self.scfg = scfg or ServeConfig()
        if self.scfg.spec_rank_frac is not None:
            speculative.check_config(self.scfg)
        self.mesh = mesh
        if mesh is not None:
            check_tp_serving(cfg, mesh, faults=faults)
            if mesh.device.type != self.device.type:
                raise ValueError(f"this rank's mesh device is {mesh.device}, "
                                 f"the engine's {self.device}")
        kinds = paging.cache_page_kinds(cfg) if self.scfg.paged else set()
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        pol = policy if policy is not None else kops.current_kernel_policy()
        if self.scfg.megakernel is not None:
            pol = dataclasses.replace(pol, megakernel=self.scfg.megakernel)
        if mesh is not None:
            pol = dataclasses.replace(pol, mesh=mesh)
            check_tp_layout(cfg, params, mesh)
            params = place_on_mesh(params, cfg, mesh)
        self.policy = pol
        if pol.use_merged_projections(self.device):
            params = merge_projection_groups(params)
        self.params = T.split_layers(params)
        self.cfg = cfg
        self.max_batch, self.max_len = max_batch, max_len
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.scheduler = SlotScheduler(max_batch, admission)
        self.clock: Callable[[], float] = clock or time.monotonic
        self.faults = faults
        # drain(): no fresh admissions (preempted resumes still re-admit)
        self.draining = False
        # the paged pool, unless disabled (``paged=False``: the reference's
        # rectangle) or the family has nothing to page (the SSM family's
        # state is O(1) per slot): then the rectangular per-slot cache.
        # The hybrid's pool of ring pages holds its state leaves beside it.
        self.kv: Optional[paging.PagedKVState] = None
        if kinds:
            self.kv = paging.PagedKVState(max_batch, max_len,
                                          self.scfg.page_size,
                                          self.scfg.kv_pool_pages,
                                          self.scfg.page_watermark,
                                          kinds=kinds,
                                          window=cfg.sliding_window)
        self.paged = self.kv is not None
        if self.paged:
            self.cache = paging.init_paged_cache(
                cfg, self.kv.n_pages, self.kv.page_size, self.device,
                batch=max_batch, mesh=mesh)
        else:
            # under a mesh, each rank's rectangle of kv heads
            self.cache = local_cache(
                lambda dev: T.init_cache(cfg, max_batch, max_len, dev), cfg,
                mesh, self.device)
        self.pos = np.zeros((max_batch,), np.int64)
        self.active = np.zeros((max_batch,), bool)
        # the last emitted token of each slot: (max_batch, 1), or the
        # audio family's frames (max_batch, 1, K)
        self.tokens = np.zeros((max_batch, 1) + self._frame, np.int64)
        self._tasks: List[Optional[_SlotTask]] = [None] * max_batch
        self._callbacks: List[Tuple[Callable, int, Any]] = []
        self.handles: Dict[int, RequestHandle] = {}
        self.done: Dict[int, Request] = {}
        # per uid: the slot it holds, the steps of its admission and of
        # its terminal status
        self.slot_of: Dict[int, int] = {}
        self.admission_step: Dict[int, int] = {}
        self.completion_step: Dict[int, int] = {}
        self.stats: Dict[str, Any] = {}
        self.reset_stats()
        # prompt-prefix sharing needs a pool of linear tables only (an MoE
        # hit's suffix runs at the reference's padded length); the VLM's
        # cache depends on image embeddings the index cannot key
        self.prefix = None
        if self.paged and self.scfg.prefix_cache \
                and set(self.kv.tables) == {"linear"} and cfg.family != "vlm":
            self.prefix = PrefixCache(self.kv, self.stats)
        self.spec = None
        if self.scfg.spec_rank_frac is not None:
            self.spec = speculative.SpecDecodeController(self)

    # ---- submission -------------------------------------------------------

    def submit(self, req: Request,
               on_token: Optional[Callable] = None) -> RequestHandle:
        """Queue a request; returns a streaming handle. `on_token(uid,
        token)` fires per emitted token at the end of the step. Rejects
        prompts that leave no room to generate; budgets beyond
        ``max_len - prompt_len`` are truncated."""
        prompt = np.asarray(req.prompt)
        n = prompt.shape[0]
        if n == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.uid}: max_new_tokens must be "
                             f">= 1, got {req.max_new_tokens}")
        if n >= self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt length {n} >= max_len "
                f"{self.max_len} leaves no room to generate")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError(f"request {req.uid}: prompt token ids outside "
                             f"[0, {self.cfg.vocab_size}): refusing to embed "
                             f"out-of-vocabulary ids")
        if req.deadline_s is not None and req.deadline_s < 0:
            raise ValueError(f"request {req.uid}: deadline_s must be "
                             f">= 0, got {req.deadline_s}")
        if req.deadline_s is not None and self.mesh is not None:
            raise NotImplementedError(
                f"request {req.uid}: a deadline reads each rank's own clock, "
                f"so tensor-parallel ranks could expire it at different "
                f"ticks (ROADMAP item 12d)")
        need = self.kv.pages_for_prompt(n) if self.paged else 0
        if need and need + self.kv.watermark > self.kv.n_pages - 1:
            raise ValueError(
                f"request {req.uid}: prompt needs {need} pages but the pool "
                f"holds {self.kv.n_pages - 1} (watermark "
                f"{self.kv.watermark}) — it could never be admitted")
        old = self.handles.get(req.uid)
        if old is not None:
            if not old.finished:
                raise ValueError(f"duplicate request uid {req.uid} still "
                                 f"pending or decoding")
            self._forget(req.uid)          # uid reuse after a terminal
        handle = RequestHandle(self, req, on_token)
        if req.deadline_s is not None:
            handle.deadline_at = self.clock() + req.deadline_s
        self.handles[req.uid] = handle
        self.scheduler.submit(handle)
        return handle

    # ---- stepping ---------------------------------------------------------

    @property
    def in_flight(self) -> bool:
        return bool(self.scheduler.pending) or bool(self.active.any())

    def step(self) -> List[Request]:
        """One scheduler tick: fault hooks and reaping at the boundary,
        admission into free slots (gated on free pages when there is a
        pool, on free slots alone otherwise), then one batched decode step
        across the slots. Returns the requests finished now. `on_token`
        callbacks fire after the tick's state is committed; each is
        delivered even if an earlier one raises, and then the first error
        is raised."""
        finished: List[Request] = []
        self._callbacks = []
        promised = [0]     # pages owed to earlier admissions of this batch

        def page_gate(item):
            prompt = self._item_prompt(item)
            n = prompt.shape[0]
            need = self.kv.pages_for_prompt(n)
            if self.prefix is not None:
                # shared pages only bump refcounts; a full cover still pays
                # one page, as its last row is copied on write. The chain is
                # pinned before the check, so available_pages does not count
                # it as evictable and a later admission of this batch
                # cannot evict it before kv.admit refs it.
                p, pages, keys = self.prefix.match(prompt)
                need += (1 if p == n else 0) - len(pages)
                self.prefix.protect(keys)
            # a preempted resume was admitted once; the watermark holds
            # back slack for fresh work only
            wm = 0 if isinstance(item, _Resume) else self.kv.watermark
            ok = self.kv.available_pages - promised[0] - need >= wm
            if ok:
                promised[0] += need
            else:
                self.stats["page_waits"] += 1
            return ok

        def gate(item):
            if self.draining and not isinstance(item, _Resume):
                return False               # drain: no fresh admissions
            if self.faults is not None:
                # e.g. evict cached pages between earlier items' match
                # and their kv.admit: the protection must hold them
                self.faults.on_gate(self)
            return page_gate(item) if self.paged else True

        with kops.kernel_policy(self.policy), torch.inference_mode():
            if self.faults is not None:
                self.faults.on_step(self)
            self._reap()
            for slot, item in self.scheduler.admit_batch(gate):
                fin = self._admit(slot, item)
                if fin is not None:
                    finished.append(fin)
            if self.prefix is not None:
                self.prefix.unprotect_all()
            self.stats["peak_active"] = max(self.stats["peak_active"],
                                            int(self.active.sum()))
            if self.active.any():
                t0 = time.monotonic()
                try:
                    if self.spec is not None:
                        self.spec.tick(finished)
                    else:
                        self._decode_tick(finished)
                except InjectedDeviceError as e:
                    self._on_device_fault(e)
                self.stats["decode_time_s"] += time.monotonic() - t0
        self.stats["steps"] += 1
        if self.scfg.debug:
            self.check_invariants()
        callbacks, self._callbacks = self._callbacks, []
        err = None
        for cb, uid, token in callbacks:
            try:
                cb(uid, token)
            except BaseException as e:     # deliver to every consumer,
                err = err or e             # then raise the first error
        if err is not None:
            raise err
        return finished

    def run(self) -> Dict[int, Request]:
        """Drain the queue; returns {uid: completed Request}."""
        while self.in_flight:
            self.step()
        return dict(self.done)

    # ---- request lifecycle: cancellation, deadlines, drain ----------------

    def _verdict(self, handle: RequestHandle) -> Optional[Tuple[str, str]]:
        """(terminal status, reason) if `handle` is to be reaped now
        (cancelled, or past its deadline), else None."""
        if handle.cancel_requested:
            return "cancelled", handle.cancel_reason
        if handle.deadline_at is not None \
                and self.clock() >= handle.deadline_at:
            return "expired", (f"deadline "
                               f"{handle.request.deadline_s}s exceeded")
        return None

    @staticmethod
    def _item_handle(item) -> RequestHandle:
        return item.handle if isinstance(item, _Resume) else item

    def _reap(self) -> None:
        """Tick-boundary reaping: drop cancelled or expired requests from
        the queue and tear down cancelled or expired slots, their pages
        and prefix references freed exactly (the preemption teardown
        without the requeue)."""
        if not (self.scheduler.pending or self.active.any()):
            return
        for item in self.scheduler.reap(
                lambda it: self._verdict(self._item_handle(it)) is not None):
            handle = self._item_handle(item)
            status, reason = self._verdict(handle)
            toks = item.emitted if isinstance(item, _Resume) else []
            self._finalize_aborted(handle, status, reason, toks)
        for slot in np.nonzero(self.active)[0]:
            v = self._verdict(self._tasks[int(slot)].handle)
            if v is not None:
                self._abort_slot(int(slot), *v)

    def _release_slot(self, slot: int, handle: RequestHandle) -> None:
        """Empty `slot`: its pages and prefix references freed exactly
        (release tolerates a partial admission), its scheduler seat
        given back."""
        self.active[slot] = False
        self._tasks[slot] = None
        self.slot_of.pop(handle.uid, None)
        if self.paged:
            self.kv.release(slot)
        self.scheduler.release(slot)

    def _abort_slot(self, slot: int, status: str, reason: str) -> None:
        """Tear down an active slot to a non-successful terminal."""
        task = self._tasks[slot]
        self._release_slot(slot, task.handle)
        self._finalize_aborted(task.handle, status, reason, task.toks)
        if status == "failed":             # every fault audits the pool
            self.check_invariants()

    def _finalize_aborted(self, handle: RequestHandle, status: str,
                          reason: str, toks: List[Any]) -> None:
        """Move `handle` to a non-successful terminal. The tokens emitted
        before it stay readable on ``request.output`` and
        ``handle.tokens``; ``result()`` raises."""
        req = handle.request
        req.output = np.asarray(toks, np.int32) if toks \
            else np.zeros((0,), np.int32)
        handle._finalize(status, RequestError(req.uid, status, reason))
        self.completion_step[req.uid] = self.stats["steps"]
        self.stats[status] += 1

    def _on_device_fault(self, err: InjectedDeviceError) -> None:
        """Recover from an injected device error in the decode step. It is
        raised before the step enqueues any kernel, so the cache is intact:
        fail the attributed slot with a RequestError (the youngest active
        slot when the target holds none), preempt every other active slot
        of a pool (each resumes token-exactly by re-prefill; without a
        pool they keep decoding in place) and audit. A real CUDA fault is
        sticky and never reaches this path."""
        slot = self.slot_of.get(err.uid)
        if slot is None and self.active.any():
            slot = int(np.nonzero(self.active)[0][-1])
        self.stats["device_faults"] += 1
        if slot is not None:
            self._abort_slot(slot, "failed",
                             f"device error in decode step: {err}")
        if self.paged:
            for s in np.nonzero(self.active)[0]:
                self._preempt(int(s))
        self.check_invariants()

    def drain(self, timeout: Optional[float] = None) -> Dict[int, Request]:
        """Graceful drain: stop admitting fresh requests and keep stepping
        until every active slot finishes (or `timeout` seconds of the
        engine clock pass), then checkpoint what is still active as
        requeued resumes, which ``serve.recovery.snapshot`` persists; an
        engine without a pool cannot checkpoint a live slot and fails it.
        Returns the requests completed so far. Admission stays closed
        until :meth:`resume_admission`."""
        if timeout is not None and self.mesh is not None:
            raise NotImplementedError(
                "a drain timeout reads each rank's own clock, so "
                "tensor-parallel ranks could stop at different ticks "
                "(ROADMAP item 12d)")
        self.draining = True
        t0 = self.clock()
        while self.active.any():
            if timeout is not None and self.clock() - t0 >= timeout:
                break
            self.step()
        for slot in np.nonzero(self.active)[0]:
            if self.paged:
                self._preempt(int(slot))
            else:
                self._abort_slot(int(slot), "failed",
                                 "drain timeout: rectangular engine "
                                 "cannot checkpoint a live slot")
        return dict(self.done)

    def resume_admission(self) -> None:
        """Reopen admission after :meth:`drain`."""
        self.draining = False

    def check_invariants(self) -> None:
        """Audit the page pool (when there is one), the prefix index and
        the slot/task/owner alignment; raises ``paging.PageAccountingError``
        on the first violation. Runs on every fault and, with
        ``ServeConfig(debug=True)``, at the end of every tick. Under a
        mesh it also checks lockstep: a digest of this rank's host
        schedule (each slot's uid, position, activity and last token) is
        gathered over the ranks, and a mismatch raises."""
        if self.mesh is not None:
            from repro_torch.sharding import comm
            uids = np.asarray([-1 if u is None else u
                               for u in self.scheduler.slots], np.int64)
            comm.check_same(comm.fingerprint(
                uids, self.pos, self.active, self.tokens,
                np.asarray([len(self.scheduler.pending)])), self.mesh,
                "the host schedule")
        if self.paged:
            self.kv.check_invariants()
        if self.prefix is not None:
            self.prefix.check_invariants()
        for slot in range(self.max_batch):
            task = self._tasks[slot]
            if bool(self.active[slot]) != (task is not None):
                raise paging.PageAccountingError(
                    f"slot {slot}: active={bool(self.active[slot])} but "
                    f"task={'set' if task is not None else 'none'}")
            if task is None:
                continue
            uid = task.handle.uid
            if self.scheduler.slots[slot] != uid:
                raise paging.PageAccountingError(
                    f"slot {slot}: scheduler owner "
                    f"{self.scheduler.slots[slot]} != task uid {uid}")
            if self.paged and self.kv.has_linear and \
                    self.kv._mapped[slot] * self.kv.page_size < self.pos[slot]:
                raise paging.PageAccountingError(
                    f"slot {slot}: pos {int(self.pos[slot])} beyond its "
                    f"mapped rows")

    def reset_stats(self) -> None:
        for k in ("steps", "decode_steps", "wasted_slot_steps",
                  "tokens_emitted", "admissions", "preemptions",
                  "page_waits", "peak_active", "preempt_recompute_tokens",
                  "spec_cycles", "spec_draft_tokens", "spec_accepted_tokens",
                  "spec_rollback_tokens", "spec_rollback_pages",
                  # prefix cache: hit / lookup tokens give the hit rate;
                  # shared_pages is the peak of pages mapped by more than
                  # one slot, cow_copies the copies on write, evicted_pages
                  # the index's LRU evictions
                  "prefix_hit_tokens", "prefix_lookup_tokens",
                  "shared_pages", "cow_copies", "evicted_pages",
                  # terminal statuses, and injected device errors recovered
                  "cancelled", "expired", "failed", "device_faults"):
            self.stats[k] = 0
        # host wall-clock of the decode steps or speculative cycles
        # (decode tok/s = decode-emitted tokens / this; each ends in a host
        # read of the tokens); decode_steps counts a cycle as one step
        self.stats["decode_time_s"] = 0.0

    def kv_cache_bytes(self) -> int:
        """Bytes of the cache's attention leaves, as in the reference: the
        paged pool's (the hybrid's ring pool), or the rectangle's (its
        ring of ``win`` rows per slot, the VLM's image K/V); 0 for the SSM
        family's state cache."""
        return paging.kv_cache_bytes(self.cache)

    def cache_bytes(self) -> int:
        """Bytes of every leaf of the engine's cache: the paged pool or the
        rectangle, the per-slot state cache (the SSM family's f32 state
        and conv rings, which do not grow with max_len), or both (the
        hybrid)."""
        return sum(t.numel() * t.element_size()
                   for leaves in self.cache.values() for t in leaves.values())

    def _forget(self, uid: int) -> None:
        for d in (self.handles, self.done, self.slot_of,
                  self.admission_step, self.completion_step):
            d.pop(uid, None)

    def clear_finished(self) -> None:
        """Drop the engine's bookkeeping of completed requests (handles,
        outputs, step logs); callers keep their handles."""
        for uid in list(self.done):
            self._forget(uid)

    # ---- internals --------------------------------------------------------

    @staticmethod
    def _item_prompt(item) -> np.ndarray:
        if isinstance(item, _Resume):
            return item.prompt
        return np.asarray(item.request.prompt, np.int64)

    def _admit(self, slot: int, item) -> Optional[Request]:
        """Failure-isolated admission: when a request's own prefill fails
        (non-finite logits, or any error outside the kernel layer and the
        CUDA runtime), that handle ends "failed" with a RequestError, its
        partial slot state is torn down page-exactly and the other slots
        keep decoding. Page-accounting violations, errors of the kernel
        layer (``KernelError``) and the CUDA runtime's errors stay
        engine-fatal: they propagate out of ``step()``."""
        try:
            return self._admit_impl(slot, item)
        except paging.PageAccountingError:
            raise
        except _AbortAdmission as e:       # cancel or expiry mid-prefill
            self._teardown_admission(slot, item, e.status, e.reason)
        except Exception as e:
            if _device_side(e):
                raise
            self._teardown_admission(slot, item, "failed",
                                     f"{type(e).__name__}: {e}")
            self.check_invariants()        # every fault audits the pool
        return None

    def _teardown_admission(self, slot: int, item, status: str,
                            reason: str) -> None:
        """Unwind a partly admitted slot and finalize its handle."""
        handle = self._item_handle(item)
        self._release_slot(slot, handle)
        toks = item.emitted if isinstance(item, _Resume) else []
        self._finalize_aborted(handle, status, reason, toks)

    def _admit_impl(self, slot: int, item) -> Optional[Request]:
        """Prefill `item`'s prompt into `slot` and emit its first token:
        on a prefix hit only the suffix, straight into the pool
        (:meth:`_admit_shared`); otherwise the whole prompt alone
        (bucketed; at its exact length for the SSM and hybrid families,
        where a pad token would enter the state), its KV rows scattered
        into the slot's fresh pages and its state into the slot.
        The logits are checked, and a cancel or expiry that landed
        meanwhile honoured, before any chunk is registered with the
        prefix index. Returns the request if it finished at once."""
        if isinstance(item, _Resume):
            handle, budget_cap, prior = item.handle, item.budget, item.emitted
            self.stats["preempt_recompute_tokens"] += int(item.prompt.shape[0])
        else:
            handle, prior = item, []
            budget_cap = handle.request.max_new_tokens
        prompt = self._item_prompt(item)
        n = prompt.shape[0]
        p, pages = 0, []
        if self.prefix is not None:
            # match afresh: an earlier admission of this batch may have
            # registered chunks this prompt can share. The gate's chain is
            # protected, so this covers at least what the gate counted.
            p, pages, _ = self.prefix.match(prompt)
            self.stats["prefix_lookup_tokens"] += int(n)
            self.stats["prefix_hit_tokens"] += int(p)
        if p > 0:
            logits = self._admit_shared(slot, prompt, n, p, pages)
        else:
            bucket = n if self.cfg.is_ssm_layer_stack \
                else bucket_length(n, self.max_len)
            padded = np.zeros((1, bucket) + prompt.shape[1:], np.int64)
            padded[0, :n] = prompt
            single = local_cache(
                lambda dev: T.init_cache(self.cfg, 1, self.max_len, dev),
                self.cfg, self.mesh, self.device)
            logits, single = T.prefill(
                self.params, self.cfg,
                torch.from_numpy(padded).to(self.device), single,
                last_idx=n - 1)
            if self.paged:
                ids = self.kv.admit(slot, n)       # gated by admit_batch
                paging.paged_insert_slot(
                    self.cache, single,
                    {k: torch.from_numpy(v).to(self.device)
                     for k, v in ids.items()}, slot)
            else:
                cache_insert_slot(self.cache, single, slot)
        if self.faults is not None \
                and self.faults.poison_prefill(self, handle.uid):
            logits = torch.full_like(logits, float("nan"))
        if not bool(torch.isfinite(logits).all()):
            # before register: non-finite logits mean suspect KV, and a
            # registered chunk would reach every later sharer of its page
            raise ValueError("non-finite prefill logits (poison request)")
        if self.faults is not None:
            self.faults.on_prefill(self, handle)
        v = self._verdict(handle)
        if v is not None:                  # cancel or expiry mid-prefill
            raise _AbortAdmission(*v)
        if self.prefix is not None:
            self.prefix.register(prompt, n, self.kv.tables["linear"][slot])
            self.stats["shared_pages"] = max(self.stats["shared_pages"],
                                             self.kv.shared_page_count)
        tok = self._token(sample_token(logits, self.generator,
                                       self.scfg).cpu().numpy()[0])
        task = _SlotTask(handle, budget=min(budget_cap, self.max_len - n),
                         toks=list(prior))
        handle.status = "running"          # sticky across preemption
        self._tasks[slot] = task
        self.pos[slot] = n
        self.slot_of[handle.uid] = slot
        self.admission_step[handle.uid] = self.stats["steps"]
        self.stats["admissions"] += 1
        fin = self._emit(slot, tok)
        if fin is None:
            self.active[slot] = True
            self.tokens[slot, 0] = tok
        return fin

    def _admit_shared(self, slot: int, prompt: np.ndarray, n: int, p: int,
                      pages: List[int]):
        """Prefix-hit admission: map the `p` matched tokens' `pages`
        read-only into `slot` and prefill only the suffix straight into
        the pool, at its exact length (dense family) or right-padded as
        the reference pads it (MoE family). A full cover (p == n)
        re-emits from the last prompt token: its page is copied on write
        first and one token is re-prefilled. Returns the next-token
        logits."""
        self.kv.admit(slot, n, shared=pages)
        start = n - 1 if p == n else p
        if not self._cow_rows(slot, start, n):
            raise paging.PageAccountingError(
                "admission copy-on-write starved: the gate promised the page")
        dev = self.device
        m = n - start
        rows = m
        if self.cfg.family == "moe":
            # the MoE's capacity depends on the call's rows, so the suffix
            # runs at the reference's length: its compile bucket, clamped
            # to the slot's rows (a pad row past them would wrap onto the
            # shared prefix pages). The dense family keeps its exact length.
            rows = min(bucket_length(m, self.max_len),
                       self.kv.lin_pages * self.kv.page_size - start)
        suffix = np.zeros((1, rows) + prompt.shape[1:], np.int64)
        suffix[0, :m] = prompt[start:]
        table = torch.from_numpy(
            self.kv.tables["linear"][slot:slot + 1].copy()).to(dev)
        logits, self.cache = T.prefill(
            self.params, self.cfg, torch.from_numpy(suffix).to(dev),
            self.cache, last_idx=m - 1,
            start_pos=torch.tensor([start], device=dev),
            block_tables={"linear": table})
        return logits

    def _decode_tick(self, finished: List[Request]) -> None:
        """Reserve the next cache row of every active slot (preempting
        if the pool is dry), run one batched decode step over every slot
        (inactive slots keep their recurrent state, where the family has
        one), commit positions and emit."""
        if self.paged:
            self._ensure_decode_pages()
        if not self.active.any():          # everything self-preempted
            return
        if self.faults is not None:
            # raises before any kernel of the step is enqueued, so the
            # cache is intact for the recovery
            self.faults.before_decode(self)
        dev = self.device
        tables = active = None
        if self.paged:
            tables = self.kv.device_tables(dev)
        if self.cfg.is_ssm_layer_stack:
            active = torch.from_numpy(self.active).to(dev)
        logits, self.cache = T.decode_step(
            self.params, self.cfg, torch.from_numpy(self.tokens).to(dev),
            self.cache, torch.from_numpy(self.pos).to(dev),
            block_tables=tables, active=active)
        tok = sample_token(logits, self.generator, self.scfg)
        tok = tok.cpu().numpy()
        tok[~self.active] = 0
        self.tokens = tok.reshape(self.tokens.shape)
        self.stats["decode_steps"] += 1
        self.stats["wasted_slot_steps"] += int(self.max_batch
                                               - self.active.sum())
        for slot in np.nonzero(self.active)[0]:
            self.pos[slot] += 1
            fin = self._emit(int(slot), self._token(tok[slot]))
            if fin is not None:
                finished.append(fin)

    def _ensure_decode_pages(self) -> None:
        """Map the page of every active slot's next cache write; while
        the pool is dry, preempt the cheapest slot (possibly the needy
        one itself). One slot's worst case always fits the pool, so a
        lone survivor progresses."""
        for slot in np.nonzero(self.active)[0]:
            slot = int(slot)
            while self.active[slot] and not self._reserve_decode_rows(
                    slot, int(self.pos[slot]) + 1):
                self._preempt(self._select_victim())

    def _reserve_decode_rows(self, slot: int, n_rows: int) -> bool:
        """Make rows [pos, n_rows) of `slot` privately writable: map their
        pages, then copy on write any the slot shares (with the index or
        another slot). The plain tick reserves pos + 1, the speculative
        cycle pos + k + 1. False => pool dry even after LRU eviction; the
        caller preempts and retries (both steps are idempotent)."""
        if not self.kv.reserve_rows(slot, n_rows):
            return False
        return self._cow_rows(slot, int(self.pos[slot]), n_rows)

    def _cow_rows(self, slot: int, row0: int, row1: int) -> bool:
        """Copy on write every shared page covering the coming writes to
        rows [row0, row1) of `slot`. False => pool dry."""
        while True:
            idx = self.kv.next_shared_write_page(slot, row0, row1)
            if idx is None:
                return True
            pair = self.kv.cow(slot, idx)
            if pair is None:
                return False
            paging.copy_page(self.cache, *pair)
            self.stats["cow_copies"] += 1

    def _select_victim(self) -> int:
        """The active slot whose resume re-prefills the fewest tokens that
        the prefix index does not already cover (prompt + emitted, less the
        indexed prefix); ties break youngest-first."""
        cands = []
        for s in np.nonzero(self.active)[0]:
            task = self._tasks[int(s)]
            resume = np.concatenate(
                [np.asarray(task.handle.request.prompt, np.int64),
                 np.asarray(task.toks, np.int64)])
            cost = resume.shape[0]
            if self.prefix is not None:
                cost -= self.prefix.match_len(resume)
            cands.append((int(s), cost,
                          self.admission_step.get(task.handle.uid, -1)))
        return pick_preemption_victim(cands)

    def _preempt(self, slot: int) -> None:
        """Evict `slot` mid-decode: free its pages and requeue the rest
        of its generation at the queue front. Its handle keeps
        streaming; emitted tokens are never replayed."""
        task = self._tasks[slot]
        prompt = np.concatenate(
            [np.asarray(task.handle.request.prompt, np.int64),
             np.asarray(task.toks, np.int64)])
        self._release_slot(slot, task.handle)   # queued, not placed
        self.scheduler.requeue(_Resume(task.handle, prompt, task.budget,
                                       list(task.toks)))
        self.stats["preemptions"] += 1

    @property
    def _frame(self) -> Tuple[int, ...]:
        """The trailing shape of one token: (K,) for the audio family's
        frames, () otherwise."""
        return (self.cfg.n_codebooks,) if self.cfg.family == "audio" else ()

    def _token(self, row: np.ndarray):
        """One slot's sampled row as the token it emits: an int, or the
        audio family's (K,) frame."""
        return row.copy() if self._frame else int(row[0])

    def _emit(self, slot: int, token) -> Optional[Request]:
        """Record one emitted token; finish the slot on EOS or budget. An
        audio frame ends its request when codebook 0 is ``eos_id``, as in
        the reference."""
        task = self._tasks[slot]
        req = task.handle.request
        task.toks.append(token)
        task.budget -= 1
        self.stats["tokens_emitted"] += 1
        task.handle._append(token)
        if task.handle.on_token is not None:
            self._callbacks.append((task.handle.on_token, task.handle.uid,
                                    token))
        first = int(token[0]) if self._frame else token
        if (req.eos_id is not None and first == req.eos_id) \
                or task.budget <= 0:
            return self._finish(slot)
        return None

    def _finish(self, slot: int) -> Request:
        task = self._tasks[slot]
        req = task.handle.request
        req.output = np.asarray(task.toks, np.int32)
        self.done[req.uid] = req
        self.completion_step[req.uid] = self.stats["steps"]
        task.handle._finalize("done")
        self._release_slot(slot, task.handle)
        return req
