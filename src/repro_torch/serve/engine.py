"""Serving engine: slot-scheduled continuous batching over the paged KV
pool, the port of the plain path of ``repro.serve.engine``.

:class:`InferenceEngine` owns a fixed pool of ``max_batch`` decode slots
over one paged KV pool. Each slot carries its own position, budget and
EOS state; one batched decode step advances every slot (inactive slots
write to the null page and are ignored). Freed slots are refilled
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

    engine = InferenceEngine(params, cfg, ServeConfig(greedy=True))
    handle = engine.submit(Request(0, prompt), on_token=print)
    done = engine.run()
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.quant.surgery import merge_projection_groups
from repro_torch.serve import paging, speculative
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.scheduler import (Request, SlotScheduler,
                                         bucket_length,
                                         pick_preemption_victim)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The JAX package's serving config, field for field. The port serves
    the paged pool only (``paged=False`` raises). ``prefix_cache=True``
    shares prompt-prefix KV pages across requests (``serve.prefix``):
    admission maps the longest cached prefix read-only and prefills only
    the suffix, writes into shared pages copy on write, and cached pages
    are evicted LRU at refcount zero under pool pressure; greedy outputs
    stay token-identical to ``prefix_cache=False``.
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
    """logits (B, S, V) -> token ids (B, 1) int64 from the last position:
    greedy argmax, or temperature + top-k sampling drawn from
    `generator`."""
    lf = logits[:, -1].float()
    if scfg.greedy:
        return lf.argmax(dim=-1, keepdim=True)
    lf = lf / max(scfg.temperature, 1e-6)
    if scfg.top_k:
        kth = torch.topk(lf, scfg.top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, torch.full_like(lf, -torch.inf), lf)
    return torch.multinomial(torch.softmax(lf, dim=-1), 1,
                             generator=generator)


class RequestHandle:
    """Streaming view of one submitted request: ``tokens`` grows as the
    engine emits; iterate to stream (pumping ``engine.step()``), or call
    ``result()`` to block until done. ``status`` moves "pending" →
    "running" (first admission; preemption does not move it back) →
    "done"."""

    def __init__(self, engine: "InferenceEngine", request: Request,
                 on_token: Optional[Callable] = None):
        self._engine = engine
        self.request = request
        self.uid = request.uid
        self.on_token = on_token
        self.tokens: List[int] = []
        self.status = "pending"
        self.submit_t = time.monotonic()
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.status == "done"

    def _append(self, token: int) -> None:
        if self.first_token_t is None:
            self.first_token_t = time.monotonic()
        self.tokens.append(token)

    def result(self) -> np.ndarray:
        while not self.done:
            if not self._engine.in_flight:
                raise RuntimeError(
                    f"request {self.uid} unfinished but engine is idle")
            self._engine.step()
        return self.request.output

    def __iter__(self):
        i = 0
        while True:
            if i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            elif self.done:
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


@dataclasses.dataclass
class _SlotTask:
    """Host-side record of the request occupying one decode slot."""
    handle: RequestHandle
    budget: int                        # new tokens still allowed
    toks: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Resume:
    """A preempted request re-queued for admission: re-prefills prompt +
    already-emitted tokens and continues with the remaining budget."""
    handle: RequestHandle
    prompt: np.ndarray
    budget: int
    emitted: List[int] = dataclasses.field(default_factory=list)

    @property
    def uid(self) -> int:
        return self.handle.uid


class InferenceEngine:
    """Slot-scheduled, continuously batched serving engine over a paged
    KV pool (see the module docstring).

    params: the port's parameter tree, already on `device`; device:
    ``"cuda"`` by default (raises without a card) or ``"cpu"``; policy:
    the kernel policy for this engine's steps (default: the ambient
    one). With a policy on the kernel path the engine adds merged QKV /
    gate-up operands to its own copy of the params.
    """

    def __init__(self, params, cfg: ModelConfig,
                 scfg: Optional[ServeConfig] = None, max_batch: int = 8,
                 max_len: int = 512, seed: int = 0,
                 admission: str = "continuous", device="cuda",
                 policy: Optional[kops.KernelPolicy] = None):
        self.device = resolve_device(device)
        self.scfg = scfg or ServeConfig()
        if self.scfg.spec_rank_frac is not None:
            speculative.check_config(self.scfg)
        if not self.scfg.paged:
            raise NotImplementedError(
                "the port decodes over the paged pool only (paged=True)")
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        pol = policy if policy is not None else kops.current_kernel_policy()
        if self.scfg.megakernel is not None:
            pol = dataclasses.replace(pol, megakernel=self.scfg.megakernel)
        self.policy = pol
        if pol.use_merged_projections(self.device):
            params = merge_projection_groups(params)
        self.params = T.split_layers(params)
        self.cfg = cfg
        self.max_batch, self.max_len = max_batch, max_len
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.scheduler = SlotScheduler(max_batch, admission)
        self.kv = paging.PagedKVState(max_batch, max_len,
                                      self.scfg.page_size,
                                      self.scfg.kv_pool_pages,
                                      self.scfg.page_watermark)
        self.cache = paging.init_paged_cache(cfg, self.kv.n_pages,
                                             self.kv.page_size, self.device)
        self.pos = np.zeros((max_batch,), np.int64)
        self.active = np.zeros((max_batch,), bool)
        self.tokens = np.zeros((max_batch, 1), np.int64)
        self._tasks: List[Optional[_SlotTask]] = [None] * max_batch
        self._callbacks: List[Tuple[Callable, int, Any]] = []
        self.handles: Dict[int, RequestHandle] = {}
        self.done: Dict[int, Request] = {}
        self.admission_step: Dict[int, int] = {}
        self.stats: Dict[str, Any] = {}
        self.reset_stats()
        # the port serves the dense family, whose tables are linear only
        # and whose KV is a function of the tokens: it always shares
        self.prefix = (PrefixCache(self.kv, self.stats)
                       if self.scfg.prefix_cache else None)
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
                             f"[0, {self.cfg.vocab_size})")
        need = self.kv.pages_for_prompt(n)
        if need + self.kv.watermark > self.kv.n_pages - 1:
            raise ValueError(
                f"request {req.uid}: prompt needs {need} pages but the pool "
                f"holds {self.kv.n_pages - 1} (watermark "
                f"{self.kv.watermark}) — it could never be admitted")
        old = self.handles.get(req.uid)
        if old is not None:
            if not old.done:
                raise ValueError(f"duplicate request uid {req.uid} still "
                                 f"pending or decoding")
            self._forget(req.uid)
        handle = RequestHandle(self, req, on_token)
        self.handles[req.uid] = handle
        self.scheduler.submit(handle)
        return handle

    # ---- stepping ---------------------------------------------------------

    @property
    def in_flight(self) -> bool:
        return bool(self.scheduler.pending) or bool(self.active.any())

    def step(self) -> List[Request]:
        """One scheduler tick: admit into free slots, then one batched
        decode step across the pool. Returns the requests finished now.
        `on_token` callbacks fire after the tick's state is committed."""
        finished: List[Request] = []
        self._callbacks = []
        promised = [0]     # pages owed to earlier admissions of this batch

        def gate(item):
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

        with kops.kernel_policy(self.policy), torch.inference_mode():
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
                if self.spec is not None:
                    self.spec.tick(finished)
                else:
                    self._decode_tick(finished)
                self.stats["decode_time_s"] += time.monotonic() - t0
        self.stats["steps"] += 1
        if self.scfg.debug:
            self.check_invariants()
        callbacks, self._callbacks = self._callbacks, []
        for cb, uid, token in callbacks:
            cb(uid, token)
        return finished

    def run(self) -> Dict[int, Request]:
        """Drain the queue; returns {uid: completed Request}."""
        while self.in_flight:
            self.step()
        return dict(self.done)

    def check_invariants(self) -> None:
        """Audit the page pool, the prefix index and the slot/task
        alignment; raises ``paging.PageAccountingError`` on the first
        violation."""
        self.kv.check_invariants()
        if self.prefix is not None:
            self.prefix.check_invariants()
        for slot in range(self.max_batch):
            task = self._tasks[slot]
            if bool(self.active[slot]) != (task is not None):
                raise paging.PageAccountingError(
                    f"slot {slot}: active={bool(self.active[slot])} but "
                    f"task={'set' if task is not None else 'none'}")
            if task is not None and \
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
                  "shared_pages", "cow_copies", "evicted_pages"):
            self.stats[k] = 0
        # host wall-clock of the decode steps or speculative cycles
        # (decode tok/s = decode-emitted tokens / this; each ends in a host
        # read of the tokens); decode_steps counts a cycle as one step
        self.stats["decode_time_s"] = 0.0

    def _forget(self, uid: int) -> None:
        for d in (self.handles, self.done, self.admission_step):
            d.pop(uid, None)

    # ---- internals --------------------------------------------------------

    @staticmethod
    def _item_prompt(item) -> np.ndarray:
        if isinstance(item, _Resume):
            return item.prompt
        return np.asarray(item.request.prompt, np.int64)

    def _admit(self, slot: int, item) -> Optional[Request]:
        """Prefill `item`'s prompt into `slot` and emit its first token:
        on a prefix hit only the suffix, straight into the pool
        (:meth:`_admit_shared`); otherwise the whole prompt alone
        (bucketed), its KV rows scattered into the slot's fresh pages.
        Returns the request if it finished at once."""
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
            bucket = bucket_length(n, self.max_len)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :n] = prompt
            single = T.init_cache(self.cfg, 1, self.max_len, self.device)
            logits, single = T.prefill(
                self.params, self.cfg,
                torch.from_numpy(padded).to(self.device), single,
                last_idx=n - 1)
            ids = self.kv.admit(slot, n)           # gated by admit_batch
            paging.paged_insert_slot(
                self.cache, single,
                {k: torch.from_numpy(v).to(self.device)
                 for k, v in ids.items()})
        if self.prefix is not None and bool(torch.isfinite(logits).all()):
            # non-finite logits mean suspect KV: a registered chunk would
            # reach every later sharer of its page
            self.prefix.register(prompt, n, self.kv.tables["linear"][slot])
            self.stats["shared_pages"] = max(self.stats["shared_pages"],
                                             self.kv.shared_page_count)
        tok = int(sample_token(logits, self.generator, self.scfg)[0, 0])
        task = _SlotTask(handle, budget=min(budget_cap, self.max_len - n),
                         toks=list(prior))
        handle.status = "running"
        self._tasks[slot] = task
        self.pos[slot] = n
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
        read-only into `slot` and prefill only the suffix, at its exact
        length, straight into the pool. A full cover (p == n) re-emits
        from the last prompt token: its page is copied on write first and
        one token is re-prefilled. Returns the next-token logits."""
        self.kv.admit(slot, n, shared=pages)
        start = n - 1 if p == n else p
        if not self._cow_rows(slot, start, n):
            raise paging.PageAccountingError(
                "admission copy-on-write starved: the gate promised the page")
        dev = self.device
        suffix = torch.from_numpy(np.ascontiguousarray(prompt[start:])).to(dev)
        table = torch.from_numpy(
            self.kv.tables["linear"][slot:slot + 1].copy()).to(dev)
        logits, self.cache = T.prefill(
            self.params, self.cfg, suffix[None], self.cache,
            start_pos=torch.tensor([start], device=dev),
            block_tables={"linear": table})
        return logits

    def _decode_tick(self, finished: List[Request]) -> None:
        """Reserve the next cache row of every active slot (preempting
        if the pool is dry), run one batched decode step, commit
        positions and emit."""
        self._ensure_decode_pages()
        if not self.active.any():          # everything self-preempted
            return
        dev = self.device
        tables = self.kv.device_tables(dev)
        logits, self.cache = T.decode_step(
            self.params, self.cfg, torch.from_numpy(self.tokens).to(dev),
            self.cache, torch.from_numpy(self.pos).to(dev),
            block_tables=tables)
        tok = sample_token(logits, self.generator, self.scfg)
        tok = tok.cpu().numpy()
        tok[~self.active] = 0
        self.tokens = tok
        self.stats["decode_steps"] += 1
        self.stats["wasted_slot_steps"] += int(self.max_batch
                                               - self.active.sum())
        for slot in np.nonzero(self.active)[0]:
            self.pos[slot] += 1
            fin = self._emit(int(slot), int(tok[slot, 0]))
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
        self.active[slot] = False
        self._tasks[slot] = None
        self.kv.release(slot)
        self.scheduler.release(slot)
        self.scheduler.requeue(_Resume(task.handle, prompt, task.budget,
                                       list(task.toks)))
        self.stats["preemptions"] += 1

    def _emit(self, slot: int, token: int) -> Optional[Request]:
        """Record one emitted token; finish the slot on EOS or budget."""
        task = self._tasks[slot]
        req = task.handle.request
        task.toks.append(token)
        task.budget -= 1
        self.stats["tokens_emitted"] += 1
        task.handle._append(token)
        if task.handle.on_token is not None:
            self._callbacks.append((task.handle.on_token, task.handle.uid,
                                    token))
        if (req.eos_id is not None and token == req.eos_id) \
                or task.budget <= 0:
            return self._finish(slot)
        return None

    def _finish(self, slot: int) -> Request:
        task = self._tasks[slot]
        req = task.handle.request
        req.output = np.asarray(task.toks, np.int32)
        self.done[req.uid] = req
        task.handle.status = "done"
        task.handle.finish_t = time.monotonic()
        self.active[slot] = False
        self._tasks[slot] = None
        self.kv.release(slot)
        self.scheduler.release(slot)
        return req
