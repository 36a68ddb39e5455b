"""Self-speculative decoding: a rank-truncated draft and a batched paged
verify, the port of ``repro.serve.speculative``.

NanoQuant's low-rank binary factors carry a free draft model: reading
the rank-r factors at r' < r is a cheaper approximate forward at no
extra storage. The draft is the same packed tensors read through
``eff_rank`` (``quant.surgery.rank_truncated_view``; the kernels read the
leading rank columns in place). The full-rank model verifies, so greedy
tokens equal the plain engine's by construction.

One engine tick is one cycle, a plain sequence of device calls with one
host read at its end:

1. **Draft**: k single-token decode steps through the truncated view,
   each feeding the previous step's argmax, which stays on the device.
   Draft KV lands in the slot's own pages at rows ``pos..pos+k-1``.
2. **Verify**: one full-rank decode step over ``[t_0, d_1..d_k]`` (S =
   k+1 queries at positions ``pos..pos+k``). It rewrites those rows with
   full-rank KV and gives the exact next token e_i after every prefix. A
   row written by a later query of the same call reconstructs to a
   negative position for every earlier query, so causality needs no new
   mask (``kernels.ref.paged_attention_ref``).
3. **Commit and rollback** on the host: a = the number of leading i with
   d_{i+1} == e_i; e_0..e_a are committed (a+1 tokens, at least 1, and
   e_0 is the plain engine's next token). Rows past the new frontier are
   never read, so rollback only returns the pages that hold nothing but
   rejected rows (``PagedKVState.trim``).

A committed token only attends to rows that hold the committed prefix,
all rewritten at full rank by the verify: hence identity, whatever the
draft proposes. The pool is written in place and inactive slots' tables
are all-zero, so their writes land on the null page; no select of the
active slots is needed.

A dynamic-k controller shrinks the draft length when acceptance drops
(an EMA of the batch's accepted fraction), so a poor draft degrades
toward plain decoding instead of wasting k rows per cycle.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.quant.surgery import rank_truncated_view

# dynamic k: shrink when the EMA of the per-cycle accepted fraction (a/k
# averaged over active slots) falls below _SHRINK_BELOW, grow above
# _GROW_ABOVE; the band between keeps k steady
_EMA_BETA = 0.2
_SHRINK_BELOW = 0.4
_GROW_ABOVE = 0.8


def check_config(scfg) -> None:
    """The ServeConfig conditions of speculative decoding; raises
    ValueError. The engine checks them before its own option checks (and
    before it builds the controller), so an unsupported combination names
    what speculation needs. What depends on the engine (a pool, its
    tables, the family) the controller's constructor refuses."""
    frac = scfg.spec_rank_frac
    if not (0.0 < frac <= 1.0):
        raise ValueError(f"spec_rank_frac must be in (0, 1], got {frac}")
    if scfg.spec_k < 1 or scfg.spec_k_min < 1 \
            or scfg.spec_k_min > scfg.spec_k:
        raise ValueError(
            f"need 1 <= spec_k_min <= spec_k, got "
            f"spec_k_min={scfg.spec_k_min} spec_k={scfg.spec_k}")
    if not scfg.greedy:
        raise ValueError(
            "speculative decoding requires greedy=True: the verify "
            "forward replays the draft deterministically, and token "
            "identity with the plain engine is only defined for greedy "
            "sampling")
    if not scfg.paged:
        raise ValueError(
            "speculative decoding requires the paged KV cache (draft "
            "tokens live in the slot's pages; rollback is page trimming)")


class SpecDecodeController:
    """Speculative decoding of one :class:`InferenceEngine`, built by the
    engine when ``ServeConfig.spec_rank_frac`` is set. Holds the
    zero-copy draft view, per-uid acceptance (``acceptance`` maps uid ->
    [accepted, drafted]) and the dynamic-k state; :meth:`tick` replaces
    the engine's single-token decode tick."""

    def __init__(self, engine):
        # what the engine decided (whether it built a pool, its tables),
        # refused in the reference's order
        scfg = engine.scfg
        if not engine.paged:
            raise ValueError(
                "speculative decoding requires the paged KV cache (draft "
                "tokens live in the slot's pages; rollback is page "
                "trimming): this family/config has none")
        if set(engine.kv.tables) != {"linear"}:
            raise ValueError(
                "speculative decoding supports linear page tables only "
                "(sliding-window ring pools wrap draft rows over committed "
                f"KV); got kinds {sorted(engine.kv.tables)}")
        if engine.cfg.is_ssm_layer_stack:
            raise ValueError(
                "speculative decoding is undefined for recurrent-state "
                "families: rejected drafts cannot be rolled out of an "
                "SSM/conv state by page trimming")
        if engine.cfg.family == "audio":
            raise ValueError("speculative decoding does not support "
                             "multi-codebook audio decode")
        self.engine = engine
        self.rank_frac = float(scfg.spec_rank_frac)
        self.k_min = int(scfg.spec_k_min)
        self.k_max = int(scfg.spec_k)
        self.k = self.k_max
        # every tensor of the view IS the engine's: no weight memory
        self.draft_params = rank_truncated_view(engine.params, self.rank_frac)
        self.acceptance: Dict[int, List[int]] = {}
        self._ema = None

    def acceptance_rate(self, uid=None) -> float:
        """Accepted / drafted over the engine's lifetime (or one uid)."""
        if uid is not None:
            a, d = self.acceptance.get(uid, (0, 0))
        else:
            a = sum(v[0] for v in self.acceptance.values())
            d = sum(v[1] for v in self.acceptance.values())
        return a / d if d else 0.0

    def _cycle(self, k: int, tokens, pos, tables):
        """k draft steps and the S = k+1 verify, all on the device.
        Returns (B, k+2) int64: the exact tokens e_0..e_k and, last, the
        accepted length a."""
        eng = self.engine
        tok, drafts = tokens, []
        for j in range(k):
            lg, eng.cache = T.decode_step(self.draft_params, eng.cfg, tok,
                                          eng.cache, pos + j,
                                          block_tables=tables)
            tok = lg[:, -1].float().argmax(dim=-1, keepdim=True)
            drafts.append(tok)
        drafts = torch.cat(drafts, dim=1)                        # (B, k)
        lg, eng.cache = T.decode_step(
            eng.params, eng.cfg, torch.cat([tokens, drafts], dim=1),
            eng.cache, pos, block_tables=tables)
        exact = lg.float().argmax(dim=-1)                       # (B, k+1)
        match = (drafts == exact[:, :k]).long()
        acc = torch.cumprod(match, dim=1).sum(dim=1, keepdim=True)
        return torch.cat([exact, acc], dim=1)

    def tick(self, finished) -> None:
        """The speculative decode tick: reserve k+1 rows per slot, run one
        cycle, read its result once, then commit and roll back on the
        host."""
        eng = self.engine
        # cap k so the verify's last row pos+k stays < max_len for every
        # active slot: the linear table covers max_len rows, and the
        # causality of the S > 1 read rests on no row wrapping
        k = self.k
        for s in np.nonzero(eng.active)[0]:
            k = min(k, eng.max_len - 1 - int(eng.pos[s]))
        if k < 1:
            # some slot is on its last row: no room to draft this tick
            eng._decode_tick(finished)
            return
        # reserve rows [0, pos+k+1) per slot: the cycle writes k+1 rows
        # before the host reads; a dry pool preempts the cheapest slot
        for s in np.nonzero(eng.active)[0]:
            while eng.active[s] and not eng._reserve_decode_rows(
                    int(s), int(eng.pos[s]) + k + 1):
                eng._preempt(eng._select_victim())
        if not eng.active.any():
            return
        slots = np.nonzero(eng.active)[0]
        if eng.faults is not None:
            # raises before the cycle enqueues its first kernel: the pool
            # is intact, and the engine fails the target and resumes the
            # other slots
            eng.faults.before_decode(eng)
        dev = eng.device
        out = self._cycle(k, torch.from_numpy(eng.tokens).to(dev),
                          torch.from_numpy(eng.pos).to(dev),
                          eng.kv.device_tables(dev))
        out = out.cpu().numpy()                 # the cycle's one host read
        exact, acc = out[:, :-1], out[:, -1]
        if eng.faults is not None:
            # a cancel inside the cycle: the commit and trim below still
            # run (it is honoured at the next tick boundary), so rollback
            # accounting must stay exact for a doomed slot
            eng.faults.on_spec_cycle(eng)
        eng.stats["decode_steps"] += 1
        eng.stats["spec_cycles"] += 1
        eng.stats["wasted_slot_steps"] += int(eng.max_batch - len(slots))
        accept_fracs = []
        for s in slots:
            s = int(s)
            a = int(acc[s])
            accept_fracs.append(a / k)
            eng.stats["spec_draft_tokens"] += k
            eng.stats["spec_accepted_tokens"] += a
            eng.stats["spec_rollback_tokens"] += k - a
            rec = self.acceptance.setdefault(eng._tasks[s].handle.uid, [0, 0])
            rec[0] += a
            rec[1] += k
            committed = 0
            for i in range(a + 1):
                eng.pos[s] += 1
                committed += 1
                fin = eng._emit(s, int(exact[s, i]))
                if fin is not None:       # EOS or budget: slot released
                    finished.append(fin)
                    break
            if eng.active[s]:
                # the next cycle feeds the last committed token at pos
                eng.tokens[s, 0] = exact[s, committed - 1]
                # rollback: pages past the committed frontier go back
                eng.stats["spec_rollback_pages"] += eng.kv.trim(
                    s, int(eng.pos[s]))
        if accept_fracs:
            f = sum(accept_fracs) / len(accept_fracs)
            self._ema = f if self._ema is None else \
                (1 - _EMA_BETA) * self._ema + _EMA_BETA * f
            if self._ema < _SHRINK_BELOW and self.k > self.k_min:
                self.k -= 1
            elif self._ema > _GROW_ABOVE and self.k < self.k_max:
                self.k += 1
