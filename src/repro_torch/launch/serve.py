"""Serving driver: batched generation from a packed model artifact, the
port of ``repro.launch.serve``, on the paged pool or (``--rect``) on the
reference's rectangular KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --quantized-ckpt /ckpt/nq --requests 16 --max-new 32

A ``--quantized-ckpt`` directory (a ``NanoQuantModel`` artifact, written
by either package's ``save``) is self-describing: its manifest carries
the model config. Without one, the CLI quantizes a demo teacher, as the
reference's does (:func:`demo_model`): ``--arch``'s smoke config
(llama3.2-1b by default; any arch of ``repro_torch.configs``,
qwen3-moe-235b-a22b's MoE, deepseek-v2-lite-16b's MLA, mamba2-370m's SSM,
zamba2-1.2b's hybrid, llama-3.2-vision-90b's VLM and musicgen-medium's
audio among them) in its own dtype, drawn by ``init_params`` from seed 0
and quantized on 8 calibration sequences of 64 tokens at a short budget;
``--fp`` serves that FP teacher instead (and ignores any artifact). The
pool line gives the pool's bytes per token. A family with nothing to
page (SSM) is served on its per-slot state cache, and the pool line
reports that layout instead; the hybrid's line gives its ring pages per
slot and its per-slot state beside the pool, the VLM's its image K/V
bytes per slot beside the pool (a request carries no image: they stay
zero, as in the reference's engine). ``--rect`` serves any family on the
rectangle (``ServeConfig(paged=False)``, the reference's identity
oracle: no prefix cache, and ``--spec-rank-frac`` refused), and the line
gives the rectangle's bytes instead. The audio family's prompts are
``--prompt-len`` frames of ``n_codebooks`` ids; ``--shared-prefix``
refuses them, as the reference's CLI does.
The engine runs on ``--device`` (``cuda`` by default; nothing falls back
to the CPU).

Crash-restart serving: ``--supervise`` re-execs this driver under
``launch/supervisor.py`` with hang detection keyed to the per-tick
``[serve] heartbeat`` lines (printed by the serving loop itself, so a
wedged device call stops them and the process is killed and restarted),
and ``--snapshot PATH`` persists the host-side resume state every
``--snapshot-every`` ticks: a restarted process resumes the interrupted
requests (token-identically under greedy decoding). On a CUDA card this
is the recovery from a real device fault, which leaves the process's
CUDA context unusable. ``--crash-at-step N`` snapshots and exits with
code 7 at tick N, to exercise the loop.

Tensor-parallel serving: ``--tp N`` starts N ranks
(``launch.mesh.run_ranks``) over ``--tp-backend`` (``nccl``, one card per
rank, an error with fewer cards; or ``gloo``, every rank on ``--device``,
one card shared or the CPU, its collectives staged through host memory).
The model is made once (loaded, or the demo quantized) and saved as an
artifact in a temporary directory that each rank loads; each rank serves
its shards of it over a ``(data=1, model=N)`` mesh, and only rank 0
prints, starting with a line that gives the backend, the ranks' devices
and the mesh. Every family serves so: an MoE's routed experts are split
E / N per rank (expert-parallel), the audio family's codebook tables on
their vocabulary, a Mamba2 mixer (the SSM and hybrid families) by SSD
head, the hybrid's shared block and the VLM's self and cross layers by
attention head (the VLM's per-slot image K/V by kv head). Deadlines,
snapshots and ``--supervise`` read one process's clock or plan and are
refused with ``--tp`` (ROADMAP item 12d).
``--rect --tp N`` gives each rank its rectangle of kv heads, split with
the query heads where they divide the model axis and whole where they do
not (``quant.surgery.kv_layout``; MLA's latent rectangle whole; the
Mamba2 state of the rank's SSD heads).
``--engine wave`` admits a new batch only once every slot is free (the
deprecated ``BatchServer``'s admission).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def demo_model(arch: str, fp: bool = False, device="cuda"):
    """The reference CLI's demo model: `arch`'s smoke config, its teacher
    ``init_params`` from seed 0, quantized on ``calib_batches(cfg, 8,
    64)`` under ``QuantConfig(admm_iters=10, t_pre=5, t_post=5, t_glob=5,
    rank_align=32)``; with `fp` the teacher itself (``from_fp``)."""
    import torch
    from repro_torch import resolve_device
    from repro_torch.api import NanoQuantModel
    from repro_torch.configs import get_smoke
    from repro_torch.core.pipeline import QuantConfig
    from repro_torch.data.synthetic import calib_batches
    from repro_torch.models import transformer as T
    cfg = get_smoke(arch)
    device = resolve_device(device)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    if fp:
        return NanoQuantModel.from_fp(params, cfg)
    qcfg = QuantConfig(admm_iters=10, t_pre=5, t_post=5, t_glob=5,
                       rank_align=32)
    return NanoQuantModel.quantize(params, cfg, calib_batches(cfg, 8, 64),
                                   qcfg, verbose=False, device=device)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quantized-ckpt", default="",
                    help="NanoQuantModel artifact; if empty, quantizes "
                         "--arch's smoke teacher (demo)")
    ap.add_argument("--fp", action="store_true",
                    help="serve the FP teacher instead (baseline)")
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="without an artifact: the arch whose smoke "
                         "teacher is quantized (or, with --fp, served)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--rect", action="store_true",
                    help="serve on the legacy rectangular KV pool "
                         "instead of the paged pool (the identity "
                         "oracle; see docs/serving.md)")
    ap.add_argument("--engine", choices=("continuous", "wave"),
                    default="continuous",
                    help="admission: continuous batching, or a new batch "
                         "only once every slot is free (the deprecated "
                         "BatchServer)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: serve over a (data=1, "
                         "model=N) mesh of N ranks (every family; an "
                         "MoE's experts split E/N per rank, a Mamba2 "
                         "mixer's SSD heads H/N)")
    ap.add_argument("--tp-backend", choices=("nccl", "gloo"),
                    default="nccl",
                    help="--tp's process group: nccl (one card per rank) "
                         "or gloo (every rank on --device)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="KV rows per page of the paged pool")
    ap.add_argument("--kv-pool-pages", type=int, default=0,
                    help="total pool pages; 0 = full capacity, smaller "
                         "overcommits (admission queues on free pages)")
    ap.add_argument("--spec-rank-frac", type=float, default=0.0,
                    help="self-speculative decoding: draft through a "
                         "rank-truncated view at this rank fraction, "
                         "verify at full rank (forces greedy sampling)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per speculative cycle")
    ap.add_argument("--no-prefix", action="store_true",
                    help="disable the prefix cache (shared prompt-prefix "
                         "KV pages; on by default)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens "
                         "to every request (prefix-cache page sharing)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request deadline in seconds (0 = none); "
                         "requests past it finish 'expired'")
    ap.add_argument("--snapshot", default="",
                    help="resume-state file: loaded on start if it exists "
                         "(crash recovery), refreshed every "
                         "--snapshot-every ticks, removed on a clean "
                         "finish")
    ap.add_argument("--snapshot-every", type=int, default=32,
                    help="ticks between snapshot refreshes")
    ap.add_argument("--heartbeat-every", type=int, default=16,
                    help="ticks between '[serve] heartbeat' lines (what "
                         "--supervise hang detection watches; 0 disables)")
    ap.add_argument("--crash-at-step", type=int, default=0,
                    help="testing: snapshot then exit(7) at this tick "
                         "(fresh runs only: a resumed process runs to "
                         "completion)")
    ap.add_argument("--supervise", action="store_true",
                    help="run under launch/supervisor.py: restart on "
                         "crash, kill and restart on missing heartbeats, "
                         "resume from --snapshot")
    ap.add_argument("--hang-timeout", type=float, default=60.0,
                    help="--supervise: seconds without a heartbeat before "
                         "the child is declared hung")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="--supervise: restart budget")
    return ap


def main(argv=None):
    """Run the CLI on `argv` (default ``sys.argv[1:]``); returns the
    finished requests' output tokens by uid."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = _parser()
    args = ap.parse_args(argv)
    if args.spec_rank_frac and args.rect:
        ap.error("--spec-rank-frac needs the paged KV pool; drop --rect")
    if args.tp > 1:
        clocked = [f for f, on in (("--supervise", args.supervise),
                                   ("--snapshot", args.snapshot),
                                   ("--deadline", args.deadline),
                                   ("--crash-at-step", args.crash_at_step))
                   if on]
        if clocked:
            ap.error(f"{', '.join(clocked)} read one process's clock or "
                     f"snapshot and are refused with --tp (ROADMAP item 12d)")
        from repro_torch.launch.mesh import check_backend, under_torchrun
        try:
            check_backend(args.tp_backend, args.tp)
        except RuntimeError as e:
            ap.error(str(e))
        if under_torchrun() and int(os.environ["RANK"]):
            sys.stdout = open(os.devnull, "w")      # only rank 0 prints

    if args.supervise:
        from repro_torch.launch import supervisor
        if not args.snapshot:
            ap.error("--supervise needs --snapshot to resume across "
                     "restarts")
        cmd = [sys.executable, "-m", "repro_torch.launch.serve"] \
            + [a for a in argv if a != "--supervise"]
        raise SystemExit(supervisor.supervise(
            cmd, max_restarts=args.max_restarts,
            hang_timeout=args.hang_timeout,
            heartbeat_pattern=r"\[serve\] heartbeat"))

    from repro_torch.api import NanoQuantModel

    if args.quantized_ckpt and not args.fp:
        model = NanoQuantModel.load(args.quantized_ckpt, device=args.device)
        bpw = model.quant.get("target_bpw", 1.0) if model.quantized else 16
        print(f"[serve] loaded artifact {args.quantized_ckpt} "
              f"(arch={model.cfg.name}, bpw={bpw})", flush=True)
    else:
        model = demo_model(args.arch, args.fp, args.device)
        print(f"[serve] {model.cfg.name} ({model.cfg.dtype}) teacher from "
              f"seed 0", flush=True)
        print("[serve] FP random-init teacher (--fp)" if args.fp else
              "[serve] quantized random-init teacher (demo)", flush=True)

    if args.shared_prefix and model.cfg.family == "audio":
        ap.error("--shared-prefix does not support audio prompts")
    if args.tp == 1:
        return _serve(args, model)
    import tempfile
    from repro_torch.launch.mesh import run_ranks
    with tempfile.TemporaryDirectory(prefix="nq-serve-tp-") as tmp:
        art = model.save(os.path.join(tmp, "model"))
        del model
        out = run_ranks(_serve_rank, args.tp, args.tp_backend,
                        args=(argv, art), workdir=tmp)
    # under torchrun this process is one rank: rank 0's outputs where it
    # runs, None on the others
    return out.get(0)


def _serve_rank(rank: int, argv, artifact: str):
    """One rank of ``--tp``: load the artifact on this rank's device,
    serve its shards over the mesh; only rank 0 prints."""
    import torch.distributed as dist
    from repro_torch.api import NanoQuantModel
    from repro_torch.launch.mesh import make_serving_mesh
    args = _parser().parse_args(argv)
    if rank:
        sys.stdout = open(os.devnull, "w")
    # nccl: the mesh's own choice, cuda:LOCAL_RANK under torchrun
    mesh = make_serving_mesh(
        args.tp, device=None if args.tp_backend == "nccl" else args.device)
    devices = [None] * args.tp
    dist.all_gather_object(devices, str(mesh.device), group=mesh.group)
    shared = len(set(devices)) == 1 and mesh.device.type == "cuda"
    print(f"[serve] tensor-parallel: {args.tp} ranks over "
          f"{mesh.backend} on {devices}, mesh {mesh.shape}"
          + ("; the ranks share one device, their collectives staged "
             "through host memory" if shared else ""), flush=True)
    return _serve(args, NanoQuantModel.load(artifact, device=mesh.device),
                  mesh)


def _serve(args, model, mesh=None):
    """The serving loop over `model` (this rank's shards under `mesh`)."""
    from repro_torch.serve import recovery
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import Request
    cfg = model.cfg
    spec = args.spec_rank_frac or None
    scfg = ServeConfig(max_new_tokens=args.max_new, paged=not args.rect,
                       page_size=args.page_size,
                       kv_pool_pages=args.kv_pool_pages or None,
                       greedy=bool(spec), spec_rank_frac=spec,
                       spec_k=args.spec_k, prefix_cache=not args.no_prefix)
    if spec:
        print(f"[serve] speculative decode: rank_frac={spec} "
              f"k<={args.spec_k} (greedy sampling forced)")
    eng = model.engine(scfg, max_batch=args.max_batch,
                       max_len=(args.shared_prefix + args.prompt_len
                                + args.max_new),
                       admission=args.engine, mesh=mesh)
    del model                           # a rank keeps its shards only
    rng = np.random.default_rng(0)
    # a prompt of tokens, or the audio family's frames of n_codebooks ids
    shape = ((args.prompt_len, cfg.n_codebooks)
             if cfg.family == "audio" else (args.prompt_len,))
    sys_prompt = None
    if args.shared_prefix:
        sys_prompt = rng.integers(0, cfg.vocab_size,
                                  size=args.shared_prefix).astype(np.int64)
    t0 = time.time()
    resumed = args.snapshot and os.path.exists(args.snapshot)
    if resumed:
        snap = recovery.load_snapshot(args.snapshot)
        handles = list(recovery.restore(eng, snap).values())
        print(f"[serve] resumed {len(handles)} in-flight requests from "
              f"{args.snapshot}", flush=True)
    else:
        handles = []
        for uid in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size,
                                  size=shape).astype(np.int64)
            if sys_prompt is not None:
                prompt = np.concatenate([sys_prompt, prompt])
            handles.append(eng.submit(Request(
                uid, prompt, max_new_tokens=args.max_new,
                deadline_s=args.deadline or None)))
    # a manual step loop, not eng.run(): the heartbeat must come from
    # inside the serving loop (a thread would keep beating while a device
    # call is wedged, the hang the supervisor exists to catch)
    while eng.in_flight:
        eng.step()
        tick = eng.stats["steps"]
        if args.heartbeat_every and tick % args.heartbeat_every == 0:
            print(f"[serve] heartbeat step={tick} "
                  f"active={int(eng.active.sum())} "
                  f"queued={len(eng.scheduler.pending)}", flush=True)
        if args.snapshot and args.snapshot_every \
                and tick % args.snapshot_every == 0 and eng.in_flight:
            recovery.save_snapshot(eng, args.snapshot)
        if args.crash_at_step and not resumed \
                and tick >= args.crash_at_step:
            if args.snapshot:
                recovery.save_snapshot(eng, args.snapshot)
            print(f"[serve] injected crash at step {tick}", flush=True)
            sys.exit(7)
    done = dict(eng.done)
    if args.snapshot and os.path.exists(args.snapshot):
        os.unlink(args.snapshot)           # clean finish: nothing to resume
    dt = time.time() - t0
    n_tok = sum(len(r.output) for r in done.values())
    n_term = {s: eng.stats[s] for s in ("cancelled", "expired", "failed")
              if eng.stats[s]}
    print(f"[serve] engine={args.engine} on {eng.device}: {len(done)} "
          f"requests, {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s)"
          + (f", non-done terminals {n_term}" if n_term else ""))
    lats = np.asarray(sorted(h.latency for h in handles if h.done))
    if lats.size:
        print(f"[serve] request latency: mean {lats.mean():.2f}s  "
              f"p50 {np.percentile(lats, 50):.2f}s  "
              f"p95 {np.percentile(lats, 95):.2f}s")
    print(f"[serve] decode steps {eng.stats['decode_steps']}, wasted "
          f"slot-steps {eng.stats['wasted_slot_steps']}")
    _print_pool_stats(eng)
    if eng.spec is not None:
        st = eng.stats
        print(f"[serve] speculative: {st['spec_cycles']} cycles, "
              f"acceptance {eng.spec.acceptance_rate():.2f} "
              f"({st['spec_accepted_tokens']}/{st['spec_draft_tokens']} "
              f"draft tokens), {st['spec_rollback_tokens']} rolled "
              f"back ({st['spec_rollback_pages']} pages trimmed), "
              f"final k={eng.spec.k}")
    if done:
        first = min(done)
        print(f"[serve] sample output for request {first}: "
              f"{done[first].output[:16]}", flush=True)
    return {uid: r.output for uid, r in done.items()}


def _print_pool_stats(eng) -> None:
    """The pool line for each cache layout: an engine without a paged
    pool (``--rect``, or a family with nothing to page, the SSM state)
    has no allocator to report on, and gives the rectangle's bytes (the
    reference's line) or the state cache's; the hybrid's pool of ring
    pages holds its per-slot state beside it, the VLM's pool its per-slot
    image K/V."""
    if eng.kv is None:
        kv = eng.kv_cache_bytes()
        state = eng.cache_bytes() - kv
        if kv:
            print(f"[serve] rectangular layout (paging disabled): "
                  f"{eng.max_batch} x {eng.max_len} KV rectangle, "
                  f"{kv / 2**20:.2f} MiB"
                  + (f", per-slot state of {eng.max_batch} slots beside it "
                     f"({state / 2**20:.2f} MiB)" if state else ""))
            return
        print(f"[serve] rectangular layout (paging disabled): per-slot "
              f"state cache of {eng.max_batch} slots "
              f"({eng.cache_bytes() / 2**20:.2f} MiB), KV "
              f"{kv / 2**20:.2f} MiB")
        return
    ring = ""
    pool = eng.kv_cache_bytes()
    if eng.kv.has_ring:
        state = eng.cache_bytes() - eng.kv_cache_bytes()
        ring = (f", {eng.kv.ring_pages} ring pages per slot, per-slot "
                f"state of {eng.max_batch} slots "
                f"({state / 2**20:.2f} MiB)")
    if "cross_kv" in eng.cache:
        image = sum(t.numel() * t.element_size()
                    for t in eng.cache["cross_kv"].values())
        pool -= image
        ring = (f", per-slot image K/V of {eng.max_batch} slots beside it "
                f"({image // eng.max_batch} bytes per slot)")
    rows = eng.kv.n_pages * eng.kv.page_size
    print(f"[serve] paged KV pool: {eng.kv.n_pages} pages x "
          f"{eng.kv.page_size} rows ({pool / 2**20:.2f} MiB, "
          f"{pool // rows} bytes per token){ring}, peak "
          f"{eng.kv.peak_used_pages} pages in use, "
          f"{eng.stats['page_waits']} page waits, "
          f"{eng.stats['preemptions']} preemptions")
    if eng.prefix is not None:
        st = eng.stats
        rate = (st["prefix_hit_tokens"] / st["prefix_lookup_tokens"]
                if st["prefix_lookup_tokens"] else 0.0)
        print(f"[serve] prefix cache: hit rate {rate:.2f} "
              f"({st['prefix_hit_tokens']}/{st['prefix_lookup_tokens']} "
              f"prompt tokens served from shared pages), peak "
              f"{st['shared_pages']} shared pages, "
              f"{st['cow_copies']} COW copies, "
              f"{st['evicted_pages']} cached pages evicted")


if __name__ == "__main__":
    main()
