"""Quantization CLI, the port of ``repro.launch.quantize`` for every
family: train (or resume) the FP teacher, check the inputs
(``quant.preflight``), run the NanoQuant pipeline through
``NanoQuantModel.quantize``, save the packed artifact and report sizes
and perplexities.

    PYTHONPATH=src python -m repro_torch.launch.quantize --arch llama3.2-1b \
        --bpw 1.0 --teacher-steps 150 --out /tmp/nq
    PYTHONPATH=src python -m repro_torch.launch.serve --quantized-ckpt /tmp/nq

The teacher is the smoke config by default, the published one with
``--full``, trained on the synthetic corpus for ``--teacher-steps``
(150, the reference's recipe: ``TrainConfig(lr=1e-3, warmup=20)``, 8
sequences of ``--calib-seq`` tokens a step) from ``init_params`` of seed
0; ``--teacher-steps 0`` quantizes that draw untrained. With
``--teacher-ckpt DIR`` the teacher resumes from DIR's latest checkpoint
(either package's ``Trainer`` writes them), trains only the steps it
lacks, its data stream started at that step, and saves its last step
there: a rerun trains nothing. The run is on ``--device`` (``cuda`` by
default; nothing falls back to the CPU).

Fault tolerance: ``--journal-dir`` makes the run crash-safe (a per-block
journal, ``checkpoint.journal``); ``--resume`` picks a killed run up from
its journal and gives a bit-identical artifact. ``--supervise`` re-runs
this CLI under ``launch/supervisor.py``, restarting it on a crash and
on missing ``[quant] heartbeat`` lines; a restarted child gets
``--resume``. ``--crash-at-block N`` injects one crash when block N
starts, on the first attempt only (a restart drill).

The VLM's calibration and evaluation batches carry seeded image
embeddings (``data.synthetic.make_batch``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HEARTBEAT_RE = r"\[quant\] heartbeat"


def train_teacher(cfg, steps: int, seq: int, ckpt_dir: str = "",
                  device="cuda", log=print):
    """The FP teacher of the reference CLI's recipe: `cfg`'s
    ``init_params`` (seed 0) trained by ``train.Trainer`` for `steps`
    steps under ``TrainConfig(lr=1e-3, warmup=20, total_steps=steps)`` on
    ``train_iterator(cfg, 8, seq)``. With `ckpt_dir` it resumes from the
    directory's latest step (the data stream started there), trains only
    the steps it lacks and saves its last step. Returns (params, {"step",
    "trained_steps", "crc32"}: the teacher's step, the steps trained
    here, the crc32 of its leaves)."""
    from repro_torch.checkpoint.journal import _crc_leaves
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data import train_iterator
    from repro_torch.train import TrainConfig, Trainer

    tcfg = TrainConfig(lr=1e-3, warmup=20, total_steps=steps)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = (mgr.latest_step() or 0) if mgr is not None else 0
    tr = Trainer(cfg, tcfg, train_iterator(cfg, 8, seq, start_step=start),
                 mgr, log_every=25, log_fn=log, device=device)
    tr.restore_or_init()
    trained = max(0, steps - tr.step)
    tr.run(trained)
    if mgr is not None and trained and tr.step % tr.ckpt_every:
        mgr.save(tr.step, tr.state)
    params = tr.state[0]
    return params, {"step": tr.step, "trained_steps": trained,
                    "crc32": _crc_leaves(params)}


def main(argv=None):
    from repro_torch.configs import get_config, get_smoke, list_archs

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--full", action="store_true",
                    help="the full published config (needs the card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--bpw", type=float, default=1.0)
    ap.add_argument("--init-method", default="lb_admm")
    ap.add_argument("--fallback-inits", default="dbf_admm,dual_svid",
                    help="comma-separated init-method ladder tried when "
                         "a block diverges ('' disables fallbacks)")
    ap.add_argument("--calib-samples", type=int, default=16)
    ap.add_argument("--calib-seq", type=int, default=128)
    ap.add_argument("--out", default="")
    ap.add_argument("--rank-align", type=int, default=32)
    # pipeline budget knobs (CPU smoke runs use tiny values)
    ap.add_argument("--admm-iters", type=int, default=40)
    ap.add_argument("--t-pre", type=int, default=40)
    ap.add_argument("--t-post", type=int, default=60)
    ap.add_argument("--t-glob", type=int, default=60)
    # fault tolerance
    ap.add_argument("--journal-dir", default="",
                    help="per-block progress journal dir (enables "
                         "--resume and supervised restarts)")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed run from --journal-dir "
                         "(bit-identical artifact)")
    ap.add_argument("--no-preflight", action="store_true",
                    help="skip input validation (calib/params/memory)")
    ap.add_argument("--heartbeat", action="store_true",
                    help="print '[quant] heartbeat ...' per block (what "
                         "--supervise hang detection watches)")
    ap.add_argument("--supervise", action="store_true",
                    help="run under launch/supervisor.py: restart on "
                         "crash, kill+restart on missing heartbeats, "
                         "children resume from --journal-dir")
    ap.add_argument("--hang-timeout", type=float, default=600.0,
                    help="--supervise: seconds without a heartbeat "
                         "before the child is declared hung")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="--supervise: restart budget")
    ap.add_argument("--crash-at-block", type=int, default=-1,
                    help="inject one crash when this block starts, "
                         "first attempt only (restart drill)")
    ap.add_argument("--teacher-steps", type=int, default=150)
    ap.add_argument("--teacher-ckpt", default="",
                    help="resume the teacher from (and save it to) this "
                         "checkpoint directory")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    if args.resume and not args.journal_dir:
        ap.error("--resume needs --journal-dir")

    if args.supervise:
        from repro_torch.launch import supervisor
        if not args.journal_dir:
            ap.error("--supervise needs --journal-dir so restarted "
                     "children can resume instead of redoing everything")
        child = [a for a in argv if a != "--supervise"]
        for extra in ("--resume", "--heartbeat"):
            if extra not in child:
                child.append(extra)
        raise SystemExit(supervisor.supervise(
            [sys.executable, "-m", "repro_torch.launch.quantize"] + child,
            max_restarts=args.max_restarts,
            hang_timeout=args.hang_timeout,
            heartbeat_pattern=HEARTBEAT_RE))

    from repro_torch import resolve_device
    from repro_torch.api import NanoQuantModel
    from repro_torch.api.init_methods import list_init_methods
    from repro_torch.checkpoint.journal import QuantJournal
    from repro_torch.core.pipeline import QuantConfig
    from repro_torch.data.synthetic import SyntheticCorpus, calib_batches
    from repro_torch.quant.faults import QuantFault, QuantFaultPlan
    from repro_torch.quant.preflight import preflight

    if args.init_method not in list_init_methods():
        ap.error(f"unknown init method {args.init_method!r}; available: "
                 f"{list_init_methods()}")
    device = resolve_device(args.device)
    params, teacher = train_teacher(cfg, args.teacher_steps, args.calib_seq,
                                    args.teacher_ckpt, device)
    print(f"[quantize] teacher at step {teacher['step']}: "
          f"{teacher['trained_steps']} steps trained in this run"
          + (f" (checkpoints in {args.teacher_ckpt})"
             if args.teacher_ckpt else ""), flush=True)
    corpus = SyntheticCorpus(cfg.vocab_size)
    calib = calib_batches(cfg, args.calib_samples, args.calib_seq,
                          corpus=corpus)
    evalb = calib_batches(cfg, 8, args.calib_seq, seed=99, corpus=corpus)

    # ---- preflight (fail fast, not at block 17) ----------------------------
    if not args.no_preflight:
        pf = preflight(params, cfg, calib)
        print(f"[quantize] preflight ok: {pf['n_batches']} batches, "
              f"{pf['n_calib_tokens']} calib tokens, "
              f"~{pf['est_block_bytes'] / 2**20:.0f} MiB/block of "
              f"{pf['available_bytes'] / 2**20:.0f} MiB free on "
              f"{pf['device']}", flush=True)

    ppl_fp = NanoQuantModel.from_fp(params, cfg).perplexity(evalb)

    # ---- fault injection drill ---------------------------------------------
    faults = None
    if args.crash_at_block >= 0:
        # fire only on the first attempt (journal still empty), so that a
        # supervised restart makes progress instead of crashing again
        already = (QuantJournal(args.journal_dir).n_completed_blocks()
                   if args.journal_dir else 0)
        if already == 0:
            faults = QuantFaultPlan([QuantFault(block=args.crash_at_block,
                                                kind="crash_block")])

    heartbeat = None
    if args.heartbeat:
        def heartbeat(msg):
            print(f"[quant] heartbeat {msg}", flush=True)

    qcfg = QuantConfig(target_bpw=args.bpw, rank_align=args.rank_align,
                       init_method=args.init_method,
                       fallback_inits=args.fallback_inits,
                       admm_iters=args.admm_iters, t_pre=args.t_pre,
                       t_post=args.t_post, t_glob=args.t_glob)
    model = NanoQuantModel.quantize(
        params, cfg, calib, qcfg, device=device,
        journal_dir=args.journal_dir or None, resume=args.resume,
        faults=faults, heartbeat=heartbeat)
    ppl_q = model.perplexity(evalb)

    sizes = model.size_report()
    print(f"\n[quantize] {cfg.name} target_bpw={args.bpw} on {device}")
    print(f"  FP teacher ppl   : {ppl_fp:.3f}")
    print(f"  NanoQuant ppl    : {ppl_q:.3f}")
    print(f"  linears bpw      : {sizes['linears_bpw']:.3f}")
    print(f"  wall time        : {model.report['wall_s']:.1f}s")
    if args.out:
        model.save(args.out)
        with open(os.path.join(args.out, "report.json"), "w") as f:
            json.dump({"ppl_fp": ppl_fp, "ppl_q": ppl_q, "sizes": sizes,
                       "teacher": teacher,
                       "ranks": model.ranks,
                       "wall_s": model.report["wall_s"],
                       "quant_config": dataclasses.asdict(qcfg)},
                      f, indent=1)
        print(f"  saved to {args.out}")


if __name__ == "__main__":
    main()
