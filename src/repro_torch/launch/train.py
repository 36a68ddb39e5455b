"""Training CLI, the port of ``repro.launch.train``: train an arch's FP
model on the synthetic corpus with periodic atomic checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

The published config by default (``--smoke``: the reduced one), on
``--device`` (``cuda`` by default; nothing falls back to the CPU). With
``--ckpt-dir`` a rerun resumes from the latest checkpoint, its data
stream started at that step (deterministic data skip); under
``launch/supervisor.py`` a crash restarts and resumes the same way.
``--grad-accum N`` splits each (batch, seq) batch into N microbatches of
batch / N rows (the train step takes them pre-split). ``--mesh
single|multi`` (a sharded run) waits for ROADMAP item 12c.
"""
from __future__ import annotations

import argparse
import sys


def split_batches(it, accum: int):
    """Each batch of `it` pre-split for a ``grad_accum = accum`` step:
    every leaf (B, ...) as (accum, B / accum, ...)."""
    for b in it:
        yield {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
               for k, v in b.items()}


def build_trainer(args):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import train_iterator
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(lr=args.lr, warmup=args.warmup,
                       total_steps=args.steps, grad_accum=args.grad_accum,
                       compress_grads=args.compress_grads, seed=args.seed)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    # resume-aware deterministic iterator: peek the checkpoint step first
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
    it = train_iterator(cfg, batch=args.batch, seq=args.seq, seed=args.seed,
                        start_step=start)
    if args.grad_accum > 1:
        it = split_batches(it, args.grad_accum)
    return Trainer(cfg, tcfg, it, mgr, ckpt_every=args.ckpt_every,
                   log_every=args.log_every, device=args.device)


def main(argv=None):
    from repro_torch.configs import list_archs

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)
    if args.mesh != "none":
        ap.error(f"--mesh {args.mesh} needs the sharded trainer, which the "
                 f"port does not have yet (ROADMAP item 12c)")
    if args.grad_accum > 1 and args.batch % args.grad_accum:
        ap.error(f"--grad-accum {args.grad_accum} splits each batch into "
                 f"equal microbatches: --batch {args.batch} is not a "
                 f"multiple of it")

    tr = build_trainer(args)
    tr.restore_or_init()
    remaining = args.steps - tr.step
    if remaining <= 0:
        print(f"[train] already at step {tr.step} >= {args.steps}")
        return
    metrics = tr.run(remaining)
    print(f"[train] done at step {tr.step}: {metrics}")
    if tr.device.type == "cuda":
        import torch
        print(f"[train] peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
