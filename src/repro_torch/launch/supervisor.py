"""Fault-tolerance supervisor, the port of ``repro.launch.supervisor``:
bounded restarts and hang detection for any command (standard library
only).

    PYTHONPATH=src python -m repro_torch.launch.supervisor \
        --max-restarts 3 --hang-timeout 120 -- \
        python -m repro_torch.launch.serve --snapshot /tmp/snap.json ...

Policy:

- the child exits 0          -> done.
- the child exits nonzero    -> restart with exponential backoff, up to
                                --max-restarts; the child resumes from
                                its own snapshot or checkpoint.
- no stdout progress within --hang-timeout seconds -> the child is
  declared hung, SIGKILLed, and restarted (same budget).

By default any stdout line counts as progress. For a child whose output
can be chatty while its work loop is wedged (a server logging while a
device call never returns), ``--heartbeat-regex`` makes only matching
lines reset the hang timer. ``launch/serve.py --supervise`` wires this
to its per-tick ``[serve] heartbeat`` lines, so a wedged decode step is
killed and restarted (and resumes from its ``--snapshot`` file). On a
CUDA card this is also the recovery from a real device fault, which
leaves the process's CUDA context unusable.

``run_with_restarts`` is the in-process variant.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import threading
import time
from typing import Callable, Optional


def run_with_restarts(fn: Callable[[int], None], max_restarts: int = 3,
                      backoff_s: float = 0.0, log=print) -> int:
    """In-process restart loop: fn(attempt) is retried on exception.
    Returns the number of restarts used. Raises after budget exhaustion."""
    attempt = 0
    while True:
        try:
            fn(attempt)
            return attempt
        except Exception as e:  # noqa: BLE001
            attempt += 1
            if attempt > max_restarts:
                log(f"[supervisor] giving up after {max_restarts} restarts")
                raise
            log(f"[supervisor] attempt {attempt} failed ({e!r}); "
                f"restarting in {backoff_s * attempt:.1f}s")
            time.sleep(backoff_s * attempt)


class _Pump(threading.Thread):
    """Forward child output and timestamp progress for hang detection.
    With `heartbeat_pattern`, only matching lines count as progress —
    chatty logging from a wedged child cannot mask the hang."""

    def __init__(self, pipe, sink, heartbeat_pattern: Optional[str] = None):
        super().__init__(daemon=True)
        self.pipe, self.sink = pipe, sink
        self.pattern = (re.compile(heartbeat_pattern)
                        if heartbeat_pattern else None)
        self.last_progress = time.time()

    def run(self):
        for line in iter(self.pipe.readline, b""):
            text = line.decode(errors="replace")
            if self.pattern is None or self.pattern.search(text):
                self.last_progress = time.time()
            self.sink.write(text)
            self.sink.flush()


def supervise(cmd, max_restarts: int = 3, hang_timeout: float = 0.0,
              backoff_s: float = 2.0, log=print,
              heartbeat_pattern: Optional[str] = None) -> int:
    restarts = 0
    while True:
        log(f"[supervisor] launching (attempt {restarts + 1}): "
            f"{' '.join(cmd)}")
        child = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
        pump = _Pump(child.stdout, sys.stdout, heartbeat_pattern)
        pump.start()
        hung = False
        while True:
            try:
                rc = child.wait(timeout=5.0)
                break
            except subprocess.TimeoutExpired:
                if (hang_timeout
                        and time.time() - pump.last_progress > hang_timeout):
                    log(f"[supervisor] no progress for {hang_timeout}s — "
                        f"straggler/hang, killing pid {child.pid}")
                    child.kill()
                    child.wait()
                    rc, hung = -9, True
                    break
        if rc == 0:
            log("[supervisor] child finished cleanly")
            return 0
        restarts += 1
        if restarts > max_restarts:
            log(f"[supervisor] restart budget ({max_restarts}) exhausted")
            return rc if rc else 1
        wait = backoff_s * (2 ** (restarts - 1))
        log(f"[supervisor] child {'hung' if hung else f'exited rc={rc}'}; "
            f"restart {restarts}/{max_restarts} in {wait:.0f}s")
        time.sleep(wait)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--hang-timeout", type=float, default=0.0)
    ap.add_argument("--backoff", type=float, default=2.0)
    ap.add_argument("--heartbeat-regex", default=None,
                    help="only stdout lines matching this regex count "
                         "as progress for --hang-timeout (default: any "
                         "line)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- <command to supervise>")
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given after --")
    raise SystemExit(supervise(cmd, args.max_restarts, args.hang_timeout,
                               args.backoff,
                               heartbeat_pattern=args.heartbeat_regex))


if __name__ == "__main__":
    main()
