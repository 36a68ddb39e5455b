"""The port's fault-tolerance supervisor (``repro_torch.launch.supervisor``,
standard library only): the tests of ``tests/test_supervisor.py``, and
crash-restart serving through ``python -m repro_torch.launch.serve
--supervise`` on the CPU."""
import os
import subprocess
import sys

import pytest

from repro_torch.launch.supervisor import run_with_restarts, supervise

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_run_with_restarts_retries():
    calls = []

    def flaky(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise RuntimeError("simulated node failure")

    used = run_with_restarts(flaky, max_restarts=3, log=lambda *_: None)
    assert used == 2
    assert calls == [0, 1, 2]


def test_run_with_restarts_exhausts():
    def always_fails(attempt):
        raise RuntimeError("dead")

    with pytest.raises(RuntimeError):
        run_with_restarts(always_fails, max_restarts=2, log=lambda *_: None)


def test_supervise_restarts_until_success(tmp_path):
    """Child crashes twice (via a state file) then succeeds — the
    process-level restart path used for real node failures."""
    marker = tmp_path / "attempts"
    script = (
        "import os, sys\n"
        f"p = {str(marker)!r}\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        "sys.exit(0 if n >= 2 else 1)\n"
    )
    rc = supervise([sys.executable, "-c", script], max_restarts=5,
                   backoff_s=0.0, log=lambda *_: None)
    assert rc == 0
    assert int(marker.read_text()) == 3


def test_supervise_gives_up(tmp_path):
    rc = supervise([sys.executable, "-c", "import sys; sys.exit(3)"],
                   max_restarts=1, backoff_s=0.0, log=lambda *_: None)
    assert rc != 0


def test_supervise_kills_hung_child():
    rc = supervise(
        [sys.executable, "-c",
         "import time; print('x', flush=True); time.sleep(600)"],
        max_restarts=0, hang_timeout=2.0, backoff_s=0.0,
        log=lambda *_: None)
    assert rc != 0


def test_heartbeat_pattern_ignores_chatty_output():
    """A child logging constantly but never emitting the heartbeat line
    is a wedged server (device call never returns while admission logs
    keep flowing) — with --heartbeat-regex it must be killed, because
    chatty output no longer counts as progress."""
    rc = supervise(
        [sys.executable, "-u", "-c",
         "import time\n"
         "while True:\n"
         "    print('admitting request ...', flush=True)\n"
         "    time.sleep(0.2)\n"],
        max_restarts=0, hang_timeout=2.0, backoff_s=0.0,
        heartbeat_pattern=r"\[serve\] heartbeat", log=lambda *_: None)
    assert rc != 0


def test_heartbeat_pattern_keeps_live_child():
    """Heartbeat lines (and only those) reset the hang timer: a child
    heartbeating slower than the chatty noise but faster than the
    timeout survives to a clean exit."""
    rc = supervise(
        [sys.executable, "-u", "-c",
         "import time\n"
         "for i in range(4):\n"
         "    print('[serve] heartbeat step=%d' % i, flush=True)\n"
         "    time.sleep(0.8)\n"],
        max_restarts=0, hang_timeout=2.5, backoff_s=0.0,
        heartbeat_pattern=r"\[serve\] heartbeat", log=lambda *_: None)
    assert rc == 0


def test_serve_cli_crash_restart_resumes(tmp_path):
    """The serving driver on the CPU under ``--supervise``: the child
    snapshots and exits 7 at its crash step, the supervisor restarts it,
    the new child resumes the in-flight requests from the snapshot, runs
    them to the end, exits 0 and removes the snapshot."""
    snap = tmp_path / "snap.json"
    # the CLI quantizes its demo teacher first: one thread, as the
    # test workers share the cores
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3", "--prompt-len", "8", "--max-new", "6",
         "--max-batch", "2", "--page-size", "4", "--snapshot", str(snap),
         "--snapshot-every", "1", "--heartbeat-every", "1",
         "--crash-at-step", "2", "--supervise", "--hang-timeout", "60"],
        capture_output=True, text=True, timeout=300, env=env)
    out = r.stdout
    assert r.returncode == 0, out + r.stderr
    assert out.count("[serve] injected crash at step 2") == 1
    assert out.count("child exited rc=7") == 1
    assert "[serve] resumed 3 in-flight requests" in out
    assert "[supervisor] child finished cleanly" in out
    assert "[serve] engine=continuous on cpu: 3 requests, 18 tokens" in out
    assert not snap.exists()
