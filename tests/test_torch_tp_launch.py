"""``python -m repro_torch.launch.serve --tp N`` under torchrun's
environment, on the CPU over gloo: each process is one rank of the group
that RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT describe (the spawned
ranks of ``run_ranks`` are held in ``tests/test_torch_sharding.py``)."""
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_launch_serve_tp_under_torchrun(tmp_path):
    """``launch.serve --tp 2`` under torchrun's environment (RANK,
    LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE and a store on this host):
    each process is one rank of that group, both exit 0, and only rank 0
    prints the mesh line and the summary."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", TMPDIR=str(tmp_path),
               GLOO_SOCKET_IFNAME="lo", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
           "cpu", "--fp", "--requests", "2", "--max-new", "3", "--tp", "2",
           "--tp-backend", "gloo"]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r),
                                            LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    out0, out1 = outs[0][0], outs[1][0]
    assert out0.count("[serve] tensor-parallel: 2 ranks over gloo on "
                      "['cpu', 'cpu'], mesh {'data': 1, 'model': 2}") == 1
    assert out0.count("[serve] engine=continuous on cpu: 2 requests") == 1
    assert out1 == ""


def test_nccl_counts_this_machines_ranks_under_torchrun(monkeypatch):
    """Under torchrun the ranks may span machines: nccl needs a card for
    each of this machine's ranks (LOCAL_WORLD_SIZE), not for all of them."""
    from repro_torch.launch import mesh
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "16"), ("LOCAL_WORLD_SIZE",
                 "8"), ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(mesh.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh.torch.cuda, "device_count", lambda: 8)
    mesh.check_backend("nccl", 16)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "9")
    with pytest.raises(RuntimeError, match="each of the 9 ranks on this"):
        mesh.check_backend("nccl", 16)
    monkeypatch.delenv("MASTER_PORT")          # not under torchrun
    with pytest.raises(RuntimeError, match="each of the 16 ranks on this"):
        mesh.check_backend("nccl", 16)
