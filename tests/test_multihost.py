"""Multi-host entry points exercised for real: 2 coordinated processes
(jax.distributed over localhost, gloo CPU collectives), each with 2 virtual
CPU devices — 2 hosts × 2 devices.  The rays mesh axis spans processes,
the bricks axis stays inside each process, exactly the layout
``make_host_mesh`` promises (parallel/shard.py).

The reference has no multi-node anything (SURVEY.md §2 comm table); this is
the multi-host replacement for its single-node GPU fan-out, validated
end-to-end: init → host mesh → one sharded brick-train step → identical
finite loss on every process.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).parent / "_multihost_worker.py"
NUM_PROC = 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_brick_train_step():
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    # hermetic CPU workers: 2 virtual devices per process
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1])
    coord = f"127.0.0.1:{_free_port()}"

    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coord, str(NUM_PROC), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        )
        for i in range(NUM_PROC)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    losses = {}
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("MH ")][0]
        _, pid, loss, shape = line.split(None, 3)
        losses[int(pid)] = float(loss)
        assert shape == "(2, 2)", line
    assert set(losses) == set(range(NUM_PROC))
    # the psum'd global loss must agree bit-for-bit across processes
    assert losses[0] == losses[1] and losses[0] > 0
