"""Multi-process `jax.distributed` test: 2 processes x 2 virtual CPU devices
form a (kf=2, pt=2) mesh (Gloo collectives standing in for the network, per the
SURVEY §4 multi-host test strategy); the sharded NID loss must equal the
single-process value. The reference has no multi-process path at all — this
covers the rebuild's `jax.distributed` runtime (parallel/mesh.py)."""

import os
import socket
import subprocess
import sys

def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_nid_matches_local():
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([repo, here, env.get("PYTHONPATH", "")])
    # The worker flips to CPU itself; scrub any preset platform/device flags.
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = ""
    port = str(_free_port())
    worker = os.path.join(here, "multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), port],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"proc {i} output:\n{out}"


def test_worker_death_is_detected_not_hung():
    """Failure-detection drill (VERDICT r2 #8; SURVEY §5 notes the reference
    has NO failure handling): process 1 os._exit()s mid-solve between
    collectives. The surviving process 0 must terminate with a clean,
    diagnosable error — not hang — within the collective timeout. Recovery
    story: stage artifacts + `--resume` re-run (see README)."""
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([repo, here, env.get("PYTHONPATH", "")])
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = ""
    port = str(_free_port())
    worker = os.path.join(here, "multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), port, "failover"],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)  # a hang fails here
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[1].returncode == 42, f"proc 1 should die with 42:\n{outs[1]}"
    assert procs[0].returncode == 0, f"survivor crashed uncleanly:\n{outs[0]}"
    assert "FAILURE_DETECTED" in outs[0], f"survivor output:\n{outs[0]}"
    assert "NO_FAILURE_DETECTED" not in outs[0]
