"""Multi-host launch test: 2 OS processes x 2 virtual CPU devices each,
one jax.distributed process group, one global 4-device mesh (SURVEY.md §4's
"multi-host tests via jax.distributed on a single host with multiple
processes").  Validates the sharded batched PBS and the cross-process
homomorphic OR-tree collective end to end with real decryption checks."""

import os
import socket
import subprocess
import sys
from pathlib import Path

WORKER = Path(__file__).parent / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_pbs_and_or_tree():
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(i), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert (f"MULTIHOST_OK proc={i} devices=4 ok=True "
                f"pipeline=has_match+run_many") in out, out
