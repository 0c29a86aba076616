"""Multi-host SPMD launch (SURVEY.md §2.3 / §5 distributed backend).

The reference has no distributed execution; here the same single program
runs on every host: initialize the process group, build one global mesh
over all devices, and run the identical ``has_match(..., mesh=...)`` — XLA
compiles the batch sharding onto the collectives between devices (NVLink
within a host, the network across hosts), and the OR-tree collective
(parallel/collective.py) reduces partial match bits across the mesh.

Usage (every host runs the same script):

    from fhe_regex_tpu.parallel.multihost import initialize, global_mesh
    initialize("localhost:1234", num_processes=2, process_id=0)
    mesh = global_mesh()
    res = has_match(server_key, ct_content, pattern, mesh=mesh)

Scaling efficiency is measured by benchmarks: bootstraps/s at 1 card vs the
full mesh (target >=80% at 2 hosts, BASELINE.json).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from fhe_regex_tpu.parallel.mesh import BATCH_AXIS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize; pass the coordinator address, process
    count and this process's id unless the cluster environment supplies
    them."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh() -> Mesh:
    """One batch-axis mesh over every device of every host."""
    return Mesh(np.array(jax.devices()), (BATCH_AXIS,))
