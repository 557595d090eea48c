"""Continuous batching of many MD replicas (the SimServer subsystem).

The port of the JAX package's ``serve`` package.  Client side::

    server = SimServer(make_mesh((1, 1, 1), ("z", "y", "x")),
                       BucketLadder(), block_steps=10,
                       engine_kwargs={"force_backend": "pallas"})
    h = server.submit(make_grappa_like(200, box_atoms=256, nstlist=10,
                                       seed=3), n_steps=40)
    out = h.result()          # bitwise == a solo MDEngine run

See :mod:`repro_torch.serve.sim_server` for the isolation contract and
:mod:`repro_torch.serve.scheduler` for the admission / retirement
invariants.
"""
from repro_torch.serve.buckets import (Bucket, BucketLadder,
                                       DEFAULT_ATOM_BUCKETS,
                                       DEFAULT_ROW_BUCKETS, padding_waste)
from repro_torch.serve.scheduler import (Admission, CANCELLED, DONE, FAILED,
                                         PREEMPTED, QUEUED, RUNNING,
                                         ReplicaRecord, SimScheduler,
                                         TERMINAL)
from repro_torch.serve.sim_server import (ReplicaFault, ReplicaHandle,
                                          SimServer)

__all__ = [
    "Bucket", "BucketLadder", "DEFAULT_ROW_BUCKETS", "DEFAULT_ATOM_BUCKETS",
    "padding_waste",
    "Admission", "ReplicaRecord", "SimScheduler",
    "QUEUED", "RUNNING", "DONE", "CANCELLED", "FAILED", "PREEMPTED",
    "TERMINAL",
    "SimServer", "ReplicaHandle", "ReplicaFault",
]
