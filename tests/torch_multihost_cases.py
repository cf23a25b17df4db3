"""What each spawned process of ``tests/test_torch_multihost.py`` runs.

These functions run in processes started by ``multihost.spawn`` (the
``spawn`` method: a fresh interpreter that imports this module by name),
so the module imports torch and the port only, never JAX. Each process
is already joined to the two-process gloo group when its function is
called, from the launcher variables ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK``.
"""

import os
import shutil
import sys

import numpy as np
import torch

from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.campaign import checkpoint as ckpt
from maelstrom_tpu_torch.models import get_model
from maelstrom_tpu_torch.models.raft import RaftModel
from maelstrom_tpu_torch.parallel import mesh, multihost
from maelstrom_tpu_torch.telemetry import stream

CPU = torch.device("cpu")

# lin-kv Raft at the flagship's widths (test_torch_mesh.RAFT_OPTS),
# 2 instances a shard, 80 ticks
RAFT_KW = dict(n_nodes_hint=3, log_cap=64, heartbeat=8)
RAFT_OPTS = dict(node_count=3, concurrency=6, n_instances=2,
                 record_instances=2, time_limit=0.08, rate=200.0,
                 latency=5.0, rpc_timeout=0.4, nemesis=["partition"],
                 nemesis_interval=0.04, p_loss=0.05, recovery_time=0.02,
                 seed=9, telemetry=True, inbox_k=1, pool_slots=16)

# the planted double-vote mutant (test_campaign.BUGGY_OPTS), 8 instances
# a shard: it trips within 300 ticks
BUGGY_OPTS = dict(node_count=3, concurrency=6, n_instances=8,
                  record_instances=4, inbox_k=1, pool_slots=16,
                  time_limit=0.3, rate=200.0, latency=5.0,
                  rpc_timeout=1.0, nemesis=["partition"],
                  nemesis_interval=0.04, p_loss=0.05, recovery_time=0.0,
                  seed=7, funnel=False, pipeline="on", chunk_ticks=50)


def _host(out):
    """Outputs as picklable host values: NetStats as ints, telemetry as
    a dict of arrays."""
    stats, viol, events = out[:3]
    res = {"stats": tuple(int(x) for x in stats),
           "violations": np.asarray(viol), "events": np.asarray(events)}
    if len(out) > 3:
        tel = out[3]
        res["telemetry"] = None if tel is None else {
            f: np.asarray(x) for f, x in zip(tel._fields, tel)}
    return res


def one_shot():
    """The launcher variables, then ``run_sim_sharded`` on the ``(2, 1)``
    and ``(2, 2)`` hybrid meshes of CPU devices, then the refusal of
    rows of different widths."""
    env = {k: os.environ[k] for k in ("MASTER_ADDR", "MASTER_PORT",
                                      "WORLD_SIZE", "RANK")}
    rank = multihost.process_index()
    out = {"rank": rank, "count": multihost.process_count(), "env": env,
           "jax-imported": "jax" in sys.modules}
    model = RaftModel(**RAFT_KW)
    sim = harness.make_sim_config(model, RAFT_OPTS)
    for per_host in (1, 2):
        m = multihost.make_hybrid_mesh(devices=[CPU] * per_host)
        out[f"mesh-{per_host}"] = (m.shape, m.axis_names, m.size,
                                   list(m.local_shards))
        out[f"run-{per_host}"] = _host(mesh.run_sim_sharded(
            model, sim, 9, mesh=m, return_telemetry=True))
    try:
        multihost.make_hybrid_mesh(devices=[CPU] * (1 + rank))
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def _npz(path):
    import json
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays.pop("__meta__")).decode())
    return arrays, header


def buggy_sim():
    model = get_model("lin-kv-bug-double-vote", 3)
    return model, harness.make_sim_config(model, BUGGY_OPTS)


def chunked(base_dir: str):
    """The double-vote mutant through ``run_sim_sharded_chunked`` on the
    ``(2, 1)`` hybrid mesh with fail-fast, a heartbeat and a checkpoint
    after every chunk; each rank gets a heartbeat writer and a
    checkpoint sink of its own directory, and rank 0 keeps a copy of
    every checkpoint it writes."""
    rank = multihost.process_index()
    d = os.path.join(base_dir, f"rank{rank}")
    os.makedirs(d, exist_ok=True)
    model, sim = buggy_sim()
    m = multihost.make_hybrid_mesh(devices=[CPU])
    hb = stream.HeartbeatWriter(d, meta={"workload": model.name})
    sink = ckpt.make_checkpoint_cb(d, kind="sharded", meta={"run": "mesh"})
    saves = []

    def cb(state, ticks, host):
        sink(state, ticks, host)
        keep = os.path.join(d, f"save-{len(saves)}")
        os.makedirs(os.path.dirname(ckpt.checkpoint_path(keep)))
        shutil.copy(ckpt.checkpoint_path(d), ckpt.checkpoint_path(keep))
        saves.append((ticks, keep, _npz(ckpt.checkpoint_path(d))))

    perf = {}
    out = mesh.run_sim_sharded_chunked(
        model, sim, 7, mesh=m, chunk=50, fail_fast=True, heartbeat=hb,
        perf=perf, checkpoint_cb=cb, checkpoint_every=1,
        return_telemetry=True)
    hb.finish(status="stopped" if perf.get("stopped-early")
              else "complete")
    return {"rank": rank, "out": _host(out), "perf": perf, "dir": d,
            "saves": saves}


def deserted():
    """Rank 1 leaves without joining the exchange; rank 0 runs on into
    the first chunk's all-gather, which must raise (the peer is gone, or
    the group's timeout runs out), never return a one-process result."""
    if multihost.process_index() == 1:
        return "left"
    model, sim = buggy_sim()
    return mesh.run_sim_sharded_chunked(
        model, sim, 7, mesh=mesh.Mesh([CPU, CPU], ("dcn", "ici"), (2, 1),
                                      process_index=0, process_count=2),
        chunk=50)
