"""Hybrid meshes for the instance axis, in their single-process form.

Counterpart of ``maelstrom_tpu/parallel/multihost.py``. At multi-host
scale the same data parallelism factors over two axes — hosts over the
data-center network (``dcn``), cards within a host (``ici``) — so only
the reduced fleet counters cross hosts. The sharded executor
(:func:`.mesh.run_sim_sharded`, :func:`.mesh.run_sim_sharded_chunked`)
takes any mesh rank, its shards in row-major order::

    from maelstrom_tpu_torch.parallel import mesh, multihost
    multihost.init()                       # one process: nothing to do
    m = multihost.make_hybrid_mesh()       # ("dcn", "ici"), (1, n_cards)
    stats, violations, events = mesh.run_sim_sharded(
        model, sim, seed=0, mesh=m)

Only the one-process form exists: a run over several processes
(``torch.distributed`` with NCCL) is not ported, and :func:`init` raises
when the environment asks for one.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from .mesh import Mesh, make_mesh

DCN_AXIS = "dcn"
ICI_AXIS = "ici"

# what torch.distributed's launchers set for a run of several processes
_WORLD_ENV = ("WORLD_SIZE", "JAX_NUM_PROCESSES")


def init(**kw) -> None:
    """Nothing to do in one process; raises when the environment or the
    arguments ask for several (``WORLD_SIZE`` > 1, ``num_processes`` >
    1): multi-process runs are not ported."""
    n = int(kw.get("num_processes") or 1)
    for name in _WORLD_ENV:
        n = max(n, int(os.environ.get(name) or 1))
    if n > 1:
        raise RuntimeError(
            f"multihost.init: {n} processes asked for; the port runs "
            f"one process (several processes over torch.distributed and "
            f"NCCL are not ported)")


def make_hybrid_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A ``(1, n_devices)`` mesh named ``("dcn", "ici")`` over every
    visible card (or over ``devices``): one process, one ICI row."""
    flat = make_mesh(devices=devices).devices
    return Mesh(flat, (DCN_AXIS, ICI_AXIS), (1, len(flat)))
