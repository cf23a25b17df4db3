"""Node names and the broadcast topologies (plain Python).

A copy of ``maelstrom_tpu/utils/ids.py`` (``node_names``, ``sort_ids``)
and ``maelstrom_tpu/workloads/topology.py``: a topology maps each node
id to the neighbours it gossips with, selected by ``--topology``
(default grid); :func:`adjacency` turns one into the ``[N, N]`` bool
matrix the gossip models take as their static params.

Parity: reference src/maelstrom/workload/broadcast.clj — grid :40-65,
line :67-80, total :82-89, tree :144-167, registry :169-178.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List

import numpy as np

_NAT = re.compile(r"(\d+)")


def _natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in _NAT.split(s)]


def sort_ids(ids: Iterable[str]) -> List[str]:
    """Natural sort: n2 < n10, c1 < c2 < n0."""
    return sorted(ids, key=_natural_key)


def node_names(count: int, prefix: str = "n") -> List[str]:
    """Node names n0..n(count-1)."""
    return [f"{prefix}{i}" for i in range(count)]


def line(nodes: List[str]) -> Dict[str, List[str]]:
    ns = sort_ids(nodes)
    topo = {}
    for i, n in enumerate(ns):
        nbrs = []
        if i > 0:
            nbrs.append(ns[i - 1])
        if i < len(ns) - 1:
            nbrs.append(ns[i + 1])
        topo[n] = nbrs
    return topo


def grid(nodes: List[str]) -> Dict[str, List[str]]:
    """Arrange nodes in a rough square grid; neighbors up/down/left/right."""
    ns = sort_ids(nodes)
    n = len(ns)
    cols = max(1, int(math.ceil(math.sqrt(n))))
    coord = {i: (i // cols, i % cols) for i in range(n)}
    index = {v: k for k, v in coord.items()}
    topo = {}
    for i, node in enumerate(ns):
        r, c = coord[i]
        nbrs = []
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            j = index.get((r + dr, c + dc))
            if j is not None and j < n:
                nbrs.append(ns[j])
        topo[node] = nbrs
    return topo


def total(nodes: List[str]) -> Dict[str, List[str]]:
    ns = sort_ids(nodes)
    return {n: [m for m in ns if m != n] for n in ns}


def tree(branching: int):
    def make(nodes: List[str]) -> Dict[str, List[str]]:
        ns = sort_ids(nodes)
        topo: Dict[str, List[str]] = {n: [] for n in ns}
        for i, node in enumerate(ns):
            for k in range(1, branching + 1):
                j = i * branching + k
                if j < len(ns):
                    topo[node].append(ns[j])
                    topo[ns[j]].append(node)
        return topo
    return make


TOPOLOGIES = {
    "line": line,
    "grid": grid,
    "total": total,
    "tree": tree(2),     # alias, matching the reference registry
    "tree2": tree(2),
    "tree3": tree(3),
    "tree4": tree(4),
}


def make_topology(name: str, nodes: List[str]) -> Dict[str, List[str]]:
    if name not in TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}; known: "
                         f"{sorted(TOPOLOGIES)}")
    return TOPOLOGIES[name](nodes)


def adjacency(topology_name: str, n_nodes: int) -> np.ndarray:
    """``[N, N]`` bool adjacency matrix of a named topology over nodes
    n0..n(N-1): row ``i`` holds node ``i``'s neighbours."""
    names = node_names(n_nodes)
    idx = {n: i for i, n in enumerate(names)}
    a = np.zeros((n_nodes, n_nodes), dtype=bool)
    for n, nbrs in make_topology(topology_name, names).items():
        for m in nbrs:
            a[idx[n], idx[m]] = True
    return a
