"""Maps over the state trees of the port: tensors, NamedTuples of
tensors and dicts of tensors (``None`` stays ``None``).

Node state is a bare tensor for the legacy models (echo, unique-ids,
the CRDTs), a row tuple for Raft, the txn models and kafka, and a Raft
or txn slab is a dict of durable lanes (leaves of any rank: the
list-append kv is ``[I, N, n_keys, 1 + list_cap]``), so the runtime,
the fault engine and the carry conversion walk all three the same way.
"""

from __future__ import annotations

from typing import Callable

import torch


def tree_map(fn: Callable, *trees):
    """``fn`` over the matching leaves of ``trees``, rebuilt in the
    structure of the first."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))


def tree_leaves(tree) -> list:
    """The tensors of a tree, in :func:`tree_map` order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [x for t in tree for x in tree_leaves(t)]
