"""Campaign specs: a declarative sweep matrix expanded into work items.

A copy of ``maelstrom_tpu/campaign/spec.py`` (the port imports nothing
of the JAX package): the same files expand into the same items.

A campaign file (JSON everywhere; TOML on Python 3.11+ where the
stdlib ``tomllib`` exists — the container pins no third-party parser)
declares what the Pulsar enterprise-benchmarking methodology calls a
campaign matrix: every combination of workload x config x seed x
horizon, each combination one queue item. Shape:

.. code-block:: json

    {
      "name": "nightly-raft",
      "defaults": {"time_limit": 1.0, "n_instances": 64,
                   "checkpoint_every": 4},
      "matrix": {"workload": ["lin-kv", "txn-rw-register"],
                 "seed": [0, 1, 2],
                 "nemesis": [[], ["partition"]]},
      "items": [{"workload": "echo", "seed": 9, "time_limit": 0.5}]
    }

``matrix`` keys holding lists are swept (cartesian product, sorted key
order); scalar keys are constants. ``defaults`` underlie every item;
explicit ``items`` entries append verbatim (over defaults). Any
``run_torch_test`` opt is a valid key — ``workload`` (required) plus
``node_count``/``topology``/``key_count``/``crash_clients``/
``txn_dirty_apply`` select the model, and ``fault_plan`` (an inline
plan dict, doc/guide/10-faults.md), ``fault_fuzz`` (an inline fault
DISTRIBUTION — per-instance randomized schedules,
``faults/fuzz.py``) or fault ``nemesis`` kinds put a
whole fault campaign — crash-restart, link degradation, clock skew —
in the queue like any other sweep axis.

Two keys are queue scheduling policy rather than run opts:
``retries`` (int, default 0) and ``backoff_s``/``backoff-s`` (float,
default 30) — a FAILED (crashed, not invalid) item re-queues up to
``retries`` times with exponential backoff recorded on the item JSON
(``failures``/``not-before``/``backoff-history``), and ``campaign
status``/``report`` show the attempt counts. ``submit`` lifts them off
the opts dict onto the item record (``queue.py``).
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Any, Dict, List

# opt keys that select/construct the model rather than the SimConfig
MODEL_KEYS = ("workload", "node_count", "topology", "key_count")


class SpecError(ValueError):
    """A campaign spec that cannot be parsed or expanded."""


def load_spec(path: str) -> Dict[str, Any]:
    """Parse a campaign file (.json, or .toml on py3.11+)."""
    if path.endswith(".toml"):
        try:
            import tomllib
        except ImportError:
            raise SpecError(
                "TOML campaign specs need Python 3.11+ (stdlib "
                "tomllib); re-write the spec as JSON")
        with open(path, "rb") as f:
            spec = tomllib.load(f)
    else:
        with open(path) as f:
            try:
                spec = json.load(f)
            except json.JSONDecodeError as e:
                raise SpecError(f"{path}: not valid JSON ({e})")
    if not isinstance(spec, dict):
        raise SpecError(f"{path}: top level must be a table/object")
    spec.setdefault(
        "name", os.path.splitext(os.path.basename(path))[0])
    return spec


def expand_items(spec: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Expand a spec into the ordered work-item opt dicts.

    Every item is a flat ``run_torch_test``-style opts dict including
    ``workload``; item ids are assigned by position (matrix rows in
    sorted-key cartesian order, then explicit ``items``)."""
    defaults = dict(spec.get("defaults") or {})
    matrix = dict(spec.get("matrix") or {})
    explicit = list(spec.get("items") or [])
    out: List[Dict[str, Any]] = []
    if matrix:
        swept = {k: v for k, v in matrix.items() if isinstance(v, list)}
        consts = {k: v for k, v in matrix.items()
                  if not isinstance(v, list)}
        keys = sorted(swept)
        for combo in itertools.product(*(swept[k] for k in keys)):
            item = {**defaults, **consts, **dict(zip(keys, combo))}
            out.append(item)
    for item in explicit:
        if not isinstance(item, dict):
            raise SpecError(f"items entry is not a table: {item!r}")
        out.append({**defaults, **item})
    if not out:
        raise SpecError(
            f"campaign {spec.get('name')!r} expands to zero items "
            f"(empty matrix and no explicit items)")
    for i, item in enumerate(out):
        if not item.get("workload"):
            raise SpecError(f"item {i} names no workload: {item!r}")
    return out
