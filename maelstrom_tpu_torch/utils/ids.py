"""Node-id helpers: copy of ``maelstrom_tpu/utils/ids.py``."""

from __future__ import annotations

import re
from typing import Iterable, List


def is_client(node_id: str) -> bool:
    """Client node ids begin with 'c' (e.g. c1, c2...)."""
    return isinstance(node_id, str) and node_id.startswith("c")


_NAT = re.compile(r"(\d+)")


def _natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in _NAT.split(s)]


def sort_ids(ids: Iterable[str]) -> List[str]:
    """Natural sort: n2 < n10, c1 < c2 < n0."""
    return sorted(ids, key=_natural_key)
