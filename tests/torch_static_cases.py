"""One recorded tick per model and tick variant, shared by the tests of
the port's static passes over the aten graph of the tick
(``test_torch_cost.py``, ``test_torch_ir.py``, ``test_torch_lanes.py``,
``test_torch_ranges.py``).

``static_traces`` (a session fixture) is the ``trace_cache`` mapping the
passes take (``cost_model.trace_tick``'s keys: one graph per model at
its audit config and variant, the init graph, a cost report). It holds
what one process recorded, and under pytest-xdist also reads and writes
a directory of the test run shared by its workers: a model one file's
worker traced is loaded by another's (a pickle, ~0.3 s) instead of
traced again (~2 s a variant). Only audit-config graphs may go in: the
keys do not capture the sim.
"""

import os
import pickle

import pytest


class SharedTraces:
    """A dict of recorded graphs, backed by ``root`` when given."""

    def __init__(self, root=None):
        self.mem = {}
        self.root = root
        if root is not None:
            os.makedirs(root, exist_ok=True)

    def _path(self, key):
        safe = "".join(c if c.isalnum() or c in "-_=." else "_"
                       for c in key)
        return os.path.join(self.root, safe + ".pkl")

    def get(self, key, default=None):
        got = self.mem.get(key)
        if got is None and self.root is not None:
            try:
                with open(self._path(key), "rb") as f:
                    got = pickle.load(f)
            except (OSError, EOFError, pickle.UnpicklingError):
                got = None
            if got is not None:
                self.mem[key] = got
        return default if got is None else got

    def __contains__(self, key):
        return self.get(key) is not None

    def __getitem__(self, key):
        got = self.get(key)
        if got is None:
            raise KeyError(key)
        return got

    def __setitem__(self, key, value):
        self.mem[key] = value
        if self.root is None:
            return
        path = self._path(key)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except (OSError, pickle.PicklingError, TypeError, AttributeError):
            if os.path.exists(tmp):
                os.remove(tmp)


@pytest.fixture(scope="session")
def static_traces(tmp_path_factory):
    """The shared traces: on disk in the run's base directory (the
    parent of each xdist worker's own) under xdist, else in memory."""
    root = None
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = str(tmp_path_factory.getbasetemp().parent
                   / "torch-static-traces")
    return SharedTraces(root)
