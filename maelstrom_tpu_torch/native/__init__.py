"""The native CPU engine (``cpp/engine``): a copy of
``maelstrom_tpu/native/`` (``engine`` binds the C++ simulator,
``harness`` runs and checks it, ``wire`` is its width table)."""

from .engine import (native_available, replay_native_instances,  # noqa: F401
                     run_native_sim)
