"""The fault-plan engine and the fault fuzzer of the port.

Counterpart of ``maelstrom_tpu/faults/``: crash-restart, link
degradation, clock skew and membership as lanes of one fault plan
(:mod:`.spec` compiles it, :mod:`.engine` selects its planes each
tick), or of per-instance randomized schedules drawn on the device
(:mod:`.fuzz`). Trajectories equal the JAX runtime's bit for bit.
"""

from .engine import FaultConfig, FaultPlanes, NO_PLANES  # noqa: F401
from .fuzz import (BENCH_FUZZ_DIST, FuzzConfig,  # noqa: F401
                   compile_fault_fuzz, validate_fault_fuzz)
from .spec import (FAULT_KINDS, SpecError, compile_fault_plan,  # noqa: F401
                   generate_fault_plan, membership_walk,
                   validate_fault_plan)
