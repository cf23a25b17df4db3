"""Static analysis: the port's ``lint`` passes.

Counterpart of ``maelstrom_tpu/analysis/`` for its three default passes
(the JAX package's jaxpr passes have no counterpart in the eager port):

- :mod:`.trace_lint` — AST hygiene lint over the code that runs inside
  the tick: TRC1xx rules, with torch's host syncs, data-dependent shapes
  and global-generator draws;
- :mod:`.contract_audit` — every registered model's shape, dtype and
  lane contracts, and the carry as a shape fixed point of the tick, on
  ``meta`` tensors: CON2xx rules;
- :mod:`.schema_lint` — the RPC registry against the models' wire
  encodings and the error-code registry: SCH304 and SCH305.

Findings are :class:`~.findings.Finding` records; the checked-in
``baseline.json`` holds the justified exceptions.
"""

from .findings import (Baseline, Finding, LintReport, SEV_ERROR,  # noqa
                       SEV_INFO, SEV_WARNING, render_text)
from .runner import ALL_PASSES, run_lint  # noqa
