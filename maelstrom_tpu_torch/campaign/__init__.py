"""Durable campaign control plane: checkpointed carry, resumable run
queue, and a multi-run trend store (counterpart of
``maelstrom_tpu/campaign/``).

- ``checkpoint.py``: every K chunks the chunked executor hands its
  carry and host accumulators, at a consistent cut, to an atomic
  write-temp-then-rename checkpoint under ``<run-dir>/checkpoint/``;
  a resume continues dispatch so the run ends equal to an uninterrupted
  one.
- ``spec.py``: a JSON (or TOML, Python 3.11+) campaign file declares a
  sweep matrix (workload x config x seed x horizon) expanded into work
  items.
- ``queue.py``: the file-lock-claimed item state machine
  (``pending -> running -> done/failed/preempted``): a killed worker's
  item is claimable again and resumes from its last checkpoint.
- ``runner.py``: ``campaign run`` drains the queue through the chunked
  executor; ``resume_run`` finishes a killed run from its heartbeat and
  checkpoint.
- ``report.py``: ``status`` merges the items' heartbeats into one live
  table; ``report`` aggregates completed runs into ``summary.json``.
"""

from .checkpoint import (CheckpointError, checkpoint_path,  # noqa: F401
                         load_checkpoint, save_checkpoint)
from .queue import submit_campaign  # noqa: F401
from .runner import resume_run, run_campaign  # noqa: F401
