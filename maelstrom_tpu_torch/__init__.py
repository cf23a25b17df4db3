"""maelstrom_tpu_torch: the PyTorch/CUDA port of maelstrom_tpu.

A second package beside ``maelstrom_tpu`` (the JAX reference, which it
never imports), with three runtimes behind one workload boundary:

- **process runtime** (:func:`run_test`, ``runner.py``; the CLI's
  default): spawns user nodes as child processes speaking
  newline-delimited JSON over STDIN/STDOUT against an in-process
  simulated network with latency, loss and partitions. It holds no
  device state.
- **device runtime** (``harness.run_torch_test``, ``python -m
  maelstrom_tpu_torch test --runtime tpu``): workload protocol
  instances as rows of device tensors, the fleet run end to end on an
  NVIDIA card. Its entry points run on ``cuda`` unless the caller asks
  for the CPU; on the CPU every kernel is replaced by its plain PyTorch
  version.
- **native engine** (``native.harness.run_native_test``, ``test
  --runtime native``): the C++ simulator of ``cpp/engine/sim.cpp`` on
  the host, built by the port into ``build/engine/`` at first use.
"""

from .runner import run_test  # noqa: F401
