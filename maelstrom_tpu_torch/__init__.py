"""maelstrom_tpu_torch: the PyTorch/CUDA port of the device runtime.

A second package beside ``maelstrom_tpu`` (the JAX reference, which it
never imports). It runs the lin-kv Raft fleet end to end on an NVIDIA
card: ``harness.run_torch_test`` or ``python -m maelstrom_tpu_torch test
-w lin-kv``. Entry points run on ``cuda`` unless the caller asks for the
CPU; on the CPU every kernel is replaced by its plain PyTorch version.
"""
