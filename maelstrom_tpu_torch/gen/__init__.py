"""History helpers of the port (copies from ``maelstrom_tpu/gen``)."""
