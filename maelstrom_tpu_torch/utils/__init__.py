"""Host utilities of the port (copies from ``maelstrom_tpu/utils``)."""
