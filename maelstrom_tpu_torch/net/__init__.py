"""The Lamport diagram of a journal (copy of ``maelstrom_tpu/net/viz.py``)."""
