"""Vectorized protocol models of the port (lin-kv Raft)."""
