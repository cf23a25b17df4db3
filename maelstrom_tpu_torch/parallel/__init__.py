"""Instance sharding over several devices (``mesh``) and the hybrid
mesh of a multi-host run in its single-process form (``multihost``)."""
