"""The protocol catalogs the lint passes read: the error codes
(``errors``), the schema system and RPC registry (``schema``), and the
workloads' RPC declarations that fill it (``rpcs``)."""
