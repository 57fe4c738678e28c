"""Multi-device execution: reads data-parallel over a (dp, fm) mesh of
devices, the index split by BWT row range over its fm axis (sharded.py),
and the multi-process entry (multihost.py)."""
