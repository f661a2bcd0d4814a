"""Durable state: the PSCR1 StateRec format, stores, and the PBComb
checkpointer, copied from the reference package (``NVMStore``,
``reclaim`` and ``sharded`` come with later slices)."""
