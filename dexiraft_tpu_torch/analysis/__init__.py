"""Runtime and static analysis of the port: the collective flight
recorder (``collective_trace``), the runtime guards behind ``--strict``
(``guards``: implicit host syncs and the recompile budget), their static
half, ``synclint`` with the sharding-contract rules of ``shardlint``, the
lock-discipline rules of ``threadlint`` and the collective-divergence
rules of ``distlint``, and the placement audit of the multi-rank train
state and batches (``shardaudit``)."""
