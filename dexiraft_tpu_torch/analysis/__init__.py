"""Runtime and static analysis of the port: the collective flight
recorder (``collective_trace``), the runtime guards behind ``--strict``
(``guards``: implicit host syncs and the recompile budget), and their
static half, ``synclint`` with the lock-discipline rules of
``threadlint``. The JAX package's sharding and collective linters and its
placement audit are ROADMAP A13's rest, after A12.1."""
