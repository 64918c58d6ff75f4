"""Runtime analysis of the port: the collective flight recorder
(``collective_trace``). The JAX package's linters, its recompile guard
and its placement audit are ROADMAP A13."""
