"""dexiraft_tpu_torch: the PyTorch/CUDA port of dexiraft_tpu.

The JAX package (``dexiraft_tpu``) is the reference this package is held
against; this package imports nothing of it, nor JAX. Layout mirrors the
JAX package: ``config``, ``ops`` (with the hand-written CUDA kernels of
``csrc/``), ``models``, ``interop``, ``data``, ``serve`` and ``train``.
Importing it builds no kernel and touches no device.
"""

__version__ = "0.1.0"
