"""dexiraft_tpu_torch: the PyTorch/CUDA port of dexiraft_tpu.

The JAX package (``dexiraft_tpu``) is the reference this package is held
against; this package imports nothing of it, nor JAX. Layout mirrors the
JAX package: ``config``, ``ops`` (with the hand-written CUDA kernels of
``csrc/``), ``models``, ``interop``, ``data``, ``serve`` and ``train``.
Importing it builds no kernel and touches no device. It sets one
variable of this process's environment, unless the caller set it:
``TORCH_CUDNN_USE_HEURISTIC_MODE_B``, which makes cuDNN's untimed pick
(the train step's, ``train.step.train_arithmetic``) its mode-B heuristic.
cuDNN reads it once, at the process's first untimed pick, so it is set
before any convolution runs.
"""

import os

__version__ = "0.1.0"

os.environ.setdefault("TORCH_CUDNN_USE_HEURISTIC_MODE_B", "1")
