"""Tensor ops of the PyTorch port (counterpart of ``dexiraft_tpu.ops``).

Importing this package builds nothing: the CUDA kernels of
``corr_kernels`` are compiled at their first launch.
"""
