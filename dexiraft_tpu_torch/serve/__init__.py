"""Serve of the PyTorch port (counterpart of ``dexiraft_tpu.serve``)."""
