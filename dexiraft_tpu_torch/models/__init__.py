"""Models of the PyTorch port (counterpart of ``dexiraft_tpu.models``)."""
