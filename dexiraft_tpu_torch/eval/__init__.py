"""Eval of the PyTorch port (counterpart of ``dexiraft_tpu.eval``)."""
