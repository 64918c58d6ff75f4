"""Training resilience of the PyTorch port (counterpart of
``dexiraft_tpu.resilience``): checkpoint retention so far."""
