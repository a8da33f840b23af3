"""Host-side utilities: configs, synthetic data, recall, dataset I/O, checkpoints."""
