"""Training substrate of the PyTorch port, the counterpart of
``repro.train``: AdamW and its schedule (``optim``), the next-token loss
and training step (``train``), the synthetic data pipeline (``data``),
flat-npz checkpoints in the JAX package's key layout (``checkpoint``) and
the entry point ``python -m repro_torch.train.train_mm``."""
