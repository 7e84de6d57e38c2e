"""Single-device training of the port (``repro.training``): AdamW, the
seeded data pipeline, the train step with gradient accumulation, and
atomic checkpoints. Plain PyTorch ops and autograd: the JAX package's
training path reaches no Pallas kernel."""
