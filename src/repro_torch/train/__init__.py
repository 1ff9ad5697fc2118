"""Training: AdamW, the fault-tolerance runtime and the training loop."""
