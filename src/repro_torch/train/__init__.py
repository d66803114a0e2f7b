"""Training: AdamW over a model's named tensors."""
