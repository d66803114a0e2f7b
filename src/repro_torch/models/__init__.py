"""The LM stack: configuration, layers and the model (dense-attention,
dense-MLP, token-input architectures)."""
