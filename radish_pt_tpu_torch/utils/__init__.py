"""Vector math on torch tensors."""
