"""Stream constants and batched stream ops on torch tensors."""
