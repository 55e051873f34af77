"""Batches of torch tensors and the type algebra (port of blaze_tpu/columnar)."""
