"""Physical operators (port of blaze_tpu/ops)."""
