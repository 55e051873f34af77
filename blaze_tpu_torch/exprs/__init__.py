"""Expression IR, casts and the torch expression compiler (port of blaze_tpu/exprs)."""
