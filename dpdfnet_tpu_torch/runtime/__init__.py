"""runtime of dpdfnet_tpu_torch."""
