"""utils of dpdfnet_tpu_torch."""
