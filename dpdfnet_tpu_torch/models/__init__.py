"""models of dpdfnet_tpu_torch."""
