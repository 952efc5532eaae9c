"""ops of dpdfnet_tpu_torch."""
