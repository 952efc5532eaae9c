"""Examples of the port, each run with ``python -m
dpdfnet_tpu_torch.examples.<name>`` (counterparts of the repository's
``examples/``): ``batch_enhance`` (a directory in length-sorted device
batches), ``finetune`` (a few train steps on a synthetic denoising task)
and ``serving_pool`` (many live streams through one pool)."""
