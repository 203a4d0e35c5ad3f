"""The ``df`` command line of the port (``python -m
dragonfly2_tpu_torch.cli.main <cmd>``)."""
