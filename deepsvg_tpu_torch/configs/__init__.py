"""Experiment configs of the port, counterparts of ``configs_tpu/``: select
one with ``--config-module deepsvg_tpu_torch.configs.<name>``."""
