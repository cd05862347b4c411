"""Fonts dataset defaults, counterpart of ``configs_tpu/defaults_fonts.py``:
the icons config with the fonts archive's paths, read by
``deepsvg_tpu_torch.data.dataset`` (labels from the meta CSV's ``uni``
column). The archive is an external download: without it, train on
``deepsvg_tpu_torch.data.synthetic``, whose items carry labels when the
model is label-conditioned."""
from .default_icons import Config as IconsConfig


class Config(IconsConfig):
    def __init__(self, num_devices=1):
        super().__init__(num_devices=num_devices)

        self.data_dir = "./dataset/fonts_tensor/"
        self.meta_filepath = "./dataset/fonts_meta.csv"
