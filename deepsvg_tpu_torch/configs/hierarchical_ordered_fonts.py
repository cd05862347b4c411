"""The label-conditioned fonts config, counterpart of
``configs_tpu/hierarchical_ordered_fonts.py``: the two-stage VAE model with
dim_z 128 and label conditioning (``n_labels`` 100 ids, the glyph classes
0-9, A-Z, a-z among them through ``filter_uni``), batch 60 and lr 2e-4 per
device. On the card the label's injection enters every layer kernel as its
``seq_bias`` (K2, K4; summed with the latent's in the decoders) and the K7
stacks as their per-layer biases."""
import dataclasses

from deepsvg_tpu_torch.models.config import gpu_fast, hierarchical

from .defaults_fonts import Config as FontsConfig


def make_model_config():
    return gpu_fast(dataclasses.replace(hierarchical(), label_condition=True, dim_z=128))


class Config(FontsConfig):
    def __init__(self, num_devices=2):
        super().__init__(num_devices=num_devices)

        self.model_cfg = make_model_config()
        self.model_args = self.model_cfg.get_model_args()

        # 0-9, A-Z, a-z codepoints
        self.filter_uni = [
            *range(48, 58), *range(65, 91), *range(97, 123),
        ]

        self.learning_rate = 2e-4 * num_devices
        self.batch_size = 60 * num_devices

        self.val_every = 2000
