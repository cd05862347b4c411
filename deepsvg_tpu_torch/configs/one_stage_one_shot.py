"""The one-stage one-shot baseline, counterpart of
``configs_tpu/one_stage_one_shot.py``: the whole icon encoded as one sequence
with the group-index embedding, ResNet + VAE, and one decoder over
``max_total_len + 1`` = 241 constant queries with the latent injected in
every layer, trained with the icons config's recipe (B=60, lr 1e-3, the KL
ramp). On the card its encoder (S = 242 with SOS and EOS) and its decoder
(S = 241, not causal, the latent's injection as ``seq_bias``) run the long
forms of the layer kernels, K2 at inference and K4 when training.

The decoder predicts every one of the 241 positions at once, so the targets
must have that length: the data budget here is the model's
``max_total_len`` (240). The icons config's budget of 50 gives targets of 52
positions, which do not fit the decoder's output (in the JAX config too)."""
from deepsvg_tpu_torch.models.config import gpu_fast, one_stage_one_shot

from .default_icons import Config as IconsConfig


def make_model_config():
    return gpu_fast(one_stage_one_shot())


class Config(IconsConfig):
    def __init__(self, num_devices=1):
        super().__init__(num_devices=num_devices)
        self.model_cfg = make_model_config()
        self.model_args = self.model_cfg.get_model_args()
        self.max_total_len = self.model_cfg.max_total_len
