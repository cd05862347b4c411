"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks for the ``cuda`` fixture, which skips where
PyTorch sees no CUDA card. The file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Inputs are bfloat16, made from a seed with numpy, at small batches but the
flagship's widths (D=256, 8 heads of 32, FF 512, 11 x 257 argument classes).
Tolerances as in ``chip_smoke.py``: the kernel rounds to bfloat16 at the same
points as its plain version, but sums in another order.
"""
import numpy as np
import pytest
import torch

from deepsvg_tpu_torch.ops import embedding as emb_ops
from deepsvg_tpu_torch.ops import head as head_ops
from deepsvg_tpu_torch.ops import layer as layer_ops

pytestmark = pytest.mark.cuda

D, H, F_FF, N_ARGS, VOCAB, N_CMD = 256, 8, 512, 11, 257, 7
BF16 = torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bf16(rng, dev, *shape, scale=1.0):
    return torch.from_numpy(scale * rng.normal(size=shape).astype(np.float32)).to(dev, BF16)


@pytest.mark.parametrize("use_group", [False, True])
def test_embedding_kernel_matches_plain(cuda, use_group):
    rng = np.random.default_rng(0)
    b, s, n_group = 16, 32, 10
    commands = torch.from_numpy(rng.integers(0, N_CMD, (b, s)).astype(np.int32)).to(cuda)
    args = torch.from_numpy(rng.integers(-1, VOCAB - 1, (b, s, N_ARGS)).astype(np.float32)).to(cuda)
    groups = torch.from_numpy(rng.integers(0, n_group, (b, s)).astype(np.int32)).to(cuda)
    commands[1, 2], args[1, 3, 4], args[2, 1, 0], groups[3, 5] = N_CMD + 2, VOCAB + 5, -3, n_group
    inputs = (commands, args, groups, _bf16(rng, cuda, N_CMD, D),
              _bf16(rng, cuda, N_ARGS * VOCAB, D), _bf16(rng, cuda, n_group, D),
              _bf16(rng, cuda, s, D), use_group)
    before = emb_ops.fused_embedding.launches
    out = emb_ops.fused_embedding(*inputs)
    assert emb_ops.fused_embedding.launches == before + 1
    ref = emb_ops.embedding_reference(*inputs)
    assert out.dtype == BF16 and out.shape == (b, s, D)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2


@pytest.mark.parametrize("s,seq_bias,causal", [
    (32, False, False), (8, False, False), (31, True, False), (8, True, False),
    (31, True, True),
])
def test_layer_kernel_matches_plain(cuda, s, seq_bias, causal):
    rng = np.random.default_rng(s + 2 * seq_bias + causal)
    b = 12
    ln = lambda: torch.stack([1 + _bf16(rng, cuda, D, scale=0.1),  # noqa: E731
                              _bf16(rng, cuda, D, scale=0.1)]).contiguous()
    weights = (ln(), _bf16(rng, cuda, 3 * D, D, scale=D ** -0.5), _bf16(rng, cuda, 3 * D, scale=0.1),
               _bf16(rng, cuda, D, D, scale=D ** -0.5), _bf16(rng, cuda, D, scale=0.1), ln(),
               _bf16(rng, cuda, F_FF, D, scale=D ** -0.5), _bf16(rng, cuda, F_FF, scale=0.1),
               _bf16(rng, cuda, D, F_FF, scale=F_FF ** -0.5), _bf16(rng, cuda, D, scale=0.1))
    x = _bf16(rng, cuda, b, s, D)
    bias = _bf16(rng, cuda, b, D) if seq_bias else None
    lengths = torch.from_numpy(rng.integers(1, s + 1, b)).to(cuda)
    lengths[0] = 0                                     # one fully masked sequence
    mask = torch.where(torch.arange(s, device=cuda)[None] < lengths[:, None], 0.0,
                       float("-inf")).to(torch.float32)
    inputs = (x, bias, *weights, mask, H, causal)
    out = layer_ops.fused_layer(*inputs).float()
    ref = layer_ops.layer_reference(*inputs).float()
    assert torch.isfinite(out).all()
    err = (out - ref).abs()
    # up to one bf16 step of the output, plus flipped intermediates
    assert (err <= 0.1 + 2.0 ** -7 * ref.abs()).all()
    assert (err.norm() / ref.norm()).item() <= 1e-3


def test_head_kernel_matches_plain(cuda):
    rng = np.random.default_rng(4)
    r = 1000                                            # not a multiple of the row tile
    x = _bf16(rng, cuda, r, D)
    wc, bc = _bf16(rng, cuda, N_CMD, D, scale=D ** -0.5), _bf16(rng, cuda, N_CMD)
    wa = _bf16(rng, cuda, N_ARGS * VOCAB, D, scale=D ** -0.5)
    ba = _bf16(rng, cuda, N_ARGS * VOCAB)
    wc[5], bc[5] = wc[2], bc[2]                         # exact ties go to the first index
    wa[3 * VOCAB + 200], ba[3 * VOCAB + 200] = wa[3 * VOCAB + 17], ba[3 * VOCAB + 17]
    w, b = head_ops.pack_head(wc, bc, wa, ba, N_ARGS)
    ids = head_ops.fused_head_argmax(x, w, b, N_CMD, N_ARGS, VOCAB).long()
    ref = head_ops.head_argmax_reference(x, w, b, N_CMD, N_ARGS, VOCAB).long()
    assert ids.shape == (r, 1 + N_ARGS)
    assert not (ids[:, 0] == 5).any() and not (ids[:, 4] == 200).any()
    # ids may differ only where the two best logits are closer than 1e-2
    offsets = torch.tensor([0] + [head_ops._round_up(N_CMD) + i * head_ops._round_up(VOCAB)
                                  for i in range(N_ARGS)], device=cuda)
    logits = torch.matmul(x.float(), w.float().t()) + b.float()
    gap = logits.gather(1, offsets + ref) - logits.gather(1, offsets + ids)
    assert (gap.abs()[ids != ref] < 1e-2).all()


def test_kernels_refuse_float32_on_the_card(cuda):
    f32 = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    with pytest.raises(ValueError, match="dtype"):
        layer_ops.fused_layer(f32(2, 8, D), None, f32(2, D), f32(3 * D, D), f32(3 * D),
                              f32(D, D), f32(D), f32(2, D), f32(F_FF, D), f32(F_FF),
                              f32(D, F_FF), f32(D), f32(2, 8), H)
    with pytest.raises(ValueError, match="dtype"):
        head_ops.fused_head_argmax(f32(8, D), f32(16, D), f32(16), N_CMD, N_ARGS, VOCAB)
