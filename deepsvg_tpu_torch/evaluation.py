"""Quantitative reconstruction evaluation for trained models (counterpart of
``deepsvg_tpu/evaluation.py``).

Held-out reconstruction metrics computed from in-repo parts:

  vis_acc    group-visibility accuracy (predicted vs ground-truth groups)
  cmd_acc    command-type accuracy over ground-truth valid positions
  args_mae   mean |pred - gt| over valid argument slots (quantized units,
             grid 0..255)
  chamfer    symmetric Chamfer distance between the union point clouds of
             the input and its greedy reconstruction (difflib sampling,
             quantized units)
  emd        reference-style EMD (``difflib.loss.svg_emd_loss``) per group,
             matched by group index (the flagship orders groups), averaged
             over groups visible in BOTH gt and prediction. Noise floor ~0.1
             quantized units at identity (nearest-point arc-length
             resampling)

Everything is fixed-shape and batched over the leading dims; geometry uses
the padded Bézier sampler (``difflib.sample.sample_points_padded``) with
validity masks, so the whole evaluation runs on the device of its inputs.
The two all-pairs distance computations (the Chamfer clouds, the pairwise
EMD of ``match_groups``) run over blocks of rows, which bounds their memory
at any batch.
"""
from __future__ import annotations

import torch

from .difflib.loss import svg_emd_loss
from .difflib.sample import get_length_distribution, nearest_fractions, sample_points_padded
from .difflib.utils import make_clockwise
from .models.matching import solve_assignment
from .models.sample import greedy_sample
from .svgtensor import masks as M

# elements of one block's largest [rows, n, m] intermediate (128 MB in float32)
_BLOCK_ELEMENTS = 1 << 25


def _blocks(n_rows: int, per_row: int):
    """Slices of at most ``_BLOCK_ELEMENTS // per_row`` rows (one at least)."""
    step = max(1, _BLOCK_ELEMENTS // max(per_row, 1))
    return [slice(i, min(i + step, n_rows)) for i in range(0, n_rows, step)]


def _masked_chamfer(x, xv, y, yv):
    """Symmetric Chamfer between masked point clouds, batched.

    x ``[..., n, 2]`` with bool validity ``xv [..., n]``; likewise y. Invalid
    points take part in neither the min nor the outer mean. Returns the
    distance ``[...]`` (0 where either cloud is empty) and whether both
    clouds have points ``[...]``.
    """
    # the two coordinates apart: no [..., n, m, 2] difference tensor, and the
    # same sum d0^2 + d1^2 as the JAX module's
    dx = x[..., :, None, 0] - y[..., None, :, 0]
    dy = x[..., :, None, 1] - y[..., None, :, 1]
    d = torch.sqrt(torch.maximum(dx * dx + dy * dy, dx.new_tensor(1e-12)))
    del dx, dy
    big = d.new_tensor(1e9)
    d_row = torch.where(yv[..., None, :], d, big)    # invalid targets excluded
    fwd_min = torch.amin(d_row, dim=-1)
    del d_row
    d_col = torch.where(xv[..., :, None], d, big)
    bwd_min = torch.amin(d_col, dim=-2)
    del d_col, d
    n_x, n_y = xv.sum(dim=-1), yv.sum(dim=-1)
    fwd = torch.where(xv, fwd_min, 0.0).sum(dim=-1) / n_x.clamp_min(1)
    bwd = torch.where(yv, bwd_min, 0.0).sum(dim=-1) / n_y.clamp_min(1)
    ok = (n_x > 0) & (n_y > 0)
    return torch.where(ok, fwd + bwd, 0.0), ok


def _group_contour(commands, args, n: int, m: int):
    """Fixed-shape contour of each group: ``m`` arc-length-uniform points.

    commands ``[..., S]``, args ``[..., S, n_args]``. Samples ``n`` points
    per l/c command (reference layout: each segment keeps its first ``n-1``
    points), forward-fills invalid slots to the previous valid point
    (zero-length segments, so they never move the arc-length
    parameterization) and leading invalid slots to the first valid one,
    orients the contour clockwise, then resamples ``m`` uniform fractions.
    Returns (points ``[..., m, 2]``, valid point count ``[...]``).
    """
    pts, valid = sample_points_padded(commands, args, n)             # [..., S, n, 2], [..., S]
    flat = pts[..., : n - 1, :].reshape(pts.shape[:-3] + (-1, 2))   # [..., S*(n-1), 2]
    vflat = valid.repeat_interleave(n - 1, dim=-1)
    idx = torch.arange(flat.shape[-2], device=flat.device)
    last = torch.cummax(torch.where(vflat, idx, -1), dim=-1).values
    first = torch.argmax(vflat.to(torch.uint8), dim=-1)              # the first valid slot
    src = torch.where(last >= 0, last.clamp_min(0), first[..., None])
    flat = torch.take_along_dim(flat, src[..., None], dim=-2)
    # canonical orientation so identical inputs score ~0 (svg_emd_loss
    # re-orients only its target)
    flat = make_clockwise(flat)
    take = nearest_fractions(get_length_distribution(flat, normalize=True), m)
    return torch.take_along_dim(flat, take[..., None], dim=-2), vflat.sum(dim=-1)


def _pairwise_emd(prd, tgt):
    """``pair [N, G_target, G_pred]``: the EMD of each predicted contour
    against each target contour of its sample, over blocks of samples."""
    n, g, m = tgt.shape[:3]
    return torch.cat([svg_emd_loss(prd[b, None, :], tgt[b, :, None])
                      for b in _blocks(n, g * g * m * m)], dim=0)


@torch.no_grad()
def recon_metrics(gt_commands: torch.Tensor, gt_args: torch.Tensor, pr_commands: torch.Tensor,
                  pr_args: torch.Tensor, points_per_cmd: int = 5, emd_points: int = 48,
                  match_groups: bool = False) -> dict:
    """Batched reconstruction metrics on the inputs' device; returns summed
    numerators and counts (0-dim float32 tensors) so batches aggregate
    exactly (see :func:`evaluate_batches`).

    ``gt_commands [N, G, S]`` (SOS already dropped), ``gt_args [N, G, S,
    n_args]``, ``pr_commands`` / ``pr_args`` likewise. ``match_groups=False``
    pairs prediction group i with ground-truth group i: correct for the
    flagship ordered model, whose decoder emits groups in the canonical
    dataset order. ``match_groups=True`` instead matches groups by pairwise
    EMD (``models.matching.solve_assignment``: exact brute force on the
    device for G <= 8, scipy beyond), as a self-matching model's arbitrary
    group order needs; ``cmd_acc``, ``args_mae`` and ``vis_acc`` are then
    scored under the matched permutation too."""
    gt_commands, pr_commands = gt_commands.long(), pr_commands.long()
    gt_args, pr_args = gt_args.float(), pr_args.float()
    n = points_per_cmd
    vis_gt = M.visibility_mask(gt_commands)                # [N, G]
    vis_pr = M.visibility_mask(pr_commands)

    # per-group contours (shared by both EMD modes)
    tgt, n_t = _group_contour(gt_commands, gt_args, n, emd_points)   # [N, G, m, 2]
    prd, n_p = _group_contour(pr_commands, pr_args, n, emd_points)
    ok_t = (n_t >= 2) & vis_gt
    ok_p = (n_p >= 2) & vis_pr

    if match_groups:
        # pairwise EMD [N, G_target, G_pred] -> minimal-cost assignment
        pair = _pairwise_emd(prd, tgt)
        cost = torch.where(ok_p[:, None, :], pair, 1e6)    # bar dead predictions
        assign = solve_assignment(cost, ok_t).long()        # [N, G]
        emd = torch.take_along_dim(pair, assign[:, :, None], dim=2)[..., 0]
        emd_ok = ok_t & torch.take_along_dim(ok_p, assign, dim=1)
        # the predictions in target order, so that the token metrics below
        # score the matched pairs
        pr_commands = torch.take_along_dim(pr_commands, assign[:, :, None], dim=1)
        pr_args = torch.take_along_dim(pr_args, assign[:, :, None, None], dim=1)
        vis_pr = torch.take_along_dim(vis_pr, assign, dim=1)
    else:
        # index-matched (flagship: the decoder emits groups in dataset order)
        emd = svg_emd_loss(prd, tgt)
        emd_ok = ok_t & ok_p

    pad = M.padding_mask(gt_commands)                      # [N, G, S]
    cmd_hit = (pr_commands == gt_commands).float() * pad
    amask = (M.cmd_args_mask(gt_commands.device)[gt_commands] * pad[..., None]) * (gt_args >= 0)
    mae = torch.abs(pr_args - gt_args) * amask

    # geometry: the union point cloud of each sample (permutation-invariant)
    pts_g, val_g = sample_points_padded(gt_commands, gt_args, n)
    pts_p, val_p = sample_points_padded(pr_commands, pr_args, n)
    rows = gt_commands.shape[0]
    xg, vg = pts_g.reshape(rows, -1, 2), val_g.reshape(rows, -1).repeat_interleave(n, dim=-1)
    xp, vp = pts_p.reshape(rows, -1, 2), val_p.reshape(rows, -1).repeat_interleave(n, dim=-1)
    parts = [_masked_chamfer(xg[b], vg[b], xp[b], vp[b])
             for b in _blocks(rows, xg.shape[1] * xp.shape[1])]
    chamfer = torch.cat([c for c, _ in parts])
    cham_ok = torch.cat([ok for _, ok in parts])

    f32 = torch.float32
    return {
        "vis_hit": torch.sum(vis_gt == vis_pr).to(f32),
        "vis_cnt": torch.tensor(float(vis_gt.numel()), device=vis_gt.device),
        "cmd_hit": torch.sum(cmd_hit),
        "cmd_cnt": torch.sum(pad),
        "mae_sum": torch.sum(mae),
        "mae_cnt": torch.sum(amask),
        "chamfer_sum": torch.sum(torch.where(cham_ok, chamfer, 0.0)),
        "chamfer_cnt": torch.sum(cham_ok).to(f32),
        "emd_sum": torch.sum(torch.where(emd_ok, emd, 0.0)),
        "emd_cnt": torch.sum(emd_ok).to(f32),
    }


def _ratios(acc: dict) -> dict:
    den = lambda k: max(float(acc[k]), 1e-9)  # noqa: E731
    return {
        "vis_acc": float(acc["vis_hit"]) / den("vis_cnt"),
        "cmd_acc": float(acc["cmd_hit"]) / den("cmd_cnt"),
        "args_mae": float(acc["mae_sum"]) / den("mae_cnt"),
        "chamfer": float(acc["chamfer_sum"]) / den("chamfer_cnt"),
        "emd": float(acc["emd_sum"]) / den("emd_cnt"),
        "n_groups_emd": float(acc["emd_cnt"]),
    }


@torch.no_grad()
def reconstruct(model, commands, args, label=None):
    """Encode + greedy decode one batch through ``greedy_sample`` (on CUDA
    tensors the kernels' path); returns (commands, args) aligned to the
    ground truth's post-SOS layout ``[N, G, S+1]``.

    A VAE encodes to its posterior mean (``sample_vae=False``), so the
    metric is deterministic."""
    z, _, _ = model.encode(commands, args, label, sample_vae=False)
    return greedy_sample(model, z=z.float(), label=label)


def evaluate_batches(model, batches, *, points_per_cmd: int = 5, emd_points: int = 48,
                     match_groups: bool = False, verbose: bool = False) -> dict:
    """Run the reconstruction metrics over an iterable of batches on the
    model's device.

    Each batch is a dict with ``commands [N, G, S+2]`` (SOS+content+EOS),
    ``args``, optional ``label`` (numpy arrays or tensors). Returns the
    aggregated metric dict plus ``n_samples``. ``match_groups=True`` for
    permutation-invariant (self-matching) models: see
    :func:`recon_metrics`.
    """
    dev = next(model.parameters()).device
    acc: dict = {}
    n_samples = 0
    for batch in batches:
        gt_c = torch.as_tensor(batch["commands"], device=dev).to(torch.int32)
        gt_a = torch.as_tensor(batch["args"], device=dev).to(torch.float32)
        label = (torch.as_tensor(batch["label"], device=dev).to(torch.int32)
                 if "label" in batch else None)
        pr_c, pr_a = reconstruct(model, gt_c, gt_a, label=label)
        # align: drop the gt SOS column -> [N, G, S+1]
        m = recon_metrics(gt_c[..., 1:], gt_a[..., 1:, :], pr_c, pr_a,
                          points_per_cmd=points_per_cmd, emd_points=emd_points,
                          match_groups=match_groups)
        acc = {k: acc.get(k, 0.0) + float(v) for k, v in m.items()}
        n_samples += int(gt_c.shape[0])
        if verbose:
            print(f"  evaluated {n_samples} samples", flush=True)
    out = _ratios(acc)
    out["n_samples"] = n_samples
    return out
