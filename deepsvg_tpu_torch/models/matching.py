"""Hungarian (self-match) assignment of predicted paths to target paths,
counterpart of ``deepsvg_tpu/models/matching.py``.

The cost of pairing target group g with proposal p is
``2 * argument CE + command CE + visibility CE`` (masked means over the
target's positions), one batched ``[N, G, P]`` tensor in float32. For P <= 8
the assignment is exact on the device: every permutation is scored at once
and the lexicographically first optimum wins (``torch.argmin`` returns the
first minimum, as ``jnp.argmin`` does). Above 8, scipy's solver runs on the
host. Nothing here has a gradient: the matching is made under ``no_grad``.

With the fused path (:func:`fused_perfect_matching`) the argument CE of every
(proposal, target) pair comes from kernel K8 (``ops/ce.py``) straight off the
decoder states, so the ``[N, P, S, n_args, args_dim]`` logits never exist.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..ops import ce as ce_ops
from ..svgtensor import masks as M
from .config import ModelConfig

_PERM_CACHE: dict = {}


def _pair_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax CE of ``logits [N, P, ..., C]`` against ``labels [N, G,
    ...]`` for every (target g, proposal p) -> ``[N, G, P, ...]``, float32."""
    logits = logits.float()
    n, p = logits.shape[:2]
    g = labels.shape[1]
    lse = torch.logsumexp(logits, dim=-1)                                  # [N, P, ...]
    wide = logits[:, None].expand((n, g) + logits.shape[1:])
    idx = labels.long()[:, :, None].expand((n, g, p) + labels.shape[2:])
    return lse[:, None] - wide.gather(-1, idx[..., None])[..., 0]


def matching_cost(cmd_logits, args_logits, vis_logits, tgt_commands, tgt_args,
                  cfg: ModelConfig, args_ce_pair=None):
    """Pairwise (target group g, proposal p) loss ``cost [N, G, P]`` and the
    targets' visibility ``[N, G]``.

    ``cmd_logits [N, P, S, n_commands]``, ``args_logits [N, P, S, n_args,
    args_dim]`` (or None when ``args_ce_pair [N, G, P, S, n_args]``, the
    pairwise argument CE of kernel K8, is given), ``vis_logits [N, P, 2]``,
    targets with SOS ``[N, G, S+1]`` and ``[N, G, S+1, n_args]``.
    """
    vis = M.visibility_mask(tgt_commands)                                   # [N, G]
    pad = M.padding_mask(tgt_commands, extended=True) * vis[..., None].to(torch.float32)
    tgt_c, tgt_a, pad = tgt_commands[..., 1:], tgt_args[..., 1:, :], pad[..., 1:]

    ce_cmd = _pair_ce(cmd_logits, tgt_c)                                    # [N, G, P, S]
    if args_ce_pair is not None:
        ce_args = args_ce_pair.float()
    else:
        ce_args = _pair_ce(args_logits, tgt_a + 1)                          # [N, G, P, S, n_args]
    ce_vis = _pair_ce(vis_logits, vis)                                       # [N, G, P]

    args_mask = M.cmd_args_mask(tgt_c.device)[tgt_c.long()][:, :, None]    # [N, G, 1, S, n_args]
    loss_args = (ce_args * args_mask).sum(dim=(-1, -2)) \
        / args_mask.sum(dim=(-1, -2)).clamp_min(1.0)
    padb = pad[:, :, None]                                                  # [N, G, 1, S]
    loss_cmd = (ce_cmd * padb).sum(dim=-1) / padb.sum(dim=-1).clamp_min(1.0)
    return 2.0 * loss_args + 1.0 * loss_cmd + 1.0 * ce_vis, vis


def _permutations(p: int, device) -> torch.Tensor:
    """All permutations of ``range(p)`` in lexicographic order ``[p!, p]``,
    built once per device and kept there."""
    key = (p, str(device))
    if key not in _PERM_CACHE:
        perms = np.array(list(itertools.permutations(range(p))), np.int64)
        _PERM_CACHE[key] = torch.from_numpy(perms).to(device)
    return _PERM_CACHE[key]


def _totals(cost: torch.Tensor, vis: torch.Tensor):
    """The permutation table ``[K, P]`` and each permutation's total cost
    over the visible target rows ``[N, K]``."""
    g, p = cost.shape[1:]
    perms = _permutations(p, cost.device)                                   # [K, P]
    c = torch.where(vis[:, :, None], cost, torch.zeros_like(cost))
    picked = c[:, torch.arange(g, device=cost.device)[None, :], perms]      # [N, K, G]
    return perms, picked.sum(dim=-1)


def assign_bruteforce(cost: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """Exact assignment ``[N, P]`` for small P: every permutation's total
    over the visible target rows, and the lexicographically first optimum.
    Invisible rows cost 0, so their proposals are free and, since the first
    optimum wins, go to them in ascending order: the reference's
    ``assign + sorted(remaining)``."""
    perms, totals = _totals(cost, vis)
    return perms[torch.argmin(totals, dim=-1)].to(torch.int32)             # first optimum


@torch.no_grad()
def assignment_margin(cost: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """Per sample ``[N]``, how much more the best permutation that pairs a
    visible target row differently costs than the optimum (inf where no
    permutation does). Permutations that differ only on invisible rows tie
    with the optimum exactly, so the second-best total over all
    permutations is no margin. Two computations of the cost that differ by
    rounding pick the same assignment where the margin exceeds their
    difference. P <= 8."""
    perms, totals = _totals(cost, vis)
    best = torch.argmin(totals, dim=-1)                                     # [N]
    differs = ((perms[None] != perms[best][:, None]) & vis[:, None, :]).any(dim=-1)
    gap = totals - totals.gather(1, best[:, None])
    return torch.where(differs, gap, torch.full_like(gap, float("inf"))).min(dim=-1).values


def _assign_host(costs: np.ndarray, vis: np.ndarray) -> np.ndarray:
    """Assignment on the host with scipy's solver: over the visible target
    rows, then the remaining proposals in index order."""
    from scipy.optimize import linear_sum_assignment

    n, _, p = costs.shape
    out = np.zeros((n, p), dtype=np.int32)
    for i in range(n):
        _, assign = linear_sum_assignment(costs[i][vis[i].astype(bool)])
        assign = assign.tolist()
        out[i] = np.asarray(assign + sorted(set(range(p)) - set(assign)), dtype=np.int32)
    return out


def solve_assignment(cost: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """Assignment from ``cost [N, G, P]``: exact on the device for P <= 8,
    scipy on the host beyond (one synchronisation)."""
    if cost.shape[-1] <= 8:
        return assign_bruteforce(cost, vis)
    out = _assign_host(cost.detach().cpu().numpy(), vis.cpu().numpy())
    return torch.from_numpy(out).to(cost.device)


@torch.no_grad()
def perfect_matching(cmd_logits, args_logits, vis_logits, tgt_commands, tgt_args,
                     cfg: ModelConfig) -> torch.Tensor:
    """Assignment ``[N, P]`` from the logits: entry i is the proposal
    matched to the i-th target group."""
    cost, vis = matching_cost(cmd_logits, args_logits, vis_logits, tgt_commands, tgt_args, cfg)
    return solve_assignment(cost, vis)


@torch.no_grad()
def fused_perfect_matching(states, wa, ba, cmd_logits, vis_logits, tgt_commands, tgt_args,
                           cfg: ModelConfig, weight_dtype=None) -> torch.Tensor:
    """:func:`perfect_matching` without the argument logits: ``states [N, P,
    S, D]`` and the argument head (``wa [n_args*args_dim, D]``, ``ba``, master
    parameters cast to ``weight_dtype``) go through kernel K8."""
    n, p, s, _ = states.shape
    g, n_args = tgt_commands.shape[1], tgt_args.shape[-1]
    # each (sample, proposal, position) against every target group at that
    # position, variant (= g) major: [N, P, S, G * n_args]
    t = (tgt_args[..., 1:, :] + 1).to(torch.int32).movedim(1, 2)           # [N, S, G, n_args]
    t = t[:, None].expand(n, p, s, g, n_args).reshape(n, p, s, g * n_args)
    ce = ce_ops.args_ce_pairwise(states, wa, ba, t, g, weight_dtype)      # [N, P, S, G*n_args]
    ce_pair = ce.reshape(n, p, s, g, n_args).permute(0, 3, 1, 2, 4)       # [N, G, P, S, n_args]
    cost, vis = matching_cost(cmd_logits, None, vis_logits, tgt_commands, tgt_args, cfg,
                              args_ce_pair=ce_pair)
    return solve_assignment(cost, vis)


def apply_assignment(assignment: torch.Tensor, *logits: torch.Tensor) -> tuple:
    """Reorder the proposal axis (1) of each tensor by ``assignment [N, P]``."""
    out = []
    for x in logits:
        idx = assignment.long().reshape(assignment.shape + (1,) * (x.ndim - 2))
        out.append(torch.take_along_dim(x, idx, dim=1))
    return tuple(out)
