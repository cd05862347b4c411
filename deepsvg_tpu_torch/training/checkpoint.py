"""Checkpoints of training, counterpart of ``deepsvg_tpu/training/checkpoint.py``.

A training checkpoint ``{step:06d}.ckpt`` holds the whole state (parameters,
optimizer state, step, the step generator), the config, the stats, the
training variables and the loop's place in its epoch, so a resumed run
continues exactly where the saved one was. The container is the JAX
package's v2 format: the magic line ``DSVGCKPT2``, then a JSON metadata blob
and a JSON manifest (``[shape, dtype]`` per leaf), each after its 8-byte
little-endian length, then the raw bytes of every leaf. The leaves are the
port's own, in this order: the parameters (``named_parameters`` order), then
for each optimizer label its ``mu``, ``nu``, ``count`` and ``calls``, then
the step and the state of the step generator. A weights-only file
(:func:`save_model`) is flax msgpack, which the JAX package's ``load_model``
reads.

Saving is split for a write-behind worker. The optimizer updates the
parameters in place, so :func:`begin_save` copies the state on the device,
on the current stream, before the next step is enqueued (one concatenation
per dtype), and starts a non-blocking copy of that snapshot into pinned host
memory; :func:`finish_save` waits for that copy alone and writes the file.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..models.checkpoint import load_params, save_params
from ..models.weights import load_flax_params, to_flax_params

_CKPT_MAGIC = b"DSVGCKPT2\n"


def _ckpt_path(checkpoint_dir: str, step: int) -> str:
    return os.path.join(checkpoint_dir, f"{step:06d}.ckpt")


def _opt_groups(opt_state: dict) -> list:
    """The optimizer state of each label (one, for a single optimizer)."""
    return [opt_state] if "mu" in opt_state else [opt_state[k] for k in opt_state]


def state_leaves(state) -> list:
    """The state's leaves in checkpoint order: tensors, and Python ints as
    0-d int64 arrays."""
    leaves = list(state.parameters())
    for group in _opt_groups(state.opt_state):
        leaves += list(group["mu"]) + list(group["nu"])
        leaves += [np.int64(group["count"]), np.int64(group["calls"])]
    leaves += [np.int64(state.step), state.generator.get_state()]
    return leaves


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return repr(v)


def _snapshot(leaves: list):
    """Copy the device leaves now (one concatenation per device and dtype,
    on the current stream) and start their copy into pinned host memory.
    Returns what :func:`_fetch` needs."""
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        if torch.is_tensor(leaf):
            groups.setdefault((leaf.device, leaf.dtype), []).append(i)
    packed = {}
    for (dev, dtype), idx in groups.items():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        if dev.type == "cuda":
            host = torch.empty(flat.shape, dtype=dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            packed[(dev, dtype)] = (host, done, flat)
        else:
            packed[(dev, dtype)] = (flat, None, None)
    meta = [(tuple(leaf.shape), leaf.dtype) if torch.is_tensor(leaf) else leaf
            for leaf in leaves]
    return groups, packed, meta


def _fetch(snap) -> list:
    """The snapshot's leaves as numpy arrays, once its copy has arrived."""
    groups, packed, meta = snap
    out = list(meta)
    for key, idx in groups.items():
        host, done, _ = packed[key]
        if done is not None:
            done.synchronize()
        buf, off = host.numpy(), 0
        for i in idx:
            shape = meta[i][0]
            n = int(np.prod(shape, dtype=np.int64))
            out[i] = buf[off:off + n].reshape(shape)
            off += n
    return [np.asarray(leaf) for leaf in out]


def begin_save(checkpoint_dir: str, state, cfg=None, stats=None, train_vars=None,
               best: bool = True, step: Optional[int] = None, position=None):
    """The part of a save that must happen at save time: the metadata (the
    config, stats and training variables change as training goes on) and a
    device snapshot of the state. Returns the context of
    :func:`finish_save`, which a worker may complete while training goes on.
    ``position``: the loop's ``(epoch, batches done in that epoch)``."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    step = state.step if step is None else step
    meta_bytes = json.dumps({
        "step": step,
        "position": list(position) if position is not None else None,
        "cfg": cfg.to_dict() if cfg is not None else None,
        "stats": stats.to_dict() if stats is not None else None,
        "train_vars": train_vars.to_dict() if train_vars is not None else None,
    }, default=_jsonable).encode()
    return checkpoint_dir, step, meta_bytes, _snapshot(state_leaves(state)), best


def finish_save(ctx) -> str:
    """Complete a :func:`begin_save`: fetch the snapshot, write the file
    atomically, point ``best.ckpt`` at it. Returns the checkpoint's path."""
    checkpoint_dir, step, meta_bytes, snap, best = ctx
    leaves = _fetch(snap)
    path = _ckpt_path(checkpoint_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        manifest = json.dumps([[list(a.shape), a.dtype.name] for a in leaves]).encode()
        f.write(_CKPT_MAGIC)
        for blob in (meta_bytes, manifest):
            f.write(len(blob).to_bytes(8, "little"))
            f.write(blob)
        for a in leaves:
            f.write(memoryview(np.ascontiguousarray(a)).cast("B"))
    os.replace(tmp, path)
    if best:
        # checkpoint files are written once, so best.ckpt may share the inode
        best_path = os.path.join(checkpoint_dir, "best.ckpt")
        tmp_best = best_path + ".tmp"
        try:
            if os.path.lexists(tmp_best):
                os.remove(tmp_best)
            os.link(path, tmp_best)
            os.replace(tmp_best, best_path)
        except OSError:
            shutil.copyfile(path, best_path)
    return path


def save_ckpt(checkpoint_dir: str, state, cfg=None, stats=None, train_vars=None,
              best: bool = True, position=None) -> str:
    """Save the whole training state at ``state.step``, synchronously."""
    return finish_save(begin_save(checkpoint_dir, state, cfg, stats, train_vars, best,
                                  position=position))


def latest_ckpt(checkpoint_dir: str) -> Optional[str]:
    files = sorted(glob.glob(os.path.join(checkpoint_dir, "[0-9]" * 6 + ".ckpt")))
    return files[-1] if files else None


def prune_ckpts(checkpoint_dir: str, keep_last: Optional[int],
                keep_every: Optional[int] = None) -> list:
    """Keep the newest ``keep_last`` step checkpoints and the first
    checkpoint at or after every multiple of ``keep_every`` (cadences are
    rounded to the K-step loop, so steps rarely land on the multiple);
    ``best.ckpt`` is never touched; ``keep_last=None`` keeps everything.
    Returns the deleted paths."""
    if keep_last is None:
        return []
    files = sorted(glob.glob(os.path.join(checkpoint_dir, "[0-9]" * 6 + ".ckpt")))
    deleted, prev_bucket = [], None
    last_window = set(files[max(len(files) - max(keep_last, 1), 0):])
    for path in files:
        step = int(os.path.basename(path).split(".")[0])
        if keep_every:
            bucket = step // keep_every
            first_in_bucket = bucket != prev_bucket
            prev_bucket = bucket
            if first_in_bucket:
                continue
        if path in last_window:
            continue
        os.remove(path)
        deleted.append(path)
    return deleted


def _read(f, leaves: list):
    meta = json.loads(f.read(int.from_bytes(f.read(8), "little")).decode())
    manifest = json.loads(f.read(int.from_bytes(f.read(8), "little")).decode())
    if len(manifest) != len(leaves):
        raise ValueError(f"checkpoint has {len(manifest)} leaves, the state {len(leaves)}: "
                         "structure mismatch")
    buf, off, out = f.read(), 0, []
    for i, ((shape, dtype_name), leaf) in enumerate(zip(manifest, leaves)):
        dt = np.dtype(dtype_name)
        want = ((tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
                if torch.is_tensor(leaf) else ((), np.asarray(leaf).dtype.name))
        if (tuple(shape), dt.name) != want:
            raise ValueError(f"checkpoint leaf {i} is {dt.name}{tuple(shape)}, the state "
                             f"expects {want[1]}{want[0]}: wrong config for this checkpoint?")
        n = int(np.prod(shape, dtype=np.int64))
        out.append(np.frombuffer(buf, dt, count=n, offset=off).reshape(shape))
        off += n * dt.itemsize
    return out, meta


@torch.no_grad()
def load_ckpt(path_or_dir: str, state, cfg=None, stats=None, train_vars=None,
              extra: Optional[dict] = None):
    """Restore ``state`` in place (and ``cfg``, ``stats``, ``train_vars``)
    from a checkpoint file or the newest in a directory. Returns
    ``(state, found)``; ``extra``, if given, receives the saved ``step`` and
    ``position``."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = latest_ckpt(path_or_dir)
        if path is None:
            return state, False
    if not os.path.exists(path):
        return state, False
    leaves = state_leaves(state)
    with open(path, "rb") as f:
        if f.read(len(_CKPT_MAGIC)) != _CKPT_MAGIC:
            raise ValueError(f"{path} is not a training checkpoint of this format")
        values, meta = _read(f, leaves)
    it = iter(values)
    for p in state.parameters():
        p.copy_(torch.from_numpy(next(it).copy()))
    for group in _opt_groups(state.opt_state):
        for key in ("mu", "nu"):
            for t in group[key]:
                t.copy_(torch.from_numpy(next(it).copy()))
        group["count"], group["calls"] = int(next(it)), int(next(it))
    state.step = int(next(it))
    state.generator.set_state(torch.from_numpy(next(it).copy()))
    if cfg is not None and meta.get("cfg"):
        cfg.load_dict(meta["cfg"])
    if stats is not None and meta.get("stats"):
        stats.load_dict(meta["stats"])
    if train_vars is not None and meta.get("train_vars"):
        train_vars.load_dict(meta["train_vars"])
    if extra is not None:
        extra.update(step=meta["step"], position=meta.get("position"))
    return state, True


def save_model(path: str, model) -> None:
    """Weights only, as the flax msgpack file of the JAX package's
    ``save_model`` (its ``load_model`` reads it)."""
    save_params(path, to_flax_params(model))


def load_model(path: str, model):
    """Load a weights-only file (the JAX package's or :func:`save_model`'s)
    into ``model``. Returns the model."""
    with open(path, "rb") as f:
        head = f.read(len(_CKPT_MAGIC))
    if head == _CKPT_MAGIC:
        raise ValueError(f"{path} is a training checkpoint (parameters and optimizer "
                         "state); restore it with load_ckpt")
    load_flax_params(model, load_params(path))
    return model
