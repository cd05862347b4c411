"""Device mesh and data parallelism over ``torch.distributed``, counterpart
of ``deepsvg_tpu/parallel/mesh.py``.

One process per card (``torchrun --nproc-per-node N``): NCCL between cards,
gloo on the CPU (and for several ranks on one card, which NCCL refuses). The
mesh is a ``DeviceMesh`` over the ranks, 1-D ``("data",)`` or 2-D
``("data", "model")``. Where the JAX package's single controller shards one
global batch over its devices, here every rank reads the same global batch
in the same order and keeps its own rows (:func:`shard_batch`), so the data
order and the step count are those of one device.

The data-parallel step is the port's ``train_step`` on the rank's rows,
through the same kernels (K1, K4/K7, K5, K6), with the JAX semantics of
``shard_map`` over ``train_step(axis_name=...)``: the loss's numerators and
denominators summed across the ranks and its KL and visibility means
averaged (``models/loss.py``), each rank's dropout and VAE noise from a
stream of its own, the gradients summed, and the same update on every rank.
"""
from __future__ import annotations

import os
from functools import partial
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..training.trainer import train_multi_step, train_resident_multi_step, train_step


def init_distributed(device_type: str = "cuda") -> None:
    """Join the process group that ``torchrun`` describes in the
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``),
    unless this process has joined one: NCCL for the card, gloo for the CPU.
    On the card each process takes the card of its ``LOCAL_RANK``."""
    if dist.is_initialized():
        return
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo")


def make_mesh(n_devices: Optional[int] = None, data_axis: str = "data",
              model_axis: Optional[str] = None, n_model: int = 1) -> DeviceMesh:
    """A 1-D (data) or 2-D (data x model) mesh over the ranks of the
    default process group, one device each. ``n_devices`` must be the world
    size: a rank is a process, and every process takes part."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} processes, one per device; this "
                         f"process group has {world} (launch with torchrun "
                         f"--nproc-per-node {n})")
    # the mesh's device type follows the backend: gloo ranks may share a card
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if model_axis is None:
        return init_device_mesh(device_type, (n,), mesh_dim_names=(data_axis,))
    if n % n_model:
        raise ValueError(f"{n} devices do not split into a model axis of {n_model}")
    return init_device_mesh(device_type, (n // n_model, n_model),
                            mesh_dim_names=(data_axis, model_axis))


def batch_sharding(mesh: DeviceMesh, data_axis: str = "data", batch_dim: int = 0) -> tuple:
    """The placements of a batch on ``mesh``: its ``batch_dim`` split over
    the data axis, replicated over any other (``batch_dim=1`` serves
    step-stacked ``[K, B, ...]`` batches)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(batch_dim) if name == data_axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    """The placements of a tensor that every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def shard_batch(batch: dict, mesh: DeviceMesh, data_axis: str = "data",
                batch_dim: int = 0) -> dict:
    """This rank's rows of the global ``batch`` (a dict of tensors or
    arrays): its block of ``batch_dim`` on the data axis, as
    :func:`batch_sharding` places it."""
    n = mesh.size(mesh.mesh_dim_names.index(data_axis))
    r = mesh.get_local_rank(data_axis)

    def rows(x):
        x = torch.as_tensor(x)
        size = x.shape[batch_dim]
        if size % n:
            raise ValueError(f"a batch of {size} rows does not split over {n} data ranks")
        return x.narrow(batch_dim, r * (size // n), size // n)

    return {k: rows(v) for k, v in batch.items()}


def global_batch_from_local(batch: dict, mesh: DeviceMesh, data_axis: str = "data") -> dict:
    """Each process's own rows as its part of the global batch (per-host
    loaders feeding disjoint index ranges, e.g. ``indices[rank::world]``):
    with one process per device they are what the data-parallel step takes.
    Raises unless every rank of the data axis holds as many rows."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    group = mesh.get_group(data_axis)
    rows = next(iter(batch.values())).shape[0]
    counts = torch.tensor([rows, -rows], dtype=torch.int64)
    if dist.get_backend(group) == "nccl":
        counts = counts.cuda()
    dist.all_reduce(counts, op=dist.ReduceOp.MAX, group=group)
    if int(counts[0]) != rows or int(counts[1]) != -rows:
        raise ValueError(f"the data ranks hold different numbers of rows (this one {rows})")
    return batch


def make_parallel_train_step(model, optimizer, model_args, mesh: DeviceMesh,
                             data_axis: str = "data"):
    """The data-parallel train step ``step(state, batch, weights)``: the
    port's ``train_step`` on this rank's rows (:func:`shard_batch` of the
    global batch) with the data axis's group. ``model`` is the state's."""
    return partial(train_step, optimizer=optimizer, model_args=model_args,
                   group=mesh.get_group(data_axis))


def make_parallel_multi_step(model, optimizer, model_args, mesh: DeviceMesh, weights_fn,
                             data_axis: str = "data"):
    """K data-parallel train steps per call, ``multi(state, batches)`` on
    this rank's rows of a ``[K, B, ...]`` stacked batch dict
    (``shard_batch(..., batch_dim=1)``), the loss weights of each step from
    ``weights_fn(step)``."""
    return partial(train_multi_step, weights_fn=weights_fn, optimizer=optimizer,
                   model_args=model_args, group=mesh.get_group(data_axis))


def make_parallel_resident_multi_step(model, optimizer, model_args, mesh: DeviceMesh,
                                      weights_fn, n_augs: int = 1, data_axis: str = "data",
                                      item_shapes: dict | None = None):
    """Data-parallel device-resident training, ``multi(state, data, idx)``:
    the wire-format corpus ``data`` whole on every rank, ``idx`` this rank's
    columns of the ``[K, B]`` icon indices (``shard_batch(..., batch_dim=1)``),
    each step's ``B/n`` rows gathered on the device, the augmentation drawn
    per (step, rank, item). ``item_shapes``: rows arrive flattened and are
    reshaped after the gather (``trainer.gather_batch``)."""
    group = mesh.get_group(data_axis)

    def multi(state, data, idx):
        return train_resident_multi_step(state, data, idx, weights_fn, optimizer, model_args,
                                         n_augs, item_shapes, group)

    return multi
