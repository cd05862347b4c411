"""Batches for training: shuffled epochs, worker threads or processes, the
narrow-integer wire format and host-to-device prefetch. Counterpart of
``deepsvg_tpu/data/loader.py``: the same batches in the same order for the
same seed.

Batches travel in narrow integer types (:func:`compress_batch`); the
training step restores the canonical ones on the device
(:func:`decompress_batch`).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..svgtensor.masks import cmd_args_mask


def collate(items: list[dict]) -> dict:
    """Stack a list of per-item dicts into one batch dict of arrays."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if vals[0] is None:
            continue
        out[k] = np.stack([np.asarray(v) for v in vals])
    return out


# every model input is small-integer-valued (commands 0..6, quantized
# arguments -1..255), so batches travel as narrow integers
_WIRE_DTYPES = {
    "commands": np.int8,
    "commands_grouped": np.int8,
    "args": np.int16,
    "args_grouped": np.int16,
    "args_rel": np.int16,
    "args_rel_grouped": np.int16,
    "filling": np.int8,
}

# absolute arguments are {-1} and [0, 255]; the -1s sit exactly where the
# command does not use the argument, so the wire carries uint8 and the -1s are
# rebuilt from the matching commands tensor
_MASKED_ARGS_WIRE = {"args": "commands", "args_grouped": "commands_grouped"}


def compress_batch(batch: dict) -> dict:
    """Cast batch entries to the narrow wire dtypes (exact: all values are
    whole numbers in range). Keys not in the table pass through."""
    out = {}
    for k, v in batch.items():
        ck = _MASKED_ARGS_WIRE.get(k)
        if ck is not None and ck in batch:
            out[k] = v if v.dtype == np.uint8 else np.maximum(v, 0).astype(np.uint8)
            continue
        w = _WIRE_DTYPES.get(k)
        out[k] = v.astype(w) if (w is not None and v.dtype != w) else v
    return out


def decompress_batch(batch: dict) -> dict:
    """int32 commands, float32 arguments (a uint8 arguments tensor gets its
    -1s back from ``CMD_ARGS_MASK``). Entries already canonical pass through,
    so the step may call this on any batch."""
    out = {}
    for k, v in batch.items():
        out[k] = v.to(torch.int32) if k.startswith("commands") and v.dtype != torch.int32 else v
    for k, v in batch.items():
        if not k.startswith("args") or v.dtype.is_floating_point:
            continue
        if v.dtype == torch.uint8:
            used = cmd_args_mask(v.device, torch.bool)[out[_MASKED_ARGS_WIRE[k]].long()]
            out[k] = torch.where(used, v.to(torch.float32), -1.0)
        else:
            out[k] = v.to(torch.float32)
    return out


_PROC_DATASET = None


def _proc_init(pickled_dataset):
    """Pool initializer: unpickle the dataset once per worker process."""
    global _PROC_DATASET
    import pickle

    _PROC_DATASET = pickle.loads(pickled_dataset)


def _proc_collate(indices):
    return collate([_PROC_DATASET[int(i)] for i in indices])


class DataLoader:
    """Epoch iterator: shuffle, batch, drop_last, worker prefetch.

    Epoch ``e`` (counted from 1 by the calls of ``iter``) is shuffled by
    ``np.random.default_rng(seed + e)``. ``worker_mode``: ``"thread"`` for
    datasets whose packing is numpy (it releases the GIL); ``"process"``
    (spawned processes, the dataset pickled to each once) for pure-Python
    per-item work.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4, prefetch: int = 4,
                 seed: int = 0, worker_mode: str = "thread"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.seed = seed
        self.worker_mode = worker_mode
        self._epoch = 0
        self._pool = None

    def _get_pool(self):
        if self._pool is None:
            import multiprocessing as mp
            import pickle

            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(self.num_workers, initializer=_proc_init,
                                  initargs=(pickle.dumps(self.dataset),))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def index_batches(self, epoch: int) -> list:
        """The index batches of epoch ``epoch`` (counted from 1)."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        batches = [idx[i:i + self.batch_size] for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        yield from self.epoch_batches(self._epoch)

    def epoch_batches(self, epoch: int, skip: int = 0) -> Iterator[dict]:
        """The batches of epoch ``epoch`` (counted from 1), from its
        ``skip``-th on."""
        batches = self.index_batches(epoch)[skip:]
        # a dataset that serves a whole batch as one fancy-index per key
        fast = getattr(self.dataset, "get_batch_arrays", None)
        if fast is not None:
            for b in batches:
                yield fast(b)
            return
        if self.num_workers <= 1:
            for b in batches:
                yield collate([self.dataset[int(i)] for i in b])
            return
        if self.worker_mode == "process":
            yield from self._get_pool().imap(_proc_collate, batches, chunksize=1)
            return

        # thread workers claim batches in order; the batches are handed out
        # in order
        results: dict[int, dict] = {}
        results_cv = threading.Condition()
        claim_lock = threading.Lock()
        claimed = iter(enumerate(batches))

        def worker():
            while True:
                with claim_lock:
                    nxt = next(claimed, None)
                if nxt is None:
                    return
                slot, b = nxt
                batch = collate([self.dataset[int(i)] for i in b])
                with results_cv:
                    results[slot] = batch
                    results_cv.notify_all()

        for _ in range(self.num_workers):
            threading.Thread(target=worker, daemon=True).start()
        for slot in range(len(batches)):
            with results_cv:
                while slot not in results:
                    results_cv.wait()
                batch = results.pop(slot)
            yield batch


def to_device(batch: dict, device, keys=None) -> dict:
    """Host arrays -> tensors on ``device``: through pinned memory with
    non-blocking copies when the device is a CUDA card."""
    out = {}
    for k, v in batch.items():
        if keys is not None and k not in keys:
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if torch.device(device).type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class _StagerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_to_device(iterator, device, size: int = 2, keys=None, stack_steps: int = 0,
                       compress: bool = True):
    """Stage upcoming host batches on ``device`` ahead of the loop, on one
    background thread: keep ``keys``, cast to the wire format, stack
    ``stack_steps`` batches into one ``[K, ...]`` array per key (a ragged
    tail is dropped, as ``drop_last``), copy through pinned memory without
    blocking. At most ``size`` staged batches wait. The copies go to the
    device's current stream, so the step that reads a batch is ordered after
    its copy. The thread stops when the loop stops reading."""
    staged: queue.Queue = queue.Queue(maxsize=max(size, 1))
    stop = threading.Event()
    end = object()

    def host_batches():
        pending = []
        for batch in iterator:
            if keys is not None:
                batch = {k: v for k, v in batch.items() if k in keys}
            if compress:
                batch = compress_batch(batch)
            if stack_steps < 1:
                yield batch
                continue
            pending.append(batch)
            if len(pending) == stack_steps:
                yield {k: np.stack([b[k] for b in pending]) for k in pending[0]}
                pending = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                staged.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stager():
        try:
            for batch in host_batches():
                if not put(to_device(batch, device)):
                    return
            put(end)
        except BaseException as e:  # surface in the consumer
            put(_StagerError(e))

    thread = threading.Thread(target=stager, daemon=True)
    thread.start()
    try:
        while True:
            item = staged.get()
            if item is end:
                return
            if isinstance(item, _StagerError):
                raise item.exc
            yield item
    finally:
        stop.set()
        thread.join()
