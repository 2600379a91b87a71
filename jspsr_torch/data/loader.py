"""Host-side data loader (copy of ``jspsr_tpu/data/loader.py``):
deterministic sharded batching + threaded prefetch.

The same design as the JAX package's, in place of torch's DataLoader worker
pool (reference common_config.py:182-201), so that both packages draw the
same batches:

- index order is a pure function of (seed, epoch) -> reproducible shuffles;
- optional host sharding (process i takes indices i::num_shards) for
  multi-process feeding;
- a ThreadPoolExecutor decodes/augments batches ahead of consumption
  (raster decode releases the GIL in the IO backends), with a bounded
  prefetch queue for double buffering against device compute.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        collate=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.collate = collate or dataset.collate
        self.epoch = 0
        self.start_batch = 0

    def set_epoch(self, epoch: int, start_batch: int = 0):
        """Pin the epoch for the shuffle stream; ``start_batch`` fast-forwards
        the NEXT iteration to that batch index (mid-epoch preemption resume:
        the skipped batches are never loaded — index arithmetic only — and
        the remaining order is identical because both the shuffle and every
        transform are pure functions of (seed, epoch, index))."""
        self.epoch = epoch
        self.start_batch = int(start_batch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _epoch_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch])
            )
            rng.shuffle(idx)
        idx = idx[self.shard_index::self.num_shards]
        return idx

    def _batches(self):
        idx = self._epoch_indices()
        bs = self.batch_size
        n_full = len(idx) // bs
        for i in range(self.start_batch, n_full):
            yield idx[i * bs:(i + 1) * bs]
        if not self.drop_last and len(idx) % bs and self.start_batch <= n_full:
            yield idx[n_full * bs:]

    def __len__(self):
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        batches = list(self._batches())
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def make_batch(batch_idx):
            return self.collate([self.dataset[int(i)] for i in batch_idx])

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = [pool.submit(make_batch, b) for b in batches]
                for f in futures:
                    if stop.is_set():
                        f.cancel()
                        continue
                    try:
                        q.put(f.result())
                    except Exception as e:  # surface worker errors
                        q.put(e)
                        return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def device_prefetch(iterator, transfer, depth: int = 2, host_stage=None):
    """Stage host batches onto the device ``depth`` ahead of the consumer.

    ``transfer`` maps a host batch to device tensors (the trainer: pinned
    host tensors, ``non_blocking`` copies). Running it in a background
    thread overlaps the staging of batch i+1 with the consumer's step i.
    Order is preserved (single worker per stage, FIFO queues); worker
    exceptions re-raise in the consumer.

    ``host_stage`` (optional) splits the staging into a two-thread
    pipeline: the numpy batch assembly runs in its own thread feeding the
    transfer thread, so the copy of batch i overlaps the assembly of batch
    i+1."""
    if host_stage is not None:
        iterator = device_prefetch(iterator, host_stage, depth=depth)
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(obj) -> bool:
        # bounded put that gives up when the consumer abandoned the iterator
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                if not put(transfer(item)):
                    return
        except BaseException as e:  # surface in the consumer
            put(e)
            return
        put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def input_kinds(input_data: dict) -> list:
    """Canonical per-modality input order of ``build_batch_inputs`` (and of
    the JAX package's device-side normalizer)."""
    order = ["lr_dem"]
    if input_data.get("image"):
        order.append("image")
    for aux in ("mask", "canopy", "coord"):
        if input_data.get(aux):
            order.append(aux)
    return order


def model_inputs(batch: dict, model_name: str, input_data: dict) -> list:
    """The model's inputs from a batch of NHWC modality arrays, in its
    input layout (reference utils/utils.py:152-321 get_batch_pair):

    - JSPSR/LRRU: list of per-modality arrays [dem, image, aux];
    - CompletionFormer: [dem, stacked-guidance];
    - others (EDSR): one channel-stacked array.
    """
    name = model_name.lower()
    order = input_kinds(input_data)
    if name in ("jspsr", "lrru"):
        return [batch[k] for k in order]
    if name == "completionformer":
        guidance = [batch[k] for k in order[1:]]
        return [batch["lr_dem"], np.concatenate(guidance, axis=-1)]
    return [np.concatenate([batch[k] for k in order], axis=-1)]


def build_batch_inputs(batch: dict, model_name: str, input_data: dict):
    """Assemble model inputs from a collated batch (``model_inputs``).
    Returns (inputs, gt, base_elev, meta).
    """
    gt = batch["hr_dem"]
    meta = batch.get("meta", [])
    base_elev = np.asarray(
        [m.get("base", 0) for m in meta], np.float32
    ) if meta else np.zeros((gt.shape[0],), np.float32)
    return model_inputs(batch, model_name, input_data), gt, base_elev, meta
