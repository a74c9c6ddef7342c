"""Host batching into fixed-capacity numpy arrays, with background
prefetch (a copy of ``vision3d_tpu/data/loader.py``).

Each batch's point clouds are padded to a fixed capacity by resampling
(or subsampled down to it), its boxes to ``max_gt_boxes`` slots, so the
device sees one shape; voxelization happens on the device inside the
model. ``num_workers=0`` prefetches on one thread; ``num_workers > 0``
fans each batch's disk read, augmentation and collation out to a pool of
worker processes. Workers return numpy and never touch CUDA: the caller
moves each batch to the card.
"""

import multiprocessing
import os
import queue
import threading
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from vision3d_tpu_torch.config import Config

# Batches prepared ahead of the one the caller is on.
PREFETCH = 2

# Worker-process globals, set once per worker by _init_worker.
_WORKER_DATASET = None
_WORKER_CFG = None


def _init_worker(dataset, cfg):
    global _WORKER_DATASET, _WORKER_CFG
    # a worker has no card: any CUDA call in it raises
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _WORKER_DATASET = dataset
    _WORKER_CFG = cfg


def _worker_batch(indices, seed):
    """Materialize and collate one batch in a worker process.

    Each batch gets its own seeded rng (reproducible whichever worker runs
    it); the dataset's rng is swapped process-locally so augmentation
    draws from it.
    """
    rng = np.random.default_rng(seed)
    ds = _WORKER_DATASET
    if hasattr(ds, "rng"):
        ds.rng = rng
    items = [ds[int(j)] for j in indices]
    return collate(items, _WORKER_CFG, rng)


def pad_points(points: np.ndarray, capacity: int, rng) -> tuple:
    """Pad by resampling, or subsample down to ``capacity`` points;
    returns (padded, n_real)."""
    n = len(points)
    if n == 0:
        return np.zeros((capacity, points.shape[1]), points.dtype), 0
    if n >= capacity:
        idx = rng.choice(n, capacity, replace=False)
        return points[idx], capacity
    pad_idx = rng.integers(0, n, capacity - n)
    return np.concatenate([points, points[pad_idx]]), n


def collate(items, cfg: Config, rng) -> dict:
    """List of sample dicts -> fixed-capacity numpy batch."""
    P = cfg.capacity.max_points
    G = cfg.capacity.max_gt_boxes
    B = len(items)
    c_in = items[0]["points"].shape[1]

    points = np.zeros((B, P, c_in), np.float32)
    num_points = np.zeros((B,), np.int32)
    boxes = np.zeros((B, G, 7), np.float32)
    class_idx = np.zeros((B, G), np.int32)
    gt_mask = np.zeros((B, G), bool)
    box_ignore = np.zeros((B, G), bool)
    idx = np.zeros((B,), np.int64)

    for b, item in enumerate(items):
        points[b], num_points[b] = pad_points(
            item["points"].astype(np.float32), P, rng
        )
        n = min(len(item["boxes"]), G)
        boxes[b, :n] = item["boxes"][:n]
        class_idx[b, :n] = item["class_idx"][:n]
        gt_mask[b, :n] = True
        if "box_ignore" in item:
            box_ignore[b, :n] = item["box_ignore"][:n]
        idx[b] = item.get("idx", -1)

    return dict(
        points=points,
        num_points=num_points,
        boxes=boxes,
        class_idx=class_idx,
        gt_mask=gt_mask,
        box_ignore=box_ignore,
        frame_idx=idx,
    )


class DataLoader:
    """Epoch iterator with background prefetch.

    ``num_workers=0`` (default) prefetches on one thread; ``num_workers>0``
    runs each batch's disk read, augmentation and collation in a pool of
    worker processes (augmentation is GIL-bound numpy, so threads cannot
    feed a fast train step).

    ``num_shards`` / ``shard_id``: one process of several, each loading its
    own shard of the global batch. Every shard builds the same shuffled
    epoch order (the same seed) and keeps ``order[shard_id::num_shards]``;
    ``batch_size`` is then the per-process batch (global / num_shards). A
    worker's per-batch seed is XOR-ed with ``shard_id * 0x5BD1E995 &
    0x7FFFFFFF``, so the shards draw different augmentations and shard 0
    draws the one-process loader's."""

    def __init__(self, dataset, cfg: Config, batch_size=None, shuffle=True,
                 drop_last=True, seed=0, num_workers=0, num_shards=1, shard_id=0):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size or cfg.train.batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.num_shards = num_shards
        self.shard_id = shard_id

    def _order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_id::self.num_shards]
        return order

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        order = self._order()
        nb = len(self)
        for i in range(nb):
            sel = order[i * self.batch_size : (i + 1) * self.batch_size]
            items = [self.dataset[int(j)] for j in sel]
            yield collate(items, self.cfg, self.rng)

    def _executor(self):
        # one pool for every epoch: a spawned worker's start-up (interpreter
        # and dataset pickle) would otherwise be paid at each epoch
        if getattr(self, "_pool", None) is None:
            # spawn: forking a process that holds a CUDA context is unsafe
            ctx = multiprocessing.get_context("spawn")
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx,
                initializer=_init_worker, initargs=(self.dataset, self.cfg),
            )
        return self._pool

    def _iter_mp(self):
        order = self._order()
        nb = len(self)
        jobs = [
            (order[i * self.batch_size : (i + 1) * self.batch_size],
             int(self.rng.integers(0, 2**31)) ^ (self.shard_id * 0x5BD1E995
                                                 & 0x7FFFFFFF))
            for i in range(nb)
        ]
        ex = self._executor()
        inflight = max(self.num_workers + PREFETCH, 2)
        futures = [
            ex.submit(_worker_batch, idx, seed)
            for idx, seed in jobs[:inflight]
        ]
        nxt = inflight
        for i in range(nb):
            batch = futures[i].result()
            if nxt < nb:
                futures.append(ex.submit(_worker_batch, *jobs[nxt]))
                nxt += 1
            yield batch

    def close(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __iter__(self):
        if self.num_workers > 0:
            yield from self._iter_mp()
            return
        q = queue.Queue(maxsize=PREFETCH)
        stop = object()
        failed = []

        def worker():
            try:
                for batch in self._batches():
                    q.put(batch)
            except BaseException as e:  # raised again in the consumer
                failed.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is stop:
                break
            yield batch
        if failed:
            raise failed[0]
