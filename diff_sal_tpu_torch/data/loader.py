"""Host-side batch loader (JAX package `data/loader.py`): the torch
DataLoader + DistributedSampler of the reference
(`datasets/prepare_data.py`), with the JAX package's rules.

Datasets are plain indexable Python; the loader owns

* the per-epoch shuffle, `RandomState(seed + epoch)` (the same order on
  every host and in both packages),
* host sharding: process p iterates `indices[p::n]`, as
  DistributedSampler(rank, world_size) does; with drop_last and n > 1 the
  epoch's indices are first cut to a multiple of n (the last len % n go),
  so every process yields the same number of batches and none waits
  forever in a collective that the others never reach: floor(len / (n b))
  batches each, as many as one process with batch n b yields,
* drop_last batching (the reference sets drop_last on every loader),
* optional pad-to-batch by repeating the last item, with a "valid" mask
  on every batch (the reference pads its last training batch so,
  diffusion_trainer.py:93-99),
* a thread pool building items concurrently (numpy, PIL and the audio DSP
  release the GIL) behind a bounded queue of ready batches; a consumer
  that stops early ends the producer and its pool (the JAX package's
  leaves them blocked on the full queue), and an item that raises raises
  in the consumer (the JAX package's ends the epoch early).

It yields stacked numpy; the trainer moves each batch to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np


class _Failed:
    """A producer's exception on its way to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


def collate(items: List[dict]) -> Dict[str, np.ndarray]:
    """Stack numeric fields; non-numeric become lists."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = True,
        pad_last: bool = False,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 4,
        process_index: int = 0,
        process_count: int = 1,
    ):
        assert not (drop_last and pad_last)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reshuffle seed per epoch (DistributedSampler.set_epoch analogue)."""
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.drop_last and self.process_count > 1:
            idx = idx[: n - n % self.process_count]
        return idx[self.process_index :: self.process_count]

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Tuple[List[int], int]]:
        """Yields (index chunk, n_real). With pad_last the tail batch repeats
        the last sample; n_real < len(chunk) marks the duplicates so eval
        can exclude them (batch key "valid")."""
        idx = self._epoch_indices()
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i : i + self.batch_size].tolist()
            n_real = len(chunk)
            if n_real < self.batch_size:
                if self.drop_last:
                    return
                if self.pad_last:
                    chunk = chunk + [chunk[-1]] * (self.batch_size - n_real)
            yield chunk, n_real

    def _finish(self, batch: Dict[str, np.ndarray], n_real: int, n_total: int):
        # with pad_last every batch carries the mask (all ones when full),
        # so the tail batch has the same keys as the rest
        if self.pad_last:
            batch["valid"] = (np.arange(n_total) < n_real).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers <= 0:
            for chunk, n_real in self._batches():
                yield self._finish(
                    collate([self.dataset[i] for i in chunk]), n_real,
                    len(chunk),
                )
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for chunk, n_real in self._batches():
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, chunk))
                        out_q.put(
                            self._finish(collate(items), n_real, len(chunk))
                        )
                except BaseException as e:  # handed to the consumer, raised there
                    out_q.put(_Failed(e))
                finally:
                    out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                if isinstance(batch, _Failed):
                    raise batch.error
                yield batch
        finally:
            stop.set()
            # a consumer that stops early (next(iter(loader))) would leave the
            # producer blocked on a full queue: drain it until the producer
            # sees the stop and its pool has shut down
            while t.is_alive():
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
