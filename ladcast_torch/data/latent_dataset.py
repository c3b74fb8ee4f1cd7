"""AR training dataset over pre-encoded latents (the port of
``ladcast_tpu/data/latent_dataset.py``'s in-memory path).

Items are (input frames (T_in, h, w, C), target frames (T_out, h, w, C),
timestamp YYYYMMDDHH of the first input frame), with strided time sampling
(``sampling_interval``) applied first, then a window of total extent
(T_in + T_out - 1) * interval_between_pred + 1. :func:`batch_iterator`
prefetches numpy batches on a host thread, in a seeded order per epoch.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ladcast_torch.data import time_utils


class ArrayLatentSource:
    """Latents as a (time, h, w, C) ndarray + int64 YYYYMMDDHH timestamps."""

    def __init__(self, latents: np.ndarray, timestamps: Sequence[int]):
        if latents.ndim != 4 or len(timestamps) != latents.shape[0]:
            raise ValueError(f"latents {latents.shape} and {len(timestamps)} "
                             f"timestamps: expected (time, h, w, C), one each")
        self.latents = latents
        self.timestamps = np.asarray(timestamps, np.int64)

    def __len__(self):
        return self.latents.shape[0]

    def frames(self, idx: np.ndarray) -> np.ndarray:
        return self.latents[idx]

    def timestamp(self, idx: int) -> int:
        return int(self.timestamps[idx])


@dataclass
class ARWindowConfig:
    input_seq_len: int = 1
    return_seq_len: int = 4
    interval_between_pred: int = 6  # in source steps (hours for hourly data)
    sampling_interval: int = 1


class ARLatentDataset:
    """Map-style windowed view of a latent source, normalized to
    ``target_std`` with the per-channel ``mean`` and ``std``."""

    def __init__(self, source, cfg: ARWindowConfig,
                 mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None,
                 target_std: float = 0.5):
        self.cfg = cfg
        self.source = source
        self.mean = mean
        self.std = std
        self.target_std = target_std
        self._index = np.arange(0, len(source), cfg.sampling_interval)
        self.full_seq_len = (cfg.input_seq_len + cfg.return_seq_len - 1) \
            * cfg.interval_between_pred + 1
        self.length = len(self._index) - self.full_seq_len + 1
        if self.length <= 0:
            raise ValueError("source too short for the requested window")

    def __len__(self):
        return self.length

    def _window_idx(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        c = self.cfg
        input_end = idx + (c.input_seq_len - 1) * c.interval_between_pred
        pred_start = input_end + c.interval_between_pred
        in_idx = np.arange(idx, input_end + 1, c.interval_between_pred)
        out_idx = np.arange(
            pred_start,
            pred_start + (c.return_seq_len - 1) * c.interval_between_pred + 1,
            c.interval_between_pred)
        return self._index[in_idx], self._index[out_idx]

    def _transform(self, x):
        if self.mean is None:
            return x
        return (x - self.mean) / self.std * self.target_std

    def __getitem__(self, idx: int):
        in_idx, out_idx = self._window_idx(idx)
        inp = self._transform(self.source.frames(in_idx).astype(np.float32))
        out = self._transform(self.source.frames(out_idx).astype(np.float32))
        return inp, out, self.source.timestamp(int(in_idx[0]))


def batch_iterator(
    dataset: ARLatentDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    num_push_forward_steps: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield one epoch of full (initial_profile, clean, year_progress)
    numpy batches, year_progress (B, num_push_forward_steps) float32: the
    year progress of t0 + 6 h * s for each push-forward chunk s. Two
    batches are read ahead on a thread, which stops when the generator is
    closed; an error there is raised here."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                pass
        return False

    def batches():
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(dataset)) if shuffle \
            else np.arange(len(dataset))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            inps, outs, yps = [], [], []
            for i in order[s:s + batch_size]:
                inp, out, ts = dataset[int(i)]
                inps.append(inp)
                outs.append(out)
                yps.append([time_utils.year_progress(
                    time_utils.int_to_datetime(
                        time_utils.add_hours_int(ts, 6 * k)))
                    for k in range(num_push_forward_steps)])
            yield (np.stack(inps), np.stack(outs), np.asarray(yps, np.float32))

    def produce():
        try:
            for batch in batches():
                if not put(batch):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            put(e)
            return
        put(None)

    threading.Thread(target=produce, daemon=True).start()
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
