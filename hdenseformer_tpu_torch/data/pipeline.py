"""Host-side input pipeline: k-fold splitter, dataset, prefetching loader.

A copy of ``hdenseformer_tpu/data/pipeline.py`` (the port imports nothing of
the JAX package), with its two properties:

- deterministic: every sample is drawn with a generator derived from
  (seed, epoch, index), whatever the worker scheduling;
- a thread pool decodes and augments the samples of a batch (h5py, numpy and
  scipy release the GIL) while a background thread keeps ``prefetch``
  batches ready, so the host prepares the next batch while the card runs
  the step.

Batches are channels-last float32 numpy arrays; ``train/loop.py``'s
``pad_and_mask_batch`` pads them and moves them to the card.
"""
from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from hdenseformer_tpu_torch.data.io import hdf5_reader
from hdenseformer_tpu_torch.data.transforms import remap_roi_labels


def get_cross_validation_by_sample(
    path_list: Sequence[str],
    fold_num: int,
    current_fold: int,
    shuffle_seed: Optional[int] = None,
) -> Tuple[List[str], List[str]]:
    """Patient-prefix k-fold split.

    Sample ID = basename prefix before the first '_'; fold k validates the
    k-th slice of the sorted unique IDs. Returned lists are shuffled
    (deterministically when ``shuffle_seed`` is given).
    """
    sample_list = sorted(set(os.path.basename(c).split("_")[0] for c in path_list))
    _len_ = len(sample_list) // fold_num
    end_index = current_fold * _len_
    start_index = end_index - _len_
    # fold k validates sample_list[start_index:end_index] (the last fold: to
    # the end); every case of the other IDs trains
    if current_fold == fold_num:
        train_id = set(sample_list[:start_index])
    else:
        train_id = set(sample_list[:start_index] + sample_list[end_index:])

    train_path, validation_path = [], []
    for case in path_list:
        if os.path.basename(case).split("_")[0] in train_id:
            train_path.append(case)
        else:
            validation_path.append(case)
    rng = np.random.default_rng(shuffle_seed)
    rng.shuffle(train_path)
    rng.shuffle(validation_path)
    return train_path, validation_path


class SegDataset:
    """Per-case dataset with ROI remap and a transform pipeline.

    ``reader(path, key) -> float32 array`` reads one volume of a case file
    (default ``hdf5_reader``); any other reader takes the same arguments.
    """

    def __init__(
        self,
        path_list: Sequence[str],
        roi_number=None,
        num_class: int = 2,
        transform: Optional[Callable] = None,
        img_key: str = "ct",
        lab_key: str = "seg",
        reader: Callable[[str, str], np.ndarray] = hdf5_reader,
    ):
        self.path_list = list(path_list)
        self.roi_number = roi_number
        self.num_class = num_class
        self.transform = transform
        self.img_key = img_key
        self.lab_key = lab_key
        self.reader = reader

    def __len__(self) -> int:
        return len(self.path_list)

    def get(self, index: int, rng: Optional[np.random.Generator] = None) -> dict:
        image = self.reader(self.path_list[index], self.img_key)
        label = self.reader(self.path_list[index], self.lab_key)
        label = remap_roi_labels(label, self.roi_number, self.num_class)
        sample = {"image": image, "label": label}
        if self.transform is not None:
            sample = self.transform(sample, rng or np.random.default_rng())
        return sample


class BatchLoader:
    """Deterministic shuffling batch iterator with background prefetch.

    Iterate with ``for batch in loader.epoch(epoch_idx): ...``; each batch
    is a dict of stacked channels-last float32 arrays
    {'image': (B, *sp, C), 'label': (B, *sp, num_class)}. Leaving the loop
    early stops the background thread.
    """

    def __init__(
        self,
        dataset: SegDataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load_one(self, epoch: int, index: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, index]))
        return self.dataset.get(index, rng)

    def _batches(self, epoch: int):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(np.random.SeedSequence([self.seed, epoch])).shuffle(order)
        if self.drop_last:
            order = order[: (n // self.batch_size) * self.batch_size]
        for s in range(0, len(order), self.batch_size):
            yield order[s : s + self.batch_size]

    def _stack(self, samples: list, indices) -> dict:
        """One batch; samples of more than one shape raise, naming them (raw
        cases of several sizes, as on-device augmentation batches them)."""
        for key in ("image", "label"):
            shapes = [s[key].shape for s in samples]
            if len(set(shapes)) > 1:
                cases = [self.dataset.path_list[int(i)] for i in indices]
                raise ValueError(
                    f"a batch mixes {key} shapes {shapes} (cases {cases}): the samples of "
                    "a batch are stacked, so they need one shape; with device_augment "
                    "they are the raw cases, uncropped")
        return {key: np.stack([s[key] for s in samples]) for key in ("image", "label")}

    def epoch(self, epoch: int = 0):
        """Yield batches for one epoch, prefetched in a background thread."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        cancel = threading.Event()

        def put(item) -> None:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx_batch in self._batches(epoch):
                        if cancel.is_set():
                            return
                        samples = list(
                            pool.map(lambda i: self._load_one(epoch, int(i)), idx_batch)
                        )
                        put(self._stack(samples, idx_batch))
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
            finally:
                put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            cancel.set()
            t.join()
