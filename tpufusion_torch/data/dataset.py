"""Dataset scanning + loading (port of ``tpufusion/data/dataset.py``) —
reference C17.

Reference pieces: recursive image-folder scan (`utils/data_utils.py:7-25`),
``InferenceDataset`` (`inference_dataset.py:6-25`), and the
train/test ``SubsetRandomSampler`` split with 2-worker torch DataLoaders
(`attack_main2.py:97-134`).

Decode/resize happen on host numpy (PIL), batches come out as contiguous
NHWC float32 arrays ready for one copy to the card; a double-buffered
background thread hides decode latency behind device compute (the analog of
the reference's ``num_workers=2``). With ``--align`` the preprocess hook runs
the landmark net (on the card) inside that thread; its errors reach the
consumer like any other.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Optional, Sequence

import numpy as np
from PIL import Image

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
)


def list_images(root: str) -> list[str]:
    """Recursive, sorted scan for image files (``make_dataset``)."""
    out = []
    for dirpath, _, filenames in sorted(os.walk(root)):
        for name in sorted(filenames):
            if name.lower().endswith(IMG_EXTENSIONS):
                out.append(os.path.join(dirpath, name))
    return out


class ImageFolderDataset:
    """``InferenceDataset`` equivalent: path list + transform + optional
    preprocess hook (the alignment function when ``--align`` is set,
    `attack_main2.py:102-108`)."""

    def __init__(
        self,
        root: str,
        transform: Optional[Callable[[Image.Image], np.ndarray]] = None,
        preprocess: Optional[Callable[[str], Image.Image]] = None,
    ):
        self.paths = list_images(root)
        if not self.paths:
            raise FileNotFoundError(f"no images under {root!r}")
        self.transform = transform
        self.preprocess = preprocess

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        path = self.paths[idx]
        if self.preprocess is not None:
            img = self.preprocess(path)
        else:
            img = Image.open(path)
        img = img.convert("RGB")
        if self.transform is not None:
            return self.transform(img)
        from tpufusion_torch.data.native import normalize_u8_to_pm1

        return normalize_u8_to_pm1(np.asarray(img, dtype=np.uint8))


class BatchLoader:
    """Iterates NHWC float32 batches over a fixed index subset with a
    background prefetch thread (depth 2)."""

    def __init__(
        self,
        dataset: ImageFolderDataset,
        indices: Sequence[int],
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        idx = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(idx)
        stop = len(idx) - (len(idx) % self.batch_size) if self.drop_last else len(idx)
        for i in range(0, stop, self.batch_size):
            chunk = idx[i : i + self.batch_size]
            yield np.stack([self.dataset[int(j)] for j in chunk])

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()  # set when the consumer abandons iteration

        def worker():
            try:
                for batch in self._batches():
                    # bounded put with a liveness check: a consumer that
                    # breaks out of the loop would otherwise leave this
                    # thread blocked on a full queue forever
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised by consumer
                # surface dataset errors in the consumer instead of silently
                # truncating the epoch (a swallowed __getitem__ error used
                # to end iteration early with NO error)
                while not stop.is_set():
                    try:
                        q.put(e, timeout=0.1)
                        return
                    except queue.Full:
                        continue
            finally:
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()  # unblock + terminate the worker on early exit


def setup_loaders(
    dataset: ImageFolderDataset,
    *,
    train_size: int = 2000,
    test_size: int = 1000,
    train_batch_size: int = 1,
    test_batch_size: int = 5,
    seed: int = 0,
):
    """The reference's split (`attack_main2.py:110-128`): shuffle all indices
    once, first ``train_size`` are train, next ``test_size`` are test; both
    loaders then sample their subset randomly with ``drop_last``."""
    if len(dataset) <= train_size:
        raise ValueError(
            f"dataset has {len(dataset)} images but train_size="
            f"{train_size} consumes them all — the test split would be "
            f"EMPTY and evaluation would silently run zero batches; "
            f"shrink the split sizes (the reference assumes a 70k "
            f"FFHQ-scale folder, `attack_main2.py:110-128`)")
    if len(dataset) < train_size + test_size:
        import sys

        print(f"[setup_loaders] note: dataset has {len(dataset)} images "
              f"< train_size+test_size={train_size + test_size}; test "
              f"split shortened to {len(dataset) - train_size}",
              file=sys.stderr)
    idx = np.arange(len(dataset))
    np.random.RandomState(seed).shuffle(idx)
    train_idx = idx[:train_size]
    test_idx = idx[train_size : train_size + test_size]
    train = BatchLoader(dataset, train_idx, train_batch_size, seed=seed + 1)
    test = BatchLoader(dataset, test_idx, test_batch_size, seed=seed + 2)
    return train, test
