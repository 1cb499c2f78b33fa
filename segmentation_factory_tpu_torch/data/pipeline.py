"""Host input pipeline: per-epoch shuffling, threaded loading, the batched
scale-crop in the host engine, and prefetch to the device.

The port's copy of ``segmentation_factory_tpu/data/pipeline.py``: ``Loader``
(:60-261) and ``prefetch_to_device`` (:263-302), for one process. Batches
are bit-identical to the JAX ``Loader``'s: the same index permutation per
(seed, epoch), the same per-sample draws from (seed, epoch, index), the
same engine. A train batch goes through ``native.batch_scale_crop`` once per
group of same-shaped samples, or, for a dataset with its own recipe
(``train_augment``, Synapse's), sample by sample in the thread pool (JAX
``_load_one``, :125-137); an eval batch is each sample padded to the
eval canvas (shrunk first where it is larger, by the engine's copies of
PIL's bilinear and nearest rules, as the JAX package shrinks it with PIL),
and the last partial batch is padded with ignore-labelled samples so the
confusion matrix counts every real pixel once.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from segmentation_factory_tpu_torch.data import native
from segmentation_factory_tpu_torch.data.datasets import SegDataset
from segmentation_factory_tpu_torch.data.transforms import center_pad_to, draw_scale_crop_params


class Loader:
    """Iterates {"image": uint8 (B, H, W, 3), "label": int32 (B, H, W)}
    numpy batches; a train loader drops the last partial batch, an eval
    loader pads it. One process: the JAX loader's per-host sharding is not
    ported."""

    def __init__(self, dataset: SegDataset, batch_size: int, crop: int, train: bool = True,
                 scale_range: Tuple[float, float] = (0.5, 2.0),
                 eval_hw: Optional[Tuple[int, int]] = None, seed: int = 0, num_workers: int = 8):
        self.ds = dataset
        self.batch = batch_size
        self.crop = crop
        self.train = train
        self.scale_range = scale_range
        self.eval_hw = eval_hw or (crop, crop)
        self.seed = seed
        self.workers = max(1, num_workers)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for ``epoch`` (DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch if self.train else -(-n // self.batch)

    def _indices(self) -> np.ndarray:
        """The epoch's sample order: shuffled per (seed, epoch) in training."""
        idx = np.arange(len(self.ds))
        if self.train:
            np.random.default_rng(self.seed * 1000003 + self.epoch).shuffle(idx)
        return idx

    def _load_eval(self, i: int):
        img, lbl = self.ds.load(int(i))
        h, w = img.shape[:2]
        eh, ew = self.eval_hw
        if (h, w) != (eh, ew):
            scale = min(eh / h, ew / w)
            if scale < 1.0:  # shrink to fit, keeping the aspect
                img, lbl = native.resize_pair(img, lbl, (int(h * scale), int(w * scale)))
            img, lbl = center_pad_to(img, lbl, self.eval_hw, self.ds.ignore_index)
        return img.astype(np.uint8), lbl.astype(np.int32)

    def _load_augmented(self, i: int, base: int):
        """One sample through the dataset's own train recipe, drawn from
        its stream ``base + i``."""
        img, lbl = self.ds.load(int(i))
        img, lbl = self.ds.train_augment(img, lbl, np.random.default_rng(base + int(i)),
                                         (self.crop, self.crop))
        return img.astype(np.uint8), lbl.astype(np.int32)

    def _load_train(self, chunk, base, pool):
        """Decode in threads, then one engine call per group of same-shaped
        samples, each sample's (scale, top, left) from its own stream."""
        decoded = list(pool.map(lambda i: self.ds.load(int(i)), chunk))
        groups: dict = {}
        for j, (img, _) in enumerate(decoded):
            groups.setdefault(img.shape, []).append(j)
        out = [None] * len(chunk)
        for shape, js in groups.items():
            h, w = shape[:2]
            draws = [draw_scale_crop_params(np.random.default_rng(base + int(chunk[j])), h, w,
                                            self.crop, self.scale_range) for j in js]
            oi, ol = native.batch_scale_crop(
                np.stack([decoded[j][0] for j in js]),
                np.stack([decoded[j][1].astype(np.int32, copy=False) for j in js]),
                np.asarray([d[0] for d in draws], np.float32),
                np.asarray([d[1] for d in draws], np.int32),
                np.asarray([d[2] for d in draws], np.int32), self.crop, self.ds.ignore_index,
                num_threads=self.workers)
            if len(groups) == 1:
                return oi, ol
            for g, j in enumerate(js):
                out[j] = (oi[g], ol[g])
        return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        base = self.seed * 7919 + self.epoch * 104729
        with ThreadPoolExecutor(self.workers) as pool:
            for bi in range(len(self)):
                chunk = idx[bi * self.batch: (bi + 1) * self.batch]
                pad_to = self.batch - len(chunk)
                if self.train and getattr(self.ds, "train_augment", None) is not None:
                    results = list(pool.map(lambda i: self._load_augmented(i, base), chunk))
                    imgs = np.stack([r[0] for r in results])
                    lbls = np.stack([r[1] for r in results])
                elif self.train:
                    imgs, lbls = self._load_train(chunk, base, pool)
                else:
                    results = list(pool.map(self._load_eval, chunk))
                    imgs = np.stack([r[0] for r in results])
                    lbls = np.stack([r[1] for r in results])
                if pad_to:  # the last partial batch, padded with ignore-only samples
                    imgs = np.concatenate([imgs, np.zeros((pad_to, *imgs.shape[1:]), np.uint8)])
                    lbls = np.concatenate([lbls, np.full((pad_to, *lbls.shape[1:]),
                                                         self.ds.ignore_index, np.int32)])
                yield {"image": imgs, "label": lbls}


def prefetch_to_device(iterator, device, depth: int = 2):
    """Batches of ``iterator`` as tensors on ``device``, made by a
    background thread up to ``depth`` batches ahead: on a CUDA device each
    array is copied into pinned host memory and sent with
    ``non_blocking=True`` on the current stream. An exception in the
    producer is raised here; closing the generator stops the producer."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not offer({k: put(v) for k, v in batch.items()}):
                    return
        except Exception as exc:  # handed to the consumer, raised there
            offer(exc)
        offer(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)
