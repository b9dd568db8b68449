"""File-based KITTI dataset + batching/prefetch loader.

A copy of the JAX package's ``dcd_tpu/data/kitti_dataset.py`` (numpy and
threads; the batches are numpy arrays, moved to the card by the train step),
so that one seed gives the same batches in both packages.

Reference: ``KITTIDataset`` (DGDE/data/datasets/kitti.py:30-168) for the
directory layout (image_2/label_2/calib/ImageSets + kpts_ann json), class
filtering, and empty-image dropping; ``TrainingSampler`` /
``InferenceSampler`` (data/samplers/distributed_sampler.py:12-202) for the
infinite shuffled rank-strided sampling; ``make_data_loader``
(data/build.py:58-166) for world-divisible batching.

The torch DataLoader worker pool becomes a thread-pool prefetcher feeding
fixed-shape numpy batches (the target assembly in
:mod:`.target_encoder` is the heavy per-sample work).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..config import Config
from .augmentations import ComposedAugmentation
from .kitti_geometry import Calibration, Object3d, read_label
from .target_encoder import EncodedSample, collate, encode_targets


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


class KITTIDataset:
    def __init__(self, cfg: Config, root: str, is_train: bool = True, augment: bool = True):
        self.cfg = cfg
        self.root = root
        self.is_train = is_train
        self.image_dir = os.path.join(root, "image_2")
        self.label_dir = os.path.join(root, "label_2")
        self.calib_dir = os.path.join(root, "calib")
        split = cfg.datasets.train_split if is_train else cfg.datasets.test_split
        self.split = split
        imageset = os.path.join(root, "ImageSets", f"{split}.txt")
        with open(imageset, "r") as f:
            self.ids = [l.strip() for l in f if l.strip()]
        self.classes = cfg.datasets.detect_classes
        self.extra_kpts_num = cfg.model.head.extra_kpts_num

        # keypoint annotation JSON (reference kitti.py:118-127)
        self.kpts_ann = {}
        for name in ({"train": ["train"], "val": ["val"]}.get(split, ["train", "val"])):
            p = os.path.join(root, "..", "kpts_ann", f"kpts_ann_{name}.json")
            p2 = os.path.join("kpts_ann", f"kpts_ann_{name}.json")
            for cand in (p, p2):
                if os.path.exists(cand):
                    with open(cand, "r") as f:
                        self.kpts_ann.update(json.load(f))
                    break

        self.augmentation = None
        if is_train and augment:
            flip_p = cfg.input.aug_params[0][0] if cfg.input.aug_params else 0.5
            self.augmentation = ComposedAugmentation(flip_prob=flip_p)

        if is_train:
            # drop images with no relevant objects (reference kitti.py:130-142)
            keep = []
            for i in self.ids:
                objs = self._load_objects(i)
                if objs and any(o.type in self.classes for o in objs):
                    keep.append(i)
            self.ids = keep

    def __len__(self):
        return len(self.ids)

    def _load_objects(self, img_id: str) -> Optional[List[Object3d]]:
        if self.split == "test":
            return None
        path = os.path.join(self.label_dir, f"{img_id}.txt")
        anns = self.kpts_ann.get(str(int(img_id)), [])
        return read_label(path, anns, self.extra_kpts_num)

    def get_sample(
        self,
        index: int,
        rng: Optional[np.random.RandomState] = None,
        bucket=None,
    ) -> EncodedSample:
        """Load + augment + encode one sample. With ``bucket`` (a
        :class:`..data.multiscale.ScaleBucket`) the scene is resized to fit
        the bucket and encoded at the bucket's static input shape —
        the multi-scale path (reference RandomResize,
        augmentations.py:89-132, driven per batch here so every compiled
        shape is a static bucket)."""
        img_id = self.ids[index]
        img = _load_image(os.path.join(self.image_dir, f"{img_id}.png"))
        calib = Calibration.from_kitti_file(os.path.join(self.calib_dir, f"{img_id}.txt"))
        objs = self._load_objects(img_id)
        if objs is not None:
            objs = [o for o in objs if o.type in self.classes or o.type == "DontCare"]
        if self.augmentation is not None and rng is not None:
            img, objs, calib = self.augmentation(img, objs, calib, rng)
        if bucket is not None:
            from .multiscale import encode_at_bucket

            return encode_at_bucket(img, objs, calib, self.cfg, bucket, img_id=img_id)
        # safety: images larger than the input canvas are scaled down with
        # the calibration (the reference assumes canvas >= image and would
        # fail on negative padding)
        ih, iw = img.shape[:2]
        cw, ch = self.cfg.input.width_train, self.cfg.input.height_train
        if iw > cw or ih > ch:
            from .augmentations import resize_scene

            scale = min(cw / iw, ch / ih)
            img, objs, calib = resize_scene(img, objs, calib, scale)
        return encode_targets(img, objs, calib, self.cfg, img_id=img_id, is_train=self.is_train)


class InfiniteTrainingSampler:
    """Infinite shuffled index stream, strided by process
    (reference TrainingSampler, distributed_sampler.py:12-56)."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            order = g.permutation(self.size) if self.shuffle else np.arange(self.size)
            yield from order[self.process_index :: self.process_count].tolist()


class InferenceSampler:
    """One sharded pass (reference distributed_sampler.py:175-202)."""

    def __init__(self, size: int, process_index: int = 0, process_count: int = 1):
        shard = (size - 1) // process_count + 1
        begin = shard * process_index
        self.indices = list(range(begin, min(begin + shard, size)))

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


class DataLoader:
    """Threaded prefetching batch loader producing fixed-shape dicts.

    Deterministic: batch *n* is a pure function of (sampler stream, seed, n)
    — workers claim batch numbers, sample→batch assignment is drawn from the
    index stream in batch order under a lock, augmentation RNG is seeded per
    batch, and a reorder buffer yields batches strictly in order. That makes
    runs reproducible batch-for-batch regardless of worker timing (round-1
    weakness) and makes resume exact: set :attr:`start_batch` to the restored
    step and the stream continues where it left off instead of restarting.

    Multi-scale: with ``buckets`` (len>1), batch *n* is encoded at bucket
    ``schedule[n]`` (deterministic seeded choice, reference RandomResize +
    INPUT.MULTI_TRAIN_SIZE, augmentations.py:89-132) — each bucket is one
    static compiled shape.
    """

    def __init__(
        self,
        dataset: KITTIDataset,
        batch_size: int,
        sampler,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        buckets: Optional[Sequence] = None,
        bucket_seed: int = 63,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.buckets = list(buckets) if buckets else []
        self.bucket_seed = bucket_seed
        self.start_batch = 0  # set before iter() to resume mid-stream

    def _bucket_for(self, n: int):
        if len(self.buckets) <= 1:
            return self.buckets[0] if self.buckets else None
        # deterministic per-batch choice (reference seeds its resize choice,
        # augmentations.py:96-101); same n -> same bucket on every process
        r = np.random.RandomState((self.bucket_seed * 1000003 + n) % (2**31))
        return self.buckets[int(r.randint(len(self.buckets)))]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx_iter = iter(self.sampler)
        idx_lock = threading.Lock()
        index_batches: List[List[int]] = []  # index_batches[n] = batch n's ids

        def batch_indices(n: int) -> List[int]:
            with idx_lock:
                while len(index_batches) <= n:
                    chunk = []
                    try:
                        for _ in range(self.batch_size):
                            chunk.append(next(idx_iter))
                    except StopIteration:
                        pass
                    index_batches.append(chunk)
                return index_batches[n]

        claim_lock = threading.Lock()
        next_claim = [self.start_batch]

        def claim() -> int:
            with claim_lock:
                n = next_claim[0]
                next_claim[0] += 1
                return n

        q: "queue.Queue" = queue.Queue()
        stop = threading.Event()
        # bound the number of batches in flight (reorder buffer + queue)
        slots = threading.Semaphore(self.prefetch + self.num_workers)

        def worker():
            while not stop.is_set():
                if not slots.acquire(timeout=0.25):
                    continue
                n = claim()
                try:
                    indices = batch_indices(n)
                    if not indices:
                        q.put((n, None))
                        return
                    rng = np.random.RandomState((self.seed * 100003 + n) % (2**31))
                    bucket = self._bucket_for(n)
                    samples = [
                        self.dataset.get_sample(i, rng, bucket=bucket) for i in indices
                    ]
                    batch = collate(samples)
                    batch["img_ids"] = [s.img_id for s in samples]
                    q.put((n, batch))
                except BaseException as e:  # noqa: BLE001 — re-raised by consumer
                    # enqueue the claimed slot so the reorder buffer can't
                    # deadlock waiting for batch n, then stop this worker
                    q.put((n, e))
                    return

        threads = [
            threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        pending: Dict[int, Optional[Dict]] = {}
        want = self.start_batch
        try:
            while True:
                while want not in pending:
                    n, batch = q.get()
                    pending[n] = batch
                item = pending.pop(want)
                want += 1
                if isinstance(item, BaseException):
                    raise item  # worker failed on this batch (I/O, decode, ...)
                if item is None:
                    return  # stream exhausted (finite sampler)
                slots.release()
                yield item
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=2.0)


class ConcatDataset:
    """Concatenation of several datasets into one index space (the
    reference trains on ``D.ConcatDataset(datasets)`` when the run config
    lists multiple datasets, data/build.py:51-54)."""

    def __init__(self, datasets):
        assert datasets, "ConcatDataset needs at least one dataset"
        self.datasets = list(datasets)
        self.cum = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cum.append(total)

    def __len__(self):
        return self.cum[-1]

    def _locate(self, idx: int):
        if idx < 0 or idx >= len(self):
            raise IndexError(idx)
        lo = 0
        for di, hi in enumerate(self.cum):
            if idx < hi:
                return self.datasets[di], idx - lo
            lo = hi
        raise IndexError(idx)  # unreachable

    def get_sample(self, idx: int, rng=None, bucket=None):
        ds, local = self._locate(idx)
        return ds.get_sample(local, rng, bucket=bucket)


def make_data_loader(cfg: Config, root, is_train: bool = True,
                     process_index: int = 0, process_count: int = 1) -> DataLoader:
    """World-size-divisible batch split (reference data/build.py:58-128).

    ``root`` may be a single dataset root or a list/tuple of roots — the
    latter concatenates the datasets into one training index space
    (reference build.py:51-54)."""
    if isinstance(root, (list, tuple)):
        if len(root) > 1:
            dataset = ConcatDataset(
                [KITTIDataset(cfg, r, is_train=is_train) for r in root]
            )
        else:
            dataset = KITTIDataset(cfg, root[0], is_train=is_train)
    else:
        dataset = KITTIDataset(cfg, root, is_train=is_train)
    global_batch = cfg.solver.ims_per_batch if is_train else cfg.test.ims_per_batch
    assert global_batch % process_count == 0, (global_batch, process_count)
    local_batch = global_batch // process_count
    if is_train:
        sampler = InfiniteTrainingSampler(
            len(dataset), seed=max(cfg.seed, 0), process_index=process_index, process_count=process_count
        )
    else:
        sampler = InferenceSampler(len(dataset), process_index, process_count)
    buckets = None
    if is_train and len(cfg.input.multi_train_size) > 1:
        from .multiscale import make_buckets

        buckets = make_buckets(cfg)
    return DataLoader(dataset, local_batch, sampler, seed=max(cfg.seed, 0), buckets=buckets)
