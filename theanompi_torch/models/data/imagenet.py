"""ImageNet-style sharded images: uint8 shards, random crop and mirror,
batches across shard boundaries.

Counterpart of ``theanompi_tpu/models/data/imagenet.py``
(``random_crop_mirror`` :40, ``center_crop`` :61, ``write_shards`` :80,
``convert_hkl_tree`` :88, ``_ShardSet`` :118, ``_SyntheticShards`` :162,
``_load_from_spec`` :215, ``ImageNetData`` :224), numpy only: the same
config gives the reference's batches bit for bit.
On-disk layout under ``data_path`` (or ``$IMAGENET_PATH``)::

    train/x_0000.npy  uint8 [N, S, S, 3]   (S = the stored size, e.g. 256)
    train/y_0000.npy  int32 [N]
    val/x_0000.npy ...

Without one, deterministic synthetic shards (a per-class 8x8x3 pattern
tiled to the stored size, plus noise, generated shard by shard) run the
same shard, augment and batch pipeline.  Batches leave as uint8 NHWC; the
model normalizes them on the device with :attr:`ImageNetData.norm_stats`.
The crop runs in C where :mod:`theanompi_torch.native` builds, and
``loader_workers > 0`` fans the training shards out over the
shared-memory worker ring (:mod:`theanompi_torch.models.data.shm_loader`);
both give the inline numpy path's bytes.
"""

from __future__ import annotations

import os

import numpy as np

from theanompi_torch.models.data.base import (
    Dataset,
    derive_seed,
    read_with_retry,
)

#: ImageNet channel means and standard deviations in [0, 255] RGB
MEAN_RGB = np.array([123.68, 116.78, 103.94], np.float32)
STD_RGB = np.array([58.39, 57.12, 57.38], np.float32)


def random_crop_mirror(x: np.ndarray, out: int, rng: np.random.RandomState):
    """Random spatial crop of an NHWC batch to ``out`` and a horizontal
    mirror of half of it (train augmentation).  The draws come first, so
    the C crop and the numpy loop below (the reference implementation)
    take the same offsets and give the same bytes."""
    from theanompi_torch import native

    n, h, w, _ = x.shape
    ys = rng.randint(0, h - out + 1, n)
    xs = rng.randint(0, w - out + 1, n)
    flips = rng.rand(n) < 0.5
    fast = native.crop_mirror_batch(x, out, out, ys, xs, flips)
    if fast is not None:
        return fast
    res = np.empty((n, out, out, x.shape[3]), x.dtype)
    for i in range(n):
        img = x[i, ys[i]: ys[i] + out, xs[i]: xs[i] + out]
        res[i] = img[:, ::-1] if flips[i] else img
    return res


def center_crop(x: np.ndarray, out: int):
    h, w = x.shape[1:3]
    y0, x0 = (h - out) // 2, (w - out) // 2
    return x[:, y0: y0 + out, x0: x0 + out]


def write_shards(dirpath: str, x: np.ndarray, y: np.ndarray,
                 shard_size: int):
    """Write arrays in the shard layout above."""
    os.makedirs(dirpath, exist_ok=True)
    for s, start in enumerate(range(0, len(x), shard_size)):
        np.save(os.path.join(dirpath, f"x_{s:04d}.npy"),
                x[start: start + shard_size])
        np.save(os.path.join(dirpath, f"y_{s:04d}.npy"),
                y[start: start + shard_size])


def convert_hkl_tree(src: str, dst: str) -> None:
    """Convert a reference-era tree of hickle ``.hkl`` image shards (in
    file-name order) into ``x_NNNN.npy`` uint8 NHWC shards under ``dst``;
    CHW shards are transposed.  Labels are not in the tree: pair the
    output with ``y_NNNN.npy`` files as :func:`write_shards` writes them.
    Needs the optional ``hickle`` package, imported here, at the call."""
    try:
        import hickle
    except ImportError as e:
        raise ImportError(
            "hickle is not installed; convert_hkl_tree needs it to read "
            ".hkl shards. Preprocess to .npy shards directly instead "
            "(see write_shards).") from e
    os.makedirs(dst, exist_ok=True)
    files = sorted(f for f in os.listdir(src) if f.endswith(".hkl"))
    for i, f in enumerate(files):
        arr = np.asarray(hickle.load(os.path.join(src, f)))
        if arr.shape[1] == 3:  # CHW to HWC
            arr = arr.transpose(0, 2, 3, 1)
        np.save(os.path.join(dst, f"x_{i:04d}.npy"), arr.astype(np.uint8))


class _ShardSet:
    """One split on disk: (x, y) shard files, read with retries."""

    def __init__(self, dirpath: str):
        xs = sorted(f for f in os.listdir(dirpath) if f.startswith("x_"))
        self.x_files = [os.path.join(dirpath, f) for f in xs]
        self.y_files = [
            os.path.join(dirpath, os.path.basename(p).replace("x_", "y_"))
            for p in self.x_files]
        missing = [p for p in self.y_files if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"label shards missing: {missing[:3]}")
        self.lens = [int(read_with_retry(
            lambda p=p: np.load(p, mmap_mode="r").shape[0], what=p))
            for p in self.x_files]
        self.n = sum(self.lens)

    def load(self, i: int):
        return (read_with_retry(lambda: np.load(self.x_files[i]),
                                what=self.x_files[i]),
                read_with_retry(lambda: np.load(self.y_files[i]),
                                what=self.y_files[i]))

    def spec(self, i: int):
        """Shard ``i`` as a picklable handle for the pool's workers."""
        return ("files", self.x_files[i], self.y_files[i])


class _SyntheticShards:
    """Deterministic synthetic shards, generated when read: each class's
    8x8x3 signature (seeded by the class id) tiled to ``store_size``, plus
    one fp32 noise draw a shard."""

    def __init__(self, n: int, n_classes: int, store_size: int,
                 shard_size: int, seed: int):
        self.n = n
        self.n_classes = n_classes
        self.store_size = store_size
        self.shard_size = shard_size
        self.seed = seed
        self.n_shards = (n + shard_size - 1) // shard_size
        self.lens = [min(shard_size, n - i * shard_size)
                     for i in range(self.n_shards)]
        self._patterns: dict[int, np.ndarray] = {}

    def _pattern(self, cls: int) -> np.ndarray:
        p = self._patterns.get(cls)
        if p is None:
            r = np.random.RandomState(1000003 + cls)
            p = r.randint(60, 196, size=(8, 8, 3)).astype(np.float32)
            self._patterns[cls] = p
        return p

    def load(self, i: int):
        s = self.store_size
        reps = s // 8 + 1
        count = self.lens[i]
        r = np.random.default_rng(self.seed * 7919 + int(i))
        y = r.integers(0, self.n_classes, count, dtype=np.int32)
        pats = np.stack([self._pattern(int(c)) for c in y])
        pats = np.tile(pats, (1, reps, reps, 1))[:, :s, :s]
        noise = r.standard_normal((count, s, s, 3), dtype=np.float32)
        x = np.clip(pats + noise * 24.0, 0, 255).astype(np.uint8)
        return x, y

    def spec(self, i: int):
        """Shard ``i`` as a picklable handle for the pool's workers."""
        return ("synth", self.n, self.n_classes, self.store_size,
                self.shard_size, self.seed, int(i))


def _load_from_spec(spec):
    """The (x, y) shard a :meth:`_ShardSet.spec` or
    :meth:`_SyntheticShards.spec` handle names (in a pool worker)."""
    if spec[0] == "files":
        return (read_with_retry(lambda: np.load(spec[1]), what=spec[1]),
                read_with_retry(lambda: np.load(spec[2]), what=spec[2]))
    _, n, n_classes, store, shard, seed, i = spec
    return _SyntheticShards(n, n_classes, store, shard, seed).load(i)


class ImageNetData(Dataset):
    """Sharded ImageNet(-style) data with crop and mirror augmentation.

    Config keys: ``data_path`` (or ``$IMAGENET_PATH``), ``image_size``
    (the crop, default 224), ``n_classes`` (default 1000; inferred from
    the labels on disk when not given), and for the synthetic stand-in
    ``store_size`` (default ``max(image_size + 8, 64)``), ``n_train``,
    ``n_val`` and ``shard_size``; ``loader_workers`` (default 0, inline):
    the number of spawned processes that load, crop and shuffle the
    training shards (:meth:`cleanup` stops them)."""

    #: on-device normalization constants: (mean, 1/std) in [0, 255] RGB
    norm_stats = (MEAN_RGB, (1.0 / STD_RGB).astype(np.float32))

    def __init__(self, config: dict | None = None):
        config = config or {}
        self.image_size = config.get("image_size", 224)
        self.loader_workers = int(config.get("loader_workers", 0))
        path = config.get("data_path") or os.environ.get("IMAGENET_PATH")
        if path and os.path.isdir(os.path.join(path, "train")):
            self.synthetic = False
            self._train = _ShardSet(os.path.join(path, "train"))
            self._val = _ShardSet(os.path.join(path, "val"))
            probe = read_with_retry(
                lambda: np.load(self._train.x_files[0], mmap_mode="r"),
                what=self._train.x_files[0])
            self.store_size = int(probe.shape[1])
            if "n_classes" in config:
                self.n_classes = config["n_classes"]
            else:
                # both splits: a sampled val set may lack the highest id
                ys = [read_with_retry(lambda p=p: np.load(p), what=p)
                      for p in (*self._train.y_files, *self._val.y_files)]
                self.n_classes = int(max(y.max() for y in ys)) + 1
        else:
            self.synthetic = True
            self.store_size = config.get("store_size",
                                         max(self.image_size + 8, 64))
            self.n_classes = config.get("n_classes", 1000)
            shard = config.get("shard_size", 128)
            self._train = _SyntheticShards(
                config.get("n_train", 2048), self.n_classes, self.store_size,
                shard, seed=1)
            self._val = _SyntheticShards(
                config.get("n_val", 512), self.n_classes, self.store_size,
                shard, seed=2)
        self.n_train = self._train.n
        self.n_val = self._val.n
        self.sample_shape = (self.image_size, self.image_size, 3)
        self._shm_pool = None

    def _pool(self):
        """The worker ring, spawned at first use and kept for every epoch
        until :meth:`cleanup`."""
        if self._shm_pool is None:
            from theanompi_torch.models.data.shm_loader import ShmShardPool

            self._shm_pool = ShmShardPool(self.image_size,
                                          max(self._train.lens),
                                          self.loader_workers)
        return self._shm_pool

    def cleanup(self) -> None:
        if self._shm_pool is not None:
            self._shm_pool.close()
            self._shm_pool = None

    def _augmented_shards(self, src, tagged, train: bool, epoch=0, seed=0):
        """Per-shard (x, y), augmented for train.  ``tagged`` is ``[(pos,
        shard index), ...]``; ``pos``, the shard's place in the epoch's
        order, keys its augmentation (``derive_seed("augment", seed,
        epoch, pos)``), so any shard is recomputable alone.  With
        ``loader_workers > 0`` the training shards go to the worker ring,
        which runs this loop's steps on the same keyed seeds and hands
        the shards back in order."""
        if train and self.loader_workers > 0:
            tasks = [(src.spec(int(i)),
                      derive_seed("augment", seed, epoch, int(pos)))
                     for pos, i in tagged]
            yield from self._pool().run(tasks)
            return
        for pos, i in tagged:
            x, y = src.load(int(i))
            if train:
                rng = np.random.RandomState(
                    derive_seed("augment", seed, epoch, int(pos)))
                x = random_crop_mirror(x, self.image_size, rng)
                within = rng.permutation(len(x))
                x, y = x[within], y[within]
            else:
                x = center_crop(x, self.image_size)
            yield x, y

    def _batches(self, src, batch_size, train: bool, epoch=0, seed=0,
                 start_batch=0, rows=None):
        """Shards in shuffled order (train) through a rolling remainder
        buffer, so batches of exactly ``batch_size`` cross shard
        boundaries; the ragged tail is dropped.  ``start_batch`` starts
        the stream at sample ``start_batch * batch_size``: the exact tail
        of an uninterrupted epoch.  ``rows=(lo, hi)`` keeps rows ``lo:hi``
        of each batch.  A shard none of whose samples is kept is never
        read (nor generated, nor augmented)."""
        n_shards = len(src.lens)
        if train:
            order = np.random.RandomState(
                derive_seed("shards", seed, epoch)).permutation(n_shards)
        else:
            order = np.arange(n_shards)
        lo, hi = (0, batch_size) if rows is None else rows
        first = int(start_batch) * batch_size
        end = src.n // batch_size * batch_size
        needed, masks, pos = [], [], 0
        for tag in enumerate(order):
            p = pos + np.arange(src.lens[int(tag[1])])
            pos += len(p)
            keep = (p >= first) & (p < end) & (p % batch_size >= lo) & (
                p % batch_size < hi)
            if keep.any():
                needed.append(tag)
                masks.append(keep)
        buf_x: list[np.ndarray] = []
        buf_y: list[np.ndarray] = []
        have, width = 0, hi - lo
        shards = self._augmented_shards(src, needed, train, epoch, seed)
        try:
            for keep, (x, y) in zip(masks, shards):
                if not keep.all():
                    x, y = x[keep], y[keep]
                buf_x.append(x)
                buf_y.append(y)
                have += len(x)
                while have >= width:
                    bx = (np.concatenate(buf_x) if len(buf_x) > 1
                          else buf_x[0])
                    by = (np.concatenate(buf_y) if len(buf_y) > 1
                          else buf_y[0])
                    yield {"x": bx[:width], "y": by[:width]}
                    buf_x, buf_y = [bx[width:]], [by[width:]]
                    have -= width
        finally:
            # release the pool's epoch now, whether the epoch ended or
            # was closed early, not whenever the generator is collected
            shards.close()

    def train_batches(self, batch_size: int, epoch: int, seed: int = 0,
                      start_batch: int = 0, rows=None):
        return self._batches(self._train, batch_size, train=True,
                             epoch=epoch, seed=seed, start_batch=start_batch,
                             rows=rows)

    def val_batches(self, batch_size: int, rows=None):
        return self._batches(self._val, batch_size, train=False, rows=rows)
