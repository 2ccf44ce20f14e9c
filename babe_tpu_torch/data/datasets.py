"""Training streams batched by ``Batcher``, and the testers' test sets.

Counterpart of ``babe_tpu/data/datasets.py``, on its Python path.  The
training streams are infinite: a random file, then 8 random crops of it,
drawn with Python's ``random.Random(seed)`` in the same order as the JAX
package draws them, so one seed gives the same crops in both packages.  The
JAX package's native C++ loader (``babe_tpu/native``) is not ported;
``setup_dataset`` says so and reads with the Python path.

  * ``AudioFolderDataset``: a flat folder of *.wav,
  * ``MaestroDataset`` / ``MaestroDatasetFs``: MAESTRO v3 by year and split
    (the latter yields (segment, native fs) pairs, resampled later),
  * ``CocoChoralesDataset``: random 1-4 stem mixtures,
  * overfit mode: one 50 s excerpt looped.

The test sets (``setup_dataset_test``) are lists of (audio, fs, name):
``AudioFolderDatasetTest`` (a folder, cropped with numpy's
``default_rng(seed)``) and ``MaestroDatasetTestChunks`` (MAESTRO's test
split, from 10 s in).
"""

from __future__ import annotations

import csv
import glob
import os
import queue
import random
import threading
from typing import Iterator

import numpy as np

from babe_tpu_torch.data.wavio import read_wav, to_mono


def _eight_random_crops(data: np.ndarray, seg_len: int, rng: random.Random,
                        overfit: bool):
    if len(data) <= seg_len:
        return
    for _ in range(8):
        idx = 0 if overfit else rng.randint(0, len(data) - seg_len - 1)
        yield data[idx:idx + seg_len].astype(np.float32)


class AudioFolderDataset:
    """Infinite stream over a flat folder of *.wav."""

    yields_fs = False

    def __init__(self, dset_args, fs=44100, seg_len=131072, overfit=False,
                 seed=42):
        self.rng = random.Random(seed)
        self.files = sorted(glob.glob(os.path.join(str(dset_args.path),
                                                   "*.wav")))
        assert self.files, "error in dataloading: empty or nonexistent folder"
        self.seg_len = int(seg_len)
        self.fs = fs
        self.overfit = overfit
        if overfit:
            data, sr = read_wav(self.files[0])
            self.overfit_sample = to_mono(data)[10 * sr:60 * sr]

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            if self.overfit:
                data = self.overfit_sample
            else:
                data = to_mono(read_wav(self.rng.choice(self.files))[0])
            yield from _eight_random_crops(data, self.seg_len, self.rng,
                                           self.overfit)


def _maestro_filelist(path: str, years: set[int], split: str) -> list[str]:
    meta = os.path.join(path, "maestro-v3.0.0.csv")
    out = []
    with open(meta) as f:
        for row in csv.DictReader(f):
            if int(row["year"]) in years and row["split"] == split:
                out.append(os.path.join(path, row["audio_filename"]))
    assert out, f"no MAESTRO files for years={years} split={split}"
    return out


class MaestroDataset:
    """MAESTRO v3 training stream at a fixed fs."""

    yields_fs = False

    def __init__(self, dset_args, fs=44100, seg_len=131072, overfit=False,
                 seed=42):
        self.rng = random.Random(seed)
        years = set(int(y) for y in dset_args.years)
        self.files = _maestro_filelist(str(dset_args.path), years, "train")
        self.seg_len = int(seg_len)
        self.overfit = overfit
        if overfit:
            data, sr = read_wav(self.files[0])
            self.overfit_sample = to_mono(data)[10 * sr:60 * sr]

    def __iter__(self):
        while True:
            if self.overfit:
                data = self.overfit_sample
            else:
                data = to_mono(read_wav(self.rng.choice(self.files))[0])
            yield from _eight_random_crops(data, self.seg_len, self.rng,
                                           self.overfit)


class MaestroDatasetFs(MaestroDataset):
    """MAESTRO stream of (segment, native fs) pairs of ``dset.load_len``
    samples, resampled to the model's rate per batch."""

    yields_fs = True

    def __init__(self, dset_args, overfit=False, seed=42):
        super().__init__(dset_args, seg_len=int(dset_args.load_len),
                         overfit=overfit, seed=seed)

    def __iter__(self):
        while True:
            file = self.files[0] if self.overfit else self.rng.choice(
                self.files)
            data, sr = read_wav(file)
            for seg in _eight_random_crops(to_mono(data), self.seg_len,
                                           self.rng, self.overfit):
                yield seg, sr


class MaestroDatasetTestChunks:
    """MAESTRO test split: the first ``num_samples`` files, each cropped to
    ``dset.load_len`` samples from 10 s in; items (audio, fs, name)."""

    def __init__(self, dset_args, num_samples=4, seed=42):
        years = set(int(y) for y in dset_args.years)
        files = _maestro_filelist(str(dset_args.path), years, "test")
        self.seg_len = int(dset_args.load_len)
        self.items = []
        for file in files[:num_samples]:
            data, sr = read_wav(file)
            data = to_mono(data)
            self.items.append((data[10 * sr:10 * sr + self.seg_len], sr,
                               os.path.basename(file)))

    def __getitem__(self, idx):
        return self.items[idx]

    def __len__(self):
        return len(self.items)


class AudioFolderDatasetTest:
    """A folder test set (``dset.test.path``): the first ``num_samples``
    wavs, each cropped at a random start (numpy ``default_rng(seed)``) or
    tiled to ``seg_len``; items (audio, fs, name)."""

    def __init__(self, dset_args, fs=44100, seg_len=131072, num_samples=4,
                 seed=42):
        rng = np.random.default_rng(seed)
        files = sorted(glob.glob(os.path.join(str(dset_args.test.path),
                                              "*.wav")))
        assert files, "error in dataloading: empty or nonexistent folder"
        stereo = bool(dset_args.test.get("stereo", False))
        self.items = []
        for file in files[:num_samples]:
            data, sr = read_wav(file)
            data = data.T if data.ndim == 2 else data
            if data.shape[-1] >= seg_len:
                idx = int(rng.integers(0, data.shape[-1] - seg_len))
                data = data[..., idx:idx + seg_len]
            else:
                reps = seg_len // data.shape[-1] + 1
                data = np.tile(data, reps)[..., :seg_len]
            if not stereo and data.ndim > 1:
                data = data.mean(axis=0)
            self.items.append((data.astype(np.float32), sr,
                               os.path.basename(file)))

    def __getitem__(self, idx):
        return self.items[idx]

    def __len__(self):
        return len(self.items)


class CocoChoralesDataset:
    """Random 1-4 stem mixtures from per-track stem folders."""

    yields_fs = False

    def __init__(self, dset_args, fs=44100, seg_len=131072, overfit=False,
                 seed=42):
        assert not overfit, "overfit mode not supported for stem mixtures"
        self.rng = random.Random(seed)
        self.dirs = sorted(glob.glob(os.path.join(str(dset_args.path), "*/")))
        assert self.dirs, "error in dataloading: empty or nonexistent folder"
        self.seg_len = int(seg_len)
        self.p_quartet = float(dset_args.get("prob_quartet", 0.25))
        self.p_trio = float(dset_args.get("prob_trio", 0.25))
        self.p_duo = float(dset_args.get("prob_duo", 0.25))

    def _num_stems(self) -> int:
        r = self.rng.random()
        if r < self.p_quartet:
            return 4
        if r < self.p_quartet + self.p_trio:
            return 3
        if r < self.p_quartet + self.p_trio + self.p_duo:
            return 2
        return 1

    def __iter__(self):
        while True:
            d = self.rng.choice(self.dirs)
            stems = sorted(glob.glob(os.path.join(d, "*.wav")))
            if not stems:
                continue
            n = min(self._num_stems(), len(stems))
            chosen = self.rng.sample(stems, n)
            audio = [to_mono(read_wav(s)[0]) for s in chosen]
            L = min(len(a) for a in audio)
            if L <= self.seg_len:
                continue
            for _ in range(8):
                idx = self.rng.randint(0, L - self.seg_len - 1)
                seg = sum(a[idx:idx + self.seg_len] for a in audio)
                yield seg.astype(np.float32)


class Batcher:
    """Batch an infinite sample stream on a background thread.  Yields
    [B, T] float32, or ([B, T], fs [B]) for a stream of (segment, fs)
    pairs."""

    def __init__(self, dataset, batch_size: int, prefetch: int = 8):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        it = iter(self.dataset)
        try:
            while not self._stop.is_set():
                items = [next(it) for _ in range(self.batch_size)]
                if isinstance(items[0], tuple):
                    self.q.put((np.stack([a for a, _ in items]),
                                np.asarray([f for _, f in items])))
                else:
                    self.q.put(np.stack(items))
        except StopIteration:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()


def setup_dataset(args) -> Batcher:
    """The training stream of ``args.dset`` (its ``callable`` resolved by
    name through ``babe_tpu_torch.setup``), batched to
    exp.batch * exp.num_accumulation_rounds, read with the Python path."""
    from babe_tpu_torch.setup import dataset_class

    dcfg = args.dset
    cls = dataset_class(dcfg.callable)
    overfit = bool(args.get_path("dset.overfit", False))
    rf = int(args.exp.get("resample_factor", 1))
    if cls.yields_fs:
        ds = cls(dcfg, overfit=overfit)
    else:
        ds = cls(dcfg, fs=int(args.exp.sample_rate) * rf,
                 seg_len=int(args.exp.audio_len) * rf, overfit=overfit)
    print("data: reading with the Python path (the JAX package's native C++ "
          "loader is not ported)")
    loader_batch = int(args.exp.batch) * int(
        args.exp.get("num_accumulation_rounds", 1))
    return Batcher(ds, loader_batch)


def setup_dataset_test(args):
    """The test set of ``args.dset.test`` (its ``callable`` resolved by name
    through ``babe_tpu_torch.setup``): ``dset.test.num_samples`` items of
    (audio, fs, name)."""
    from babe_tpu_torch.setup import test_dataset_class

    dcfg = args.dset
    cls = test_dataset_class(dcfg.test.callable)
    num = int(args.get_path("dset.test.num_samples", 4))
    if cls is MaestroDatasetTestChunks:
        return cls(dcfg, num_samples=num)
    return cls(dcfg, fs=int(args.exp.sample_rate),
               seg_len=int(args.exp.audio_len), num_samples=num)
