"""Real-image ingest: CIFAR-10/100 and CINIC-10 from disk, synthetic
fallback. A transcription of ``repro.data.ingest`` (numpy only; the
arrays are equal bit for bit).

Nothing here downloads. Three on-disk formats share one surface:

* :func:`load_cifar10`  — the standard python-pickle release
  (``cifar-10-batches-py/`` with ``data_batch_1..5`` + ``test_batch``).
* :func:`load_cifar100` — the same pickle format's 100-class release
  (``cifar-100-python/`` with ``train`` + ``test`` files, fine labels).
* :func:`load_cinic10`  — the CINIC-10 directory layout
  (``train/<class>/*.png`` + ``test/<class>/*.png``; per-class ``.npy``
  stacks are also accepted so tests and PIL-less environments work).

All return **uint8** HWC images — the natural storage dtype of either
data plane, which normalizes on the device after the cohort gather with
the matching ``*_normalizer()``.

:func:`load_image_corpus` is the single entry point: it auto-detects
which of the three layouts lives under ``root`` (or takes ``dataset=``
explicitly), fails loudly on an empty root, and
falls back to the synthetic class-template dataset when no root is
given, attaching the right ``Normalize`` transform and a ``source`` tag
so runs record what they trained on. The first real load writes a
packed ``.npy`` cache next to the dataset
(``<root>/repro-packed/<name>/``); repeated runs memory-map it
(``np.load(mmap_mode="r")``) instead of re-parsing pickles/PNGs, and
:class:`repro_torch.data.stream.HostCorpus` can stack from the mapped
splits without a private copy of the set. The cache's directory name is
the reference's, so both packages share one cache.
"""
from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass

import numpy as np

from .corpus import Normalize
from .synthetic import make_image_dataset

# per-channel training-set statistics (the standard published values)
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)
CINIC10_MEAN = (0.47889522, 0.47227842, 0.43047404)
CINIC10_STD = (0.24205776, 0.23828046, 0.25874835)

_TRAIN_BATCHES = tuple(f"data_batch_{i}" for i in range(1, 6))
_TEST_BATCH = "test_batch"
_CINIC_PARTS = ("train", "test")


def cifar10_normalizer() -> Normalize:
    """uint8 -> float32 on-device policy: /255 then per-channel (x-m)/s."""
    return Normalize(scale=1.0 / 255.0, mean=CIFAR10_MEAN, std=CIFAR10_STD)


def cifar100_normalizer() -> Normalize:
    return Normalize(scale=1.0 / 255.0, mean=CIFAR100_MEAN,
                     std=CIFAR100_STD)


def cinic10_normalizer() -> Normalize:
    return Normalize(scale=1.0 / 255.0, mean=CINIC10_MEAN, std=CINIC10_STD)


def _find_file_dir(root: str, marker: str, subdir: str, hint: str) -> str:
    """Locate the directory holding pickle file ``marker`` under ``root``."""
    for cand in (root, os.path.join(root, subdir)):
        if os.path.isfile(os.path.join(cand, marker)):
            return cand
    for dirpath, _, files in os.walk(root):
        if marker in files:
            return dirpath
    raise FileNotFoundError(f"no {hint} under {root!r}")


def _read_batch(path: str, label_key: bytes = b"labels"
                ) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        blob = pickle.load(f, encoding="bytes")
    x = np.asarray(blob[b"data"], np.uint8)          # (n, 3072) CHW-flat
    y = np.asarray(blob[label_key], np.int32)
    x = x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)   # -> (n, 32, 32, 3)
    return np.ascontiguousarray(x), y


def load_cifar10(root: str):
    """((xtr, ytr), (xte, yte)) — x uint8 (n, 32, 32, 3), y int32."""
    d = _find_file_dir(
        root, _TRAIN_BATCHES[0], "cifar-10-batches-py",
        "CIFAR-10 python batches (data_batch_1..5); extract "
        "cifar-10-python.tar.gz there or pass its directory")
    xs, ys = zip(*(_read_batch(os.path.join(d, b)) for b in _TRAIN_BATCHES))
    xtr, ytr = np.concatenate(xs), np.concatenate(ys)
    xte, yte = _read_batch(os.path.join(d, _TEST_BATCH))
    return (xtr, ytr), (xte, yte)


def load_cifar100(root: str):
    """CIFAR-100 python release: same pickle format, ``train``/``test``
    files, 100 *fine* labels. Returns ((xtr, ytr), (xte, yte)) uint8."""
    d = _find_file_dir(
        root, "train", "cifar-100-python",
        "CIFAR-100 python release (train/test pickles); extract "
        "cifar-100-python.tar.gz there or pass its directory")
    xtr, ytr = _read_batch(os.path.join(d, "train"), b"fine_labels")
    xte, yte = _read_batch(os.path.join(d, "test"), b"fine_labels")
    return (xtr, ytr), (xte, yte)


def _load_image_file(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"reading {path!r} needs Pillow, which is not installed — "
            "provide per-class .npy stacks instead (any (n, h, w, 3) "
            "uint8 array per class directory)") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _read_class_dir(cdir: str) -> np.ndarray:
    """All images in one class directory: .npy stacks and/or png/jpeg."""
    xs = []
    for fname in sorted(os.listdir(cdir)):
        ext = fname.lower().rsplit(".", 1)[-1]
        path = os.path.join(cdir, fname)
        if ext == "npy":
            arr = np.asarray(np.load(path), np.uint8)
            xs.append(arr if arr.ndim == 4 else arr[None])
        elif ext in ("png", "jpg", "jpeg"):
            xs.append(_load_image_file(path)[None])
    if not xs:
        raise FileNotFoundError(f"no .npy/.png/.jpeg images in {cdir!r}")
    return np.concatenate(xs)


def _find_cinic_dir(root: str) -> str:
    for cand in (root, os.path.join(root, "CINIC-10"),
                 os.path.join(root, "cinic-10")):
        if all(os.path.isdir(os.path.join(cand, p)) for p in _CINIC_PARTS):
            return cand
    for dirpath, dirs, _ in os.walk(root):
        if all(p in dirs for p in _CINIC_PARTS):
            return dirpath
    raise FileNotFoundError(
        f"no CINIC-10 layout (train/ + test/ class directories) under "
        f"{root!r}")


def load_cinic10(root: str):
    """CINIC-10 directory layout: ``train/<class>/`` + ``test/<class>/``
    holding png/jpeg images or ``.npy`` stacks. Class indices follow the
    sorted class-directory names — for the real CINIC-10 that is the
    CIFAR-10 label order, which is alphabetical. Returns
    ((xtr, ytr), (xte, yte)) uint8 HWC; the ``valid/`` split, when
    present, is deliberately left out (fold it into ``train/`` on disk to
    use it)."""
    d = _find_cinic_dir(root)

    def part(name: str):
        pdir = os.path.join(d, name)
        classes = sorted(c for c in os.listdir(pdir)
                         if os.path.isdir(os.path.join(pdir, c)))
        if not classes:
            raise FileNotFoundError(f"no class directories in {pdir!r}")
        xs, ys = [], []
        for ci, cname in enumerate(classes):
            x = _read_class_dir(os.path.join(pdir, cname))
            xs.append(x)
            ys.append(np.full(x.shape[0], ci, np.int32))
        return np.concatenate(xs), np.concatenate(ys)

    return part("train"), part("test")


# loader, normalizer factory, class count — keyed by dataset name
_DATASETS = {
    "cifar10": (load_cifar10, cifar10_normalizer, 10),
    "cifar100": (load_cifar100, cifar100_normalizer, 100),
    "cinic10": (load_cinic10, cinic10_normalizer, 10),
}

# ------------------------------------------------------- packed .npy cache
# First real load of a dataset writes its splits as plain .npy files next
# to the dataset (``<root>/repro-packed/<name>/``); every later load
# reopens them with ``np.load(mmap_mode="r")`` — no pickle/PNG parsing,
# no host copy of the full set, and exactly the layout
# ``repro_torch.data.stream.HostCorpus`` memory-maps directly.

_PACKED_DIRNAME = "repro-packed"
_SPLIT_KEYS = ("x_train", "y_train", "x_test", "y_test")


def packed_cache_dir(root: str, name: str) -> str:
    """Where :func:`load_image_corpus` packs dataset ``name`` under
    ``root``."""
    return os.path.join(root, _PACKED_DIRNAME, name)


def load_packed(cache_dir: str):
    """Memory-mapped ``((xtr, ytr), (xte, yte))`` from a packed cache
    directory, or None when absent/incomplete (corrupt caches fall back
    to the real loader rather than fail the run)."""
    if not os.path.isfile(os.path.join(cache_dir, "meta.json")):
        return None
    try:
        a = [np.load(os.path.join(cache_dir, f"{k}.npy"), mmap_mode="r")
             for k in _SPLIT_KEYS]
    except (OSError, ValueError):  # a corrupt cache
        return None
    return (a[0], a[1]), (a[2], a[3])


def write_packed(cache_dir: str, name: str, train: tuple,
                 test: tuple) -> None:
    """Pack the loaded splits; meta.json lands last so a partial write
    never looks like a complete cache."""
    os.makedirs(cache_dir, exist_ok=True)
    for k, v in zip(_SPLIT_KEYS, (*train, *test)):
        np.save(os.path.join(cache_dir, f"{k}.npy"), np.ascontiguousarray(v))
    with open(os.path.join(cache_dir, "meta.json"), "w") as f:
        json.dump({"dataset": name, "keys": list(_SPLIT_KEYS)}, f)


def _detect_packed(root: str) -> str | None:
    """Dataset name of a packed cache under ``root``, if one exists —
    lets auto-detection skip the raw-layout probe entirely."""
    base = os.path.join(root, _PACKED_DIRNAME)
    if not os.path.isdir(base):
        return None
    for name in sorted(os.listdir(base)):
        if name in _DATASETS and os.path.isfile(
                os.path.join(base, name, "meta.json")):
            return name
    return None


def _detect_dataset(root: str) -> str:
    """Which of the three on-disk layouts lives under ``root``."""
    for name, probe in (
            ("cifar10", lambda: _find_file_dir(
                root, _TRAIN_BATCHES[0], "cifar-10-batches-py", "x")),
            ("cifar100", lambda: _find_file_dir(
                root, "train", "cifar-100-python", "x")),
            ("cinic10", lambda: _find_cinic_dir(root))):
        try:
            probe()
            return name
        except FileNotFoundError:
            continue
    raise FileNotFoundError(
        f"no CIFAR-10 batches, CIFAR-100 pickles, or CINIC-10 class "
        f"directories under {root!r}; extract a release there or pass "
        "dataset= explicitly")


@dataclass(frozen=True)
class ImageCorpusSource:
    """What :func:`load_image_corpus` resolved to."""
    train: tuple          # (x, y) — x in storage dtype (uint8 or float32)
    test: tuple           # (x, y)
    transform: Normalize | None
    source: str           # "cifar10" | "cifar100" | "cinic10" | "synthetic"
    num_classes: int


def load_image_corpus(root: str | None = None, *, dataset: str = "auto",
                      cache: bool = True,
                      num_classes: int = 10,
                      train_per_class: int = 500, test_per_class: int = 100,
                      hw: int = 16, noise: float = 0.9,
                      seed: int = 0) -> ImageCorpusSource:
    """Real images from ``root``; synthetic when no ``root`` is given.

    A non-empty ``root`` MUST hold one of the known layouts —
    ``dataset="auto"`` (default) probes a packed cache first, then
    CIFAR-10, then CIFAR-100, then CINIC-10, and a missing or
    not-yet-populated directory raises ``FileNotFoundError`` rather than
    silently training on synthetic data. With ``cache=True`` (default)
    the first real load writes packed ``.npy`` splits under
    ``<root>/repro-packed/<dataset>/`` and later loads reopen them with
    ``np.load(mmap_mode="r")`` — skipping pickle/PNG parsing and giving
    the streaming data plane a host store it can map without a copy.
    The synthetic keyword set mirrors ``make_image_dataset`` (reduced
    scale by default); the real datasets ignore those knobs and return
    the full uint8 set with the on-device normalizer attached.
    """
    if root:
        if dataset == "auto":
            name = ((_detect_packed(root) if cache else None)
                    or _detect_dataset(root))
        else:
            name = dataset
        if name not in _DATASETS:
            raise ValueError(
                f"unknown dataset {dataset!r}; expected one of "
                f"{('auto', *sorted(_DATASETS))}")
        loader, normalizer, ncls = _DATASETS[name]
        packed = load_packed(packed_cache_dir(root, name)) if cache \
            else None
        if packed is not None:
            (xtr, ytr), (xte, yte) = packed
        else:
            (xtr, ytr), (xte, yte) = loader(root)
            if cache:
                try:
                    write_packed(packed_cache_dir(root, name), name,
                                 (xtr, ytr), (xte, yte))
                except OSError:  # read-only dataset mounts are fine
                    pass
        return ImageCorpusSource((xtr, ytr), (xte, yte), normalizer(),
                                 name, ncls)
    if dataset != "auto":
        raise ValueError(
            f"dataset={dataset!r} needs a root directory; the synthetic "
            "fallback only runs with dataset='auto'")
    (xtr, ytr), (xte, yte) = make_image_dataset(
        num_classes=num_classes, train_per_class=train_per_class,
        test_per_class=test_per_class, hw=hw, noise=noise, seed=seed)
    return ImageCorpusSource((xtr, ytr), (xte, yte), None, "synthetic",
                             num_classes)
