"""The port's image ingest (``repro_torch.data.ingest``).

Fake releases in the real on-disk formats, written under ``tmp_path``:
CIFAR-10 and CIFAR-100 python pickles, CINIC-10 class directories of
``.npy`` stacks (and of PNGs where Pillow is installed). Each loader's
arrays equal the reference loader's (``repro.data.ingest``) bit for bit;
detection order, the loud errors, the synthetic fallback, the normalizers'
published constants and the packed ``.npy`` cache (written, then reopened
as memory maps) are the reference's; ``HostCorpus`` maps a packed cache
directly.
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import os
import pickle
import shutil

import numpy as np
import pytest

from repro_torch.data import ingest
from repro_torch.data.corpus import ClientCorpus, Normalize
from repro_torch.data.ingest import (load_cifar10, load_cifar100,
                                     load_cinic10, load_image_corpus,
                                     load_packed, packed_cache_dir,
                                     write_packed)
from repro_torch.data.partition import partition, stack_clients
from repro_torch.data.stream import HostCorpus

_CLASSES = ("airplane", "automobile", "bird", "cat")


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro.data import ingest as j_ingest
    return j_ingest


def _write_fake_cifar10(root, n=16):
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for name in (*[f"data_batch_{i}" for i in range(1, 6)], "test_batch"):
        blob = {b"data": rng.integers(0, 256, size=(n, 3072),
                                      dtype=np.uint8),
                b"labels": rng.integers(0, 10, size=n).tolist()}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(blob, f)
    return d


def _write_fake_cifar100(root, n_train=40, n_test=10):
    d = os.path.join(root, "cifar-100-python")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(1)
    for name, n in (("train", n_train), ("test", n_test)):
        blob = {b"data": rng.integers(0, 256, size=(n, 3072),
                                      dtype=np.uint8),
                b"fine_labels": rng.integers(0, 100, size=n).tolist(),
                b"coarse_labels": rng.integers(0, 20, size=n).tolist()}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(blob, f)
    return d


def _write_fake_cinic(root, per_class=3, use_png=False):
    rng = np.random.default_rng(2)
    for part in ("train", "test"):
        for cname in _CLASSES:
            cdir = os.path.join(root, part, cname)
            os.makedirs(cdir, exist_ok=True)
            imgs = rng.integers(0, 256, size=(per_class, 32, 32, 3),
                                dtype=np.uint8)
            if use_png:
                from PIL import Image
                for i in range(per_class):
                    Image.fromarray(imgs[i]).save(
                        os.path.join(cdir, f"img_{i:03d}.png"))
            else:
                np.save(os.path.join(cdir, "stack.npy"), imgs)
    return root


def _assert_splits_equal(got, want):
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1]), strict=True):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- loaders

@pytest.mark.parametrize("dataset", ["cifar10", "cifar100", "cinic10"])
def test_loaders_equal_reference(tmp_path, ref, dataset):
    root = str(tmp_path)
    write, load, j_load = {
        "cifar10": (_write_fake_cifar10, load_cifar10, ref.load_cifar10),
        "cifar100": (_write_fake_cifar100, load_cifar100,
                     ref.load_cifar100),
        "cinic10": (_write_fake_cinic, load_cinic10, ref.load_cinic10),
    }[dataset]
    release = write(root)
    got = load(root)
    _assert_splits_equal(got, j_load(root))
    (xtr, ytr), (xte, yte) = got
    assert xtr.dtype == np.uint8 and xtr.shape[1:] == (32, 32, 3)
    assert ytr.dtype == np.int32 and xte.shape[0] == yte.shape[0]
    # the release directory itself resolves too
    if dataset != "cinic10":
        _assert_splits_equal(load(release), got)


def test_cifar_labels_and_layout(tmp_path):
    d = _write_fake_cifar100(str(tmp_path))
    (xtr, ytr), _ = load_cifar100(str(tmp_path))
    with open(os.path.join(d, "train"), "rb") as f:
        blob = pickle.load(f, encoding="bytes")
    # fine labels, and CHW-flat rows laid out as HWC
    np.testing.assert_array_equal(ytr, np.asarray(blob[b"fine_labels"]))
    np.testing.assert_array_equal(
        xtr, blob[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))


def test_cinic10_png_equals_reference(tmp_path, ref):
    pytest.importorskip("PIL")
    _write_fake_cinic(str(tmp_path), per_class=2, use_png=True)
    got = load_cinic10(str(tmp_path))
    _assert_splits_equal(got, ref.load_cinic10(str(tmp_path)))
    np.testing.assert_array_equal(got[0][1], np.repeat(np.arange(4), 2))


def test_cinic10_without_pillow_is_loud(tmp_path, monkeypatch):
    _write_fake_cinic(str(tmp_path), per_class=1)
    png = tmp_path / "train" / "cat" / "img.png"
    png.write_bytes(b"not read")
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(RuntimeError, match="needs Pillow"):
        load_cinic10(str(tmp_path))


@pytest.mark.parametrize("case", ["cifar10", "cifar100", "cinic10",
                                  "cinic10-empty-class"])
def test_missing_or_empty_is_loud(tmp_path, ref, case):
    if case == "cinic10-empty-class":
        (tmp_path / "train" / "cat").mkdir(parents=True)
        (tmp_path / "test" / "cat").mkdir(parents=True)
        fn, j_fn, match = load_cinic10, ref.load_cinic10, "no .npy"
    else:
        fn, j_fn = {"cifar10": (load_cifar10, ref.load_cifar10),
                    "cifar100": (load_cifar100, ref.load_cifar100),
                    "cinic10": (load_cinic10, ref.load_cinic10)}[case]
        match = {"cifar10": "CIFAR-10", "cifar100": "CIFAR-100",
                 "cinic10": "CINIC-10"}[case]
    with pytest.raises(FileNotFoundError, match=match) as got:
        fn(str(tmp_path))
    with pytest.raises(FileNotFoundError) as want:
        j_fn(str(tmp_path))
    assert str(got.value) == str(want.value)


# ------------------------------------------------- detection and fallback

def test_normalizers_are_the_published_constants(ref):
    for name in ("cifar10", "cifar100", "cinic10"):
        got = getattr(ingest, f"{name}_normalizer")()
        want = getattr(ref, f"{name}_normalizer")()
        assert isinstance(got, Normalize)
        assert (got.scale, got.mean, got.std) == \
            (want.scale, want.mean, want.std)
    assert ingest.CIFAR10_MEAN == (0.4914, 0.4822, 0.4465)


@pytest.mark.parametrize("layouts,want", [
    (("cifar10", "cifar100", "cinic10"), "cifar10"),
    (("cifar100", "cinic10"), "cifar100"),
    (("cinic10",), "cinic10")])
def test_detection_order_equals_reference(tmp_path, ref, layouts, want):
    root = str(tmp_path)
    writers = {"cifar10": _write_fake_cifar10,
               "cifar100": _write_fake_cifar100,
               "cinic10": _write_fake_cinic}
    for name in layouts:
        writers[name](root)
    got = load_image_corpus(root, cache=False)
    j_got = ref.load_image_corpus(root, cache=False)
    assert got.source == j_got.source == want
    assert got.num_classes == j_got.num_classes
    _assert_splits_equal((got.train, got.test), (j_got.train, j_got.test))


def test_explicit_dataset_and_errors_equal_reference(tmp_path, ref):
    root = str(tmp_path)
    _write_fake_cinic(root)
    assert load_image_corpus(root, dataset="cinic10").source == "cinic10"
    for kw, exc, match in (
            ({"dataset": "cifar100"}, FileNotFoundError, "CIFAR-100"),
            ({"dataset": "imagenet"}, ValueError, "unknown dataset")):
        with pytest.raises(exc, match=match):
            load_image_corpus(root, **kw)
        with pytest.raises(exc, match=match):
            ref.load_image_corpus(root, **kw)
    with pytest.raises(ValueError, match="needs a root"):
        load_image_corpus(None, dataset="cinic10")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="dataset="):
        load_image_corpus(str(empty))


def test_synthetic_fallback_equals_reference(ref):
    got = load_image_corpus(train_per_class=6, test_per_class=2, seed=3)
    want = ref.load_image_corpus(train_per_class=6, test_per_class=2,
                                 seed=3)
    assert got.source == want.source == "synthetic"
    assert got.transform is None and got.num_classes == 10
    _assert_splits_equal((got.train, got.test), (want.train, want.test))


# ---------------------------------------------------------- packed cache

def test_packed_cache_written_then_memory_mapped(tmp_path, ref):
    root = str(tmp_path)
    _write_fake_cifar10(root)
    first = load_image_corpus(root)
    cache_dir = packed_cache_dir(root, "cifar10")
    assert cache_dir == ref.packed_cache_dir(root, "cifar10")
    assert os.path.isfile(os.path.join(cache_dir, "meta.json"))
    second = load_image_corpus(root)
    assert isinstance(second.train[0], np.memmap)
    _assert_splits_equal((second.train, second.test),
                         (first.train, first.test))
    # the reference reads the port's cache, and the cache alone is enough
    shutil.rmtree(os.path.join(root, "cifar-10-batches-py"))
    third = load_image_corpus(root)
    j_third = ref.load_image_corpus(root)
    assert third.source == j_third.source == "cifar10"
    _assert_splits_equal((third.train, third.test),
                         (j_third.train, j_third.test))
    with pytest.raises(FileNotFoundError):
        load_image_corpus(root, cache=False)
    assert load_packed(str(tmp_path / "absent")) is None


def test_write_and_load_packed_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    train = (rng.integers(0, 256, (6, 4, 4, 3), dtype=np.uint8),
             rng.integers(0, 10, 6).astype(np.int32))
    test = (train[0][:2], train[1][:2])
    write_packed(str(tmp_path), "cifar10", train, test)
    (xtr, ytr), (xte, yte) = load_packed(str(tmp_path))
    assert all(isinstance(a, np.memmap) for a in (xtr, ytr, xte, yte))
    _assert_splits_equal(((xtr, ytr), (xte, yte)), (train, test))


def test_host_corpus_maps_packed_ingest(tmp_path):
    """The packed cache is plain ``.npy`` files: ``HostCorpus`` stacks
    from the mapped splits, and a saved stacked corpus reopens mapped;
    cohorts equal the resident plane's bit for bit."""
    root = str(tmp_path)
    _write_fake_cifar10(root, n=16)
    load_image_corpus(root)                      # writes the cache
    src = load_image_corpus(root)                # memory-mapped splits
    xtr, ytr = src.train
    assert isinstance(xtr, np.memmap)
    parts = partition("case1", np.asarray(ytr), 4, 10, seed=0)
    stacked = stack_clients(xtr, np.asarray(ytr), parts, batch_multiple=4)
    host = HostCorpus(stacked, transform=src.transform, device="cpu")
    dense = ClientCorpus(dict(stacked), transform=src.transform,
                         device="cpu")
    mapped = HostCorpus.open(host.save(str(tmp_path / "stacked")),
                             device="cpu")
    assert mapped.memory_report()["host_is_mmap"]
    assert mapped.transform == src.transform
    idx = np.asarray([0, 3])
    want = dense.cohort(idx)
    for corpus in (host, mapped):
        got = corpus.cohort(idx)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert bool((got[k] == want[k]).all()), k
