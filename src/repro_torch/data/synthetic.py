"""Synthetic datasets (offline: no CIFAR download, no text corpus).

``make_image_dataset`` builds a class-conditional image dataset whose
difficulty is controllable: each class c gets a random low-frequency
template; samples are template + per-sample Gaussian noise + random
global brightness/contrast jitter. ``make_token_dataset`` builds an LM corpus
of per-domain Zipfian token streams. Both are exact numpy transcriptions
of ``repro.data.synthetic``: one seed gives the same arrays in both
packages.
"""
from __future__ import annotations

import numpy as np


def make_image_dataset(
    num_classes: int = 10,
    train_per_class: int = 500,
    test_per_class: int = 100,
    hw: int = 16,
    channels: int = 3,
    noise: float = 0.9,
    seed: int = 0,
    template_seed: int = 1234,
):
    """Class templates are ORTHONORMAL low-frequency patterns drawn from a
    fixed ``template_seed``, so the Bayes difficulty is identical across
    ``seed`` (which only varies sampling/noise/partition). Images are NHWC
    float32, labels int32: ((xtr, ytr), (xte, yte))."""
    rng = np.random.default_rng(seed)
    t_rng = np.random.default_rng(template_seed)
    low = t_rng.normal(size=(num_classes, 4 * 4 * channels))
    q, _ = np.linalg.qr(low.T)                   # orthonormal columns
    low = (q.T[:num_classes] * np.sqrt(4 * 4 * channels)).reshape(
        num_classes, 4, 4, channels)
    reps = hw // 4
    templates = np.repeat(np.repeat(low, reps, axis=1), reps, axis=2)

    def sample(n_per_class, rng):
        xs, ys = [], []
        for c in range(num_classes):
            base = templates[c][None]
            x = base + noise * rng.normal(
                size=(n_per_class, hw, hw, channels))
            # global jitter (brightness/contrast) to break trivial cues
            bright = rng.normal(scale=0.2, size=(n_per_class, 1, 1, 1))
            x = x * (1 + bright) + 0.1 * rng.normal(
                size=(n_per_class, 1, 1, 1))
            xs.append(x)
            ys.append(np.full(n_per_class, c, np.int32))
        x = np.concatenate(xs).astype(np.float32)
        y = np.concatenate(ys)
        perm = rng.permutation(len(y))
        return x[perm], y[perm]

    xtr, ytr = sample(train_per_class, rng)
    xte, yte = sample(test_per_class, np.random.default_rng(seed + 1))
    return (xtr, ytr), (xte, yte)


def make_token_dataset(
    vocab_size: int = 1024,
    num_domains: int = 8,
    docs_per_domain: int = 64,
    seq_len: int = 128,
    seed: int = 0,
):
    """Per-domain Zipf token streams (domains are latent classes): each
    domain draws its documents of ``seq_len + 1`` tokens from its own
    permutation of a Zipf(1.2) distribution. Returns (tokens int32
    (num_domains * docs_per_domain, seq_len + 1), domain int32), shuffled;
    an exact transcription of ``repro.data.synthetic.make_token_dataset``.
    """
    rng = np.random.default_rng(seed)
    xs, ds = [], []
    for d in range(num_domains):
        ranks = rng.permutation(vocab_size)
        p = 1.0 / (1.0 + np.arange(vocab_size, dtype=np.float64)) ** 1.2
        p /= p.sum()
        probs = np.empty(vocab_size)
        probs[ranks] = p
        toks = rng.choice(vocab_size, size=(docs_per_domain, seq_len + 1),
                          p=probs)
        xs.append(toks)
        ds.append(np.full(docs_per_domain, d, np.int32))
    x = np.concatenate(xs).astype(np.int32)
    dom = np.concatenate(ds)
    perm = rng.permutation(len(dom))
    return x[perm], dom[perm]
