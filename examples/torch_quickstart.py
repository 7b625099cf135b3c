"""Quickstart on the PyTorch port: FedEntropy on the paper's CNN, the
twin of ``examples/quickstart.py`` written against ``repro_torch``.

Reproduces the paper's core loop (Alg. 2) at toy scale through the
pluggable ``repro_torch.fl`` API: ``build("fedentropy", ...)`` composes
epsilon-greedy pools + maximum-entropy judgment + weighted aggregation,
``build("fedavg", ...)`` the uniform/admit-all baseline. Prints the
per-round positive/negative split and the accuracy trajectory, in the
reference script's lines.

Client data rides in a device-resident ``ClientCorpus`` (uint8 storage +
on-device normalization when pointed at a real CIFAR-10 directory). It
runs on the card unless ``--device cpu``:

  PYTHONPATH=src python examples/torch_quickstart.py [path/to/cifar-10-batches-py]
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

import repro_torch.fl as fl
from repro_torch.data import ClientCorpus, load_image_corpus
from repro_torch.data.partition import partition
from repro_torch.device import resolve_device
from repro_torch.models import cnn

NUM_CLIENTS, CLASSES, ROUNDS = 12, 4, 8


def main(argv=None, *, params=None) -> dict:
    """Runs both compositions; returns {name: server}. ``params`` (a CNN
    parameter dict) replaces the port's own seeded init."""
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=None,
                    help="a CIFAR-10 directory (default: synthetic)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    src = load_image_corpus(args.root, num_classes=CLASSES,
                            train_per_class=100, test_per_class=25, hw=16,
                            noise=0.6, seed=3)
    (xtr, ytr), (xte, yte) = src.train, src.test
    parts = partition("case1", ytr, NUM_CLIENTS, src.num_classes, seed=0)
    # storage dtype (uint8 for CIFAR-10) stays resident; normalization
    # happens on device inside the per-round cohort gather
    corpus = ClientCorpus.from_parts(xtr, ytr, parts, batch_multiple=25,
                                     transform=src.transform, device=device)
    dtype = str(corpus["x"].dtype).removeprefix("torch.")
    print(f"corpus: {src.source}, {corpus.num_clients} clients, "
          f"{dtype} resident, {corpus.nbytes / 1e6:.1f} MB")
    if params is None:
        params = cnn.init(torch.Generator().manual_seed(0),
                          image_hw=xtr.shape[1],
                          num_classes=src.num_classes)
    xte = torch.as_tensor(xte, device=device)
    if src.transform is not None:
        xte = src.transform(xte)
    test = (xte, torch.as_tensor(yte, device=device))

    results, servers = {}, {}
    for name, method in [("FedEntropy", "fedentropy"), ("FedAvg", "fedavg")]:
        server = fl.build(
            method, cnn.apply, params, corpus,
            fl.ServerConfig(num_clients=NUM_CLIENTS, participation=0.34,
                            seed=0),
            fl.LocalSpec(epochs=2, batch_size=25, lr=0.02), device=device)
        print(f"== {name} ==")
        for r in range(ROUNDS):
            rec = server.round()
            acc = server.evaluate(*test)["accuracy"]
            print(f"  round {r}: positives={len(rec['positive'])}/"
                  f"{len(rec['selected'])} entropy={rec['entropy']:.3f} "
                  f"acc={acc:.3f} "
                  f"uplink_savings={rec['comm']['savings_fraction']:.0%}")
        results[name], servers[name] = acc, server
    print(f"\nfinal: FedEntropy={results['FedEntropy']:.3f} "
          f"vs FedAvg={results['FedAvg']:.3f}")
    return servers


if __name__ == "__main__":
    main()
