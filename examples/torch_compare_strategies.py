"""Paper Table 3 in miniature on the PyTorch port: every FL optimizer,
with and without FedEntropy's device grouping, on the same non-IID
split; the twin of ``examples/compare_strategies.py`` written against
``repro_torch``.

The "+fedentropy" column is a two-keyword override of the plain
composition: swap the selector to the epsilon-greedy pools and the judge
to maximum entropy — the local update rule is untouched (the paper's
orthogonality argument, Sec. 3.4). It runs on the card unless
``--device cpu``:

  PYTHONPATH=src python examples/torch_compare_strategies.py
  PYTHONPATH=src python examples/torch_compare_strategies.py --device cpu
"""
import argparse

import torch

import repro_torch.fl as fl
from repro_torch.data.partition import partition, stack_clients
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.device import resolve_device
from repro_torch.models import cnn

ROUNDS = 6
STRATEGIES = ("fedavg", "fedprox", "scaffold", "moon")


def main(argv=None, *, params=None) -> dict:
    """Runs every composition; returns {(strategy, "plain" or
    "+fedentropy"): server}. ``params`` replaces the seeded init."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    (xtr, ytr), (xte, yte) = make_image_dataset(
        num_classes=4, train_per_class=80, test_per_class=20, hw=16,
        noise=0.4, seed=1)
    parts = partition("case1", ytr, 10, 4, seed=0)
    data = stack_clients(xtr, ytr, parts, batch_multiple=20)
    if params is None:
        params = cnn.init(torch.Generator().manual_seed(0), image_hw=16,
                          num_classes=4)
    test = (torch.as_tensor(xte, device=device),
            torch.as_tensor(yte, device=device))

    servers = {}
    print(f"{'strategy':10s} {'plain':>8s} {'+fedentropy':>12s}")
    for strat in STRATEGIES:
        accs = []
        for col, overrides in (("plain", {}), ("+fedentropy", {
                "selector": "pools", "judge": "maxent"})):
            server = fl.build(
                strat, cnn.apply, params, data,
                fl.ServerConfig(num_clients=10, participation=0.4, seed=0),
                fl.LocalSpec(epochs=2, batch_size=20, lr=0.02),
                device=device, **overrides)
            server.fit(ROUNDS)
            accs.append(server.evaluate(*test)["accuracy"])
            servers[strat, col] = server
        print(f"{strat:10s} {accs[0]:8.3f} {accs[1]:12.3f}")
    return servers


if __name__ == "__main__":
    main()
