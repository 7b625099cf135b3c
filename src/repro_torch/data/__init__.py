from . import corpus, ingest, partition, stream, synthetic
from .corpus import ClientCorpus, DataQueue, Normalize
from .ingest import (
    load_cifar10, load_cifar100, load_cinic10, load_image_corpus,
)
from .stream import CohortPrefetcher, HostCorpus, as_data_plane

__all__ = [
    "ClientCorpus", "CohortPrefetcher", "DataQueue", "HostCorpus",
    "Normalize", "as_data_plane", "corpus", "ingest",
    "load_cifar10", "load_cifar100", "load_cinic10", "load_image_corpus",
    "partition", "stream", "synthetic",
]
