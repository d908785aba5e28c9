"""Training data: the vocoder dataset, registered in ``DATASETS``."""

from .naive import NaiveDataset, NaiveVOCODERDataset

__all__ = ["NaiveDataset", "NaiveVOCODERDataset"]
