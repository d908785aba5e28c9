"""Training data, registered in ``DATASETS``: the vocoder's and the SVC
model's ``.npy`` datasets, and ``ConcatDataset``."""

from .naive import NaiveDataset, NaiveSVCDataset, NaiveVOCODERDataset
from .wrappers import ConcatDataset

__all__ = ["ConcatDataset", "NaiveDataset", "NaiveSVCDataset", "NaiveVOCODERDataset"]
