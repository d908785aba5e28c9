"""Training data, registered in ``DATASETS``: the vocoder's, the SVC
model's and the denoiser's ``.npy`` datasets, and ``ConcatDataset``."""

from .naive import NaiveDataset, NaiveDenoiserDataset, NaiveSVCDataset, NaiveVOCODERDataset
from .wrappers import ConcatDataset

__all__ = ["ConcatDataset", "NaiveDataset", "NaiveDenoiserDataset", "NaiveSVCDataset",
           "NaiveVOCODERDataset"]
