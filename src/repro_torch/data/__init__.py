"""Data for training and the examples (a copy of ``repro.data``)."""
from repro_torch.data.pipeline import (TokenDataset, make_lm_batches,
                                       synthetic_dataset)
