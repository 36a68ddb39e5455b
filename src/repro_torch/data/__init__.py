"""Synthetic training, calibration and evaluation data."""
from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticCorpus, calib_batches, make_batch, train_iterator)
