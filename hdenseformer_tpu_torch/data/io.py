"""HDF5 case files, as ``hdenseformer_tpu/data/io.py`` reads them.

``h5py`` is imported inside the reader, so that the rest of the port
imports on a machine without it.
"""
from __future__ import annotations

import numpy as np


def hdf5_reader(data_path: str, key: str) -> np.ndarray:
    import h5py

    with h5py.File(data_path, "r") as f:
        return np.asarray(f[key], dtype=np.float32)
