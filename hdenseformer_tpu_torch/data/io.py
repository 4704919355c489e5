"""Host-side IO: HDF5 case files and a minimal NIfTI-1 reader and writer.

A copy of ``hdenseformer_tpu/data/io.py`` (the port imports nothing of the
JAX package): per-case ``.hdf5`` files with ('ct', 'seg') or ('image',
'label') datasets, and a dependency-free NIfTI-1 reader/writer (.nii and
.nii.gz, scl slope/inter scaling, voxel spacing). ``h5py`` is imported
inside the HDF5 functions, so that the rest of the port imports on a
machine without it.
"""
from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np


def hdf5_reader(data_path: str, key: str) -> np.ndarray:
    import h5py

    with h5py.File(data_path, "r") as f:
        return np.asarray(f[key], dtype=np.float32)


def save_as_hdf5(data: np.ndarray, save_path: str, key: str) -> None:
    import h5py

    with h5py.File(save_path, "a") as f:
        if key in f:
            del f[key]
        f.create_dataset(key, data=data)


# ---------------------------------------------------------------------------
# NIfTI-1
# ---------------------------------------------------------------------------

_NII_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _NII_DTYPES.items()}


def _open_maybe_gz(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """Read a NIfTI-1 file -> (array in (z, y, x) index order, spacing (z, y, x)).

    The orientation SimpleITK's GetArrayFromImage gives (slowest axis first).
    """
    with _open_maybe_gz(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        endian = "<"
        if sizeof_hdr != 348:
            sizeof_hdr = struct.unpack(">i", hdr[0:4])[0]
            if sizeof_hdr != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
            endian = ">"
        dim = struct.unpack(endian + "8h", hdr[40:56])
        ndim = dim[0]
        shape_xyz = dim[1 : 1 + ndim]
        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        pixdim = struct.unpack(endian + "8f", hdr[76:108])
        vox_offset = struct.unpack(endian + "f", hdr[108:112])[0]
        scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
        scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
        magic = hdr[344:348]
        if magic[:2] not in (b"n+", b"ni"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        if datatype not in _NII_DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dt = np.dtype(_NII_DTYPES[datatype]).newbyteorder(endian)
        f.seek(int(vox_offset))
        count = int(np.prod(shape_xyz))
        raw = f.read(count * dt.itemsize)
        arr = np.frombuffer(raw, dtype=dt, count=count)
        # NIfTI data is Fortran-ordered over (x, y, z, ...)
        arr = arr.reshape(shape_xyz, order="F")
        if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
            slope = scl_slope if scl_slope != 0.0 else 1.0
            arr = arr.astype(np.float32) * slope + scl_inter
        arr = np.transpose(arr, tuple(range(arr.ndim))[::-1])  # -> (z, y, x)
        spacing_xyz = pixdim[1 : 1 + min(ndim, 3)]
        spacing_zyx = tuple(float(s) for s in spacing_xyz[::-1])
        return np.ascontiguousarray(arr), spacing_zyx


def write_nifti(
    path: str,
    array: np.ndarray,
    spacing: Optional[Tuple[float, ...]] = None,
) -> None:
    """Write a (z, y, x)-ordered array as a minimal NIfTI-1 (.nii / .nii.gz)."""
    arr = np.asarray(array)
    if arr.dtype not in _DTYPE_CODES:
        arr = arr.astype(np.float32)
    data = np.transpose(arr, tuple(range(arr.ndim))[::-1])  # (x, y, z), Fortran on disk
    ndim = data.ndim
    if spacing is None:
        spacing = (1.0,) * ndim
    spacing_xyz = tuple(float(s) for s in spacing[::-1])

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(arr.dtype)])
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)  # bitpix
    pixdim = [1.0] + list(spacing_xyz) + [1.0] * (7 - ndim)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    # qform/sform codes 0: spacing-only geometry
    hdr[344:348] = b"n+1\x00"

    with _open_maybe_gz(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(data).tobytes(order="F"))
