"""ctypes bindings and lazy build for the native (C++) CSV parser.

Port of datafusion_tpu/io/native.py over the port's own copy of the
source, `datafusion_tpu_torch/native/csv_parser.cpp`. This is host code
(it parses text into numpy buffers), not a device kernel. The shared
library is compiled with g++ on first use into
`datafusion_tpu_torch/build/`, under a name keyed by the source's hash,
so a source change rebuilds and an unchanged checkout reuses the last
build. Each build compiles to a temporary name and renames it into place,
so processes that build at once never load half a file. Without a C++
toolchain `get_lib()` is None and the callers parse in Python
(columnar/csv.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import mmap
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from datafusion_tpu_torch.schema import Schema
from datafusion_tpu_torch.types import DataType

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "native" / "csv_parser.cpp"
BUILD_DIR = PKG_DIR / "build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_DTYPE_CODE = {
    DataType.Boolean: 0,
    DataType.Int8: 1,
    DataType.Int16: 2,
    DataType.Int32: 3,
    DataType.Int64: 4,
    DataType.UInt8: 5,
    DataType.UInt16: 6,
    DataType.UInt32: 7,
    DataType.UInt64: 8,
    DataType.Float32: 9,
    DataType.Float64: 10,
    DataType.Utf8: 11,
    DataType.Date32: 12,
    DataType.Timestamp: 13,  # seconds since epoch, 'YYYY-MM-DD[ ]HH:MM:SS'
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdftorch_csv_{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> bool:
    """Build the library at `so`; False when no g++ can build it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / so.name
        cmd = ["g++", *GXX_FLAGS, "-o", str(out), str(SOURCE), "-lpthread"]
        # some toolchains lack -march=native (e.g. cross images)
        for attempt in (cmd, [a for a in cmd if a != "-march=native"]):
            try:
                subprocess.run(attempt, check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                continue
            os.replace(out, so)  # atomic: a concurrent loader sees no half file
            return True
    return False


@functools.cache
def get_lib() -> Optional[ctypes.CDLL]:
    """The parser's shared library, built on first use; None when it
    cannot be built or loaded here."""
    so = library_path()
    if not so.exists() and not _compile(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.dftpu_csv_count_rows.restype = i64
    lib.dftpu_csv_count_rows.argtypes = [vp, i64, i32]
    lib.dftpu_csv_index.restype = vp
    lib.dftpu_csv_index.argtypes = [vp, i64, i32, i32, ctypes.POINTER(i64)]
    lib.dftpu_csv_index_free.restype = None
    lib.dftpu_csv_index_free.argtypes = [vp]
    lib.dftpu_csv_parse_indexed.restype = i64
    lib.dftpu_csv_parse_indexed.argtypes = [
        vp, i64, vp, i32, i32, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(vp), ctypes.POINTER(vp), i32,
    ]
    lib.dftpu_csv_parse.restype = i64
    lib.dftpu_csv_parse.argtypes = [
        vp, i64, i32, i32, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(vp), ctypes.POINTER(vp), i32,
    ]
    lib.dftpu_csv_dict_encode.restype = i64
    lib.dftpu_csv_dict_encode.argtypes = [
        vp, ctypes.POINTER(i64), i64, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(i64),
    ]
    return lib


def count_csv_rows_native(path: str, has_header: bool) -> Optional[int]:
    """Data-row count from the native index pass alone (no field is
    parsed): the metadata pass a lazy table takes at registration. None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            return 0
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            view = np.frombuffer(mm, dtype=np.uint8)
            nrows = ctypes.c_int64(0)
            idx = lib.dftpu_csv_index(ctypes.c_void_p(view.ctypes.data), size, int(has_header), 0,
                                      ctypes.byref(nrows))
            lib.dftpu_csv_index_free(idx)
            del view  # the map closes only once no buffer points into it
            n = int(nrows.value)
            return n if n >= 0 else None


def parse_csv_native(path: str, schema: Schema, has_header: bool, columns=None):
    """Parse a CSV with the native loader: `(arrays, validity)` in the
    form Table.from_arrays takes (Utf8 columns as `(codes, sorted vocab)`
    pairs), or None when the native path is unavailable (the caller
    parses in Python).

    `columns`: the column indices to parse; the others are skipped in C++
    (dtype code -1 converts and writes nothing; the field scan still
    walks the row) and come back as None entries."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            return _parse(lib, None, b"", 0, schema, has_header, columns)
        # mmap, not read(): no copy of the whole file, and the index and
        # parse threads fault pages in as they stream
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            view = np.frombuffer(mm, dtype=np.uint8)
            try:
                return _parse(lib, ctypes.c_void_p(view.ctypes.data), mm, size, schema, has_header, columns)
            finally:
                del view


def _parse(lib, buf_ptr, data, size, schema, has_header, columns):
    nrows = ctypes.c_int64(0)
    idx = lib.dftpu_csv_index(buf_ptr, size, int(has_header), 0, ctypes.byref(nrows))
    try:
        n = int(nrows.value)
        if n < 0:
            return None
        ncols = len(schema)
        want = None if columns is None else set(columns)
        dtypes = np.array([_DTYPE_CODE[f.dtype] if want is None or j in want else -1
                           for j, f in enumerate(schema.fields)], dtype=np.int32)
        bufs, valids = [], []
        out_ptrs = (ctypes.c_void_p * ncols)()
        valid_ptrs = (ctypes.c_void_p * ncols)()
        for j, field in enumerate(schema.fields):
            if dtypes[j] < 0:
                bufs.append(None)
                valids.append(None)
                continue
            if field.dtype is DataType.Utf8:
                arr = np.zeros((n, 2), dtype=np.int64)  # (offset, length) into the file
            elif field.dtype is DataType.Boolean:
                arr = np.zeros((n,), dtype=np.uint8)
            else:
                arr = np.zeros((n,), dtype=field.dtype.to_np())
            v = np.zeros((n,), dtype=np.uint8)
            bufs.append(arr)
            valids.append(v)
            out_ptrs[j] = arr.ctypes.data
            valid_ptrs[j] = v.ctypes.data
        parsed = int(lib.dftpu_csv_parse_indexed(
            buf_ptr, size, idx, int(has_header), ncols,
            dtypes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out_ptrs, valid_ptrs, 0,
        ))
        if parsed != n:
            return None
        return _finish_columns(lib, buf_ptr, data, n, schema, bufs, valids)
    finally:
        lib.dftpu_csv_index_free(idx)


def _finish_columns(lib, buf_ptr, data, n, schema, bufs, valids):
    arrays, validity = [], []
    for j, field in enumerate(schema.fields):
        if bufs[j] is None:  # skipped (a column-subset parse)
            arrays.append(None)
            validity.append(None)
            continue
        if field.dtype is DataType.Utf8:
            # dictionary-encode in C++ (a byte-order sorted vocabulary is
            # Python's str order); only the vocabulary is decoded here
            codes = np.zeros((n,), dtype=np.int32)
            vocab_pairs = np.zeros((n, 2), dtype=np.int64)
            k = int(lib.dftpu_csv_dict_encode(
                buf_ptr, bufs[j].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                vocab_pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ))
            vocab = [data[o:o + ln].decode("utf-8").replace('""', '"') for o, ln in vocab_pairs[:k].tolist()]
            # unescaping quotes can merge or reorder raw-byte entries:
            # re-canonicalize at vocabulary scale when it does
            if any(vocab[i] >= vocab[i + 1] for i in range(k - 1)):
                uvocab, inv = np.unique(np.asarray(vocab, dtype=object).astype(str), return_inverse=True)
                codes = inv.astype(np.int32)[codes]
                vocab = uvocab.tolist()
            arrays.append((codes, tuple(vocab)))
            validity.append(None)
        else:
            arrays.append(bufs[j].astype(np.bool_) if field.dtype is DataType.Boolean else bufs[j])
            v = valids[j]
            validity.append(None if v.all() else v.astype(np.bool_))
    if all(v is None for v in validity):
        validity = None
    return arrays, validity
