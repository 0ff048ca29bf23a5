"""The port's native (C++) CSV loader against its Python parser and the
JAX package's native loader.

The cases of tests/test_native_csv.py: the three CSV fixtures (quoted
strings with embedded commas, empty fields as NULLs), a 60,000-row file of
quoted fields with embedded newlines, commas and escaped quotes over
several index chunks, and a 50,000-row round trip. Each is read by the
port's `read_csv` with the native parser and with `native=False`, and
the port's `parse_csv_native` arrays are compared with the JAX package's.
"""

from pathlib import Path

import numpy as np
import pytest

import datafusion_tpu_torch as port
from datafusion_tpu.io.native import parse_csv_native as ref_parse_csv_native
from datafusion_tpu_torch.columnar.csv import count_csv_rows, read_csv
from datafusion_tpu_torch.io.native import count_csv_rows_native, get_lib, library_path, parse_csv_native

D = port.DataType
F = port.Field


@pytest.fixture(autouse=True)
def native_lib():
    """Skips where the library cannot be built (no g++)."""
    lib = get_lib()
    if lib is None:
        pytest.skip("no C++ toolchain: the native CSV loader cannot be built")
    return lib


def _ref_schema(schema):
    import datafusion_tpu as ref

    return ref.Schema([ref.Field(f.name, ref.DataType[f.dtype.name], f.nullable) for f in schema.fields])


def _same_as_python_and_jax(path, schema, header):
    native = read_csv(path, schema, has_header=header, device="cpu")
    python = read_csv(path, schema, has_header=header, device="cpu", native=False)
    assert native.num_rows == python.num_rows == count_csv_rows(path, header)
    n = native.num_rows
    for j in range(len(schema)):
        np.testing.assert_array_equal(native.columns[j].to_numpy(n), python.columns[j].to_numpy(n))
    arrays, validity = parse_csv_native(path, schema, header)
    ref_arrays, ref_validity = ref_parse_csv_native(path, _ref_schema(schema), header)
    assert (validity is None) == (ref_validity is None)
    for j, (a, b) in enumerate(zip(arrays, ref_arrays)):
        if isinstance(a, tuple):  # Utf8: (codes, vocabulary)
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if validity is not None:
            np.testing.assert_array_equal(
                np.ones(n, bool) if validity[j] is None else validity[j],
                np.ones(n, bool) if ref_validity[j] is None else ref_validity[j],
            )
    return native


CASES = [
    ("uk_cities.csv", port.Schema([F("city", D.Utf8, False), F("lat", D.Float64, False), F("lng", D.Float64, False)]),
     False),
    ("aggregate_test_1.csv", port.Schema([F("a", D.Int32, False), F("b", D.Float64, False)]), True),
    ("null_test.csv", port.Schema([F("c_int", D.Int32, True), F("c_float", D.Float64, True),
                                   F("c_string", D.Utf8, True), F("c_bool", D.Boolean, True)]), True),
]


@pytest.mark.parametrize("fname,schema,header", CASES, ids=[c[0] for c in CASES])
def test_native_matches_python_and_jax(data_dir, fname, schema, header):
    _same_as_python_and_jax(str(data_dir / fname), schema, header)


def test_quoted_commas(data_dir):
    t = read_csv(str(data_dir / "uk_cities.csv"), CASES[0][1], has_header=False, device="cpu")
    assert "Elgin, Scotland, the UK" in set(t.columns[0].to_numpy(t.num_rows))


def test_column_subset_skips_the_rest(data_dir):
    arrays, _ = parse_csv_native(str(data_dir / "uk_cities.csv"), CASES[0][1], False, columns=[2])
    assert arrays[0] is None and arrays[1] is None and arrays[2].dtype == np.float64


def test_multichunk_quoted_newlines(tmp_path):
    """The parallel row index splits the buffer at arbitrary byte offsets
    and rebuilds the quote state by prefix parity: a multi-MB file of
    quoted fields with embedded newlines, commas and escaped quotes must
    parse exactly as the Python parser reads it."""
    rng = np.random.default_rng(3)
    n = 60_000
    rows = []
    for i in range(n):
        r = int(rng.integers(0, 5))
        if r == 0:
            s = f'"line1-{i}\nline2,with comma\nline3"'
        elif r == 1:
            s = f'"quote "" inside {i}"'
        elif r == 2:
            s = f'"{i:06d}-' + "x" * int(rng.integers(0, 60)) + '"'
        else:
            s = f"plain{i}"
        rows.append(f"{i},{s},{float(i) / 7!r}")
    p = tmp_path / "chunky.csv"
    p.write_text("id,s,v\n" + "\n".join(rows) + "\n")
    assert p.stat().st_size > 2 << 20  # several 1 MiB index chunks
    schema = port.Schema([F("id", D.Int64, False), F("s", D.Utf8, False), F("v", D.Float64, False)])
    t = _same_as_python_and_jax(str(p), schema, True)
    assert t.num_rows == n


def test_large_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    n = 50_000
    a = rng.integers(-1000, 1000, n)
    b = rng.random(n)
    p = tmp_path / "big.csv"
    p.write_text("\n".join(["a,b"] + [f"{int(a[i])},{float(b[i])!r}" for i in range(n)]) + "\n")
    schema = port.Schema([F("a", D.Int64, False), F("b", D.Float64, False)])
    t = _same_as_python_and_jax(str(p), schema, True)
    assert t.num_rows == n == count_csv_rows_native(str(p), True)
    np.testing.assert_array_equal(t.columns[0].to_numpy(n).astype(np.int64), a)
    np.testing.assert_array_equal(t.columns[1].to_numpy(n), b)


def test_dates_and_timestamps(tmp_path):
    p = tmp_path / "dates.csv"
    p.write_text("d,ts\n2021-01-31,2021-03-15 08:30:05\n1920-02-29,\n,1969-12-31T23:59:59\n")
    schema = port.Schema([F("d", D.Date32, True), F("ts", D.Timestamp, True)])
    t = _same_as_python_and_jax(str(p), schema, True)
    assert t.columns[0].to_numpy(3)[2] is None and t.columns[1].to_numpy(3)[1] is None


def test_library_is_keyed_by_the_source(native_lib):
    """The build lands under a name keyed by the source's hash, and the
    loaded library is that file."""
    assert library_path().exists() and library_path().name.startswith("libdftorch_csv_")
    assert native_lib._name == str(library_path())


def test_concurrent_builds_load_one_library(tmp_path):
    """Processes that build at once (pytest-xdist's workers) each compile
    to a temporary name and rename it into place: every one loads a whole
    library and no temporary file is left."""
    import subprocess
    import sys

    code = ("import sys, pathlib; import datafusion_tpu_torch.io.native as n; "
            "n.BUILD_DIR = pathlib.Path(sys.argv[1]); "
            "n.library_path = lambda: n.BUILD_DIR / 'libdftorch_csv_test.so'; "
            "lib = n.get_lib(); print(lib is not None and lib.dftpu_csv_index_free is not None)")
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], stdout=subprocess.PIPE, text=True,
                              cwd=root) for _ in range(4)]
    outs = [p.communicate(timeout=240)[0].strip() for p in procs]
    assert outs == ["True"] * 4 and all(p.returncode == 0 for p in procs)
    assert sorted(f.name for f in tmp_path.iterdir()) == ["libdftorch_csv_test.so"]
