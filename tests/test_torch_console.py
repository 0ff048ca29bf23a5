"""The torch port's SQL console against the JAX package's.

The scripts of tests/test_console.py and the reference smoketest golden
(test_geospatial.py's test_smoketest_golden) run through both packages'
`Console` on the CPU, on one device and on a mesh of 8 shards: the output
must be equal, apart from each query's wall time, and the smoketest's
`ref_output` rendering must equal tests/data/smoketest-expected.txt byte
for byte (on a mesh too, where the JAX package refuses its host function). One run goes through `python -m datafusion_tpu_torch.console
--device cpu` in a subprocess.
"""

import io
import re
import subprocess
import sys
from pathlib import Path

import pytest

import datafusion_tpu as ref
import datafusion_tpu_torch as port
from datafusion_tpu.console.main import Console as RefConsole
from datafusion_tpu.parallel.mesh import make_mesh as ref_make_mesh
from datafusion_tpu_torch.console.main import Console, main

ROOT = Path(__file__).resolve().parents[1]
TIMING = re.compile(r"^-- (\d+) row\(s\) in [0-9.]+ ms$", re.M)


def _port_ctx(mesh):
    return port.ExecutionContext(mesh=port.make_mesh(8, device="cpu")) if mesh else port.ExecutionContext(device="cpu")


def _ref_ctx(mesh):
    return ref.ExecutionContext(mesh=ref_make_mesh()) if mesh else ref.ExecutionContext()


def _run_both(script, mesh, ref_output=False):
    outs = []
    for cls, ctx in ((RefConsole, _ref_ctx(mesh)), (Console, _port_ctx(mesh))):
        out = io.StringIO()
        cls(ctx, out=out, ref_output=ref_output).run_script(str(script))
        outs.append(TIMING.sub(r"-- \1 row(s)", out.getvalue()))
    return outs


@pytest.fixture()
def script(tmp_path, data_dir):
    path = tmp_path / "q.sql"
    path.write_text(
        "CREATE EXTERNAL TABLE t1 (a INT NOT NULL, b DOUBLE NOT NULL) "
        f"STORED AS CSV WITH HEADER ROW LOCATION '{data_dir}/aggregate_test_1.csv';\n"
        "SELECT a, MIN(b), MAX(b) FROM t1 GROUP BY a ORDER BY a;\n"
        "SELECT nope FROM missing;\n"
        "SELECT COUNT(*) FROM t1 WHERE b > 2;\n"
    )
    return path


@pytest.mark.parametrize("mesh", [False, True], ids=["card", "mesh"])
def test_script_mode(script, mesh):
    want, got = _run_both(script, mesh)
    assert got == want
    assert "1\t1.1\t2.2" in got and "2\t3.3\t5.5" in got and "3\t1.0\t2.0" in got
    assert "-- 3 row(s)" in got and got.count("Error:") == 1


def test_error_reporting():
    out = io.StringIO()
    Console(port.ExecutionContext(device="cpu"), out=out).execute("SELECT nope FROM missing")
    assert out.getvalue().startswith("Error:")


@pytest.mark.parametrize("mesh", [False, True], ids=["card", "mesh"])
def test_smoketest_golden(data_dir, tmp_path, mesh):
    """The reference's dockerized smoketest: script mode in ref-output
    format, equal to its expected file (the LOCATION rewritten to this
    checkout's copy of the fixture)."""
    sql = (data_dir / "smoketest.sql").read_text().replace("/test/data/uk_cities.csv", str(data_dir / "uk_cities.csv"))
    path = tmp_path / "smoketest.sql"
    path.write_text(sql)
    want, got = _run_both(path, mesh, ref_output=True)
    assert "DataFusion Console\n" + got == (data_dir / "smoketest-expected.txt").read_text()
    if mesh:
        # the JAX mesh refuses a host function (ST_AsText) over its shards;
        # the port's mesh runs it on the host at result time, as one card does
        assert "Error: host function 'ST_AsText'" in want
    else:
        assert got == want


def test_main_in_process(data_dir, tmp_path, capsys):
    sql = (data_dir / "smoketest.sql").read_text().replace("/test/data/uk_cities.csv", str(data_dir / "uk_cities.csv"))
    path = tmp_path / "smoketest.sql"
    path.write_text(sql)
    assert main(["--device", "cpu", "--mesh", "4", "--script", str(path), "--ref-output"]) == 0
    assert capsys.readouterr().out == (data_dir / "smoketest-expected.txt").read_text()


def test_cli_subprocess(tmp_path, data_dir):
    path = tmp_path / "q.sql"
    path.write_text(
        "CREATE EXTERNAL TABLE c (city VARCHAR(100) NOT NULL, lat DOUBLE NOT NULL, "
        f"lng DOUBLE NOT NULL) STORED AS CSV WITHOUT HEADER ROW LOCATION '{data_dir}/uk_cities.csv';\n"
        "SELECT city, lat FROM c WHERE lat > 57;\n"
    )
    proc = subprocess.run(
        [sys.executable, "-m", "datafusion_tpu_torch.console", "--device", "cpu", "--script", str(path),
         "--profile", str(tmp_path / "trace")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    assert '"Elgin, Scotland, the UK"\t57.653484' in proc.stdout
    assert TIMING.search(proc.stdout)
    assert (tmp_path / "trace" / "console_trace.json").stat().st_size > 0
