"""Package boundary of the torch port: it imports neither jax nor the JAX
package, runs on the card by default, and its kernel wrappers never fall
back to the plain version for a device that is not the CPU."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import datafusion_tpu_torch as port
from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.ops.pallas import cuda_lib
from datafusion_tpu_torch.exec.compiler import PlanCompiler, compile_plan
from datafusion_tpu_torch.ops.pallas import fused_stage as fs
from datafusion_tpu_torch.ops.pallas import partition as pt
from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
from datafusion_tpu_torch.ops.pallas import segreduce as sr

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "datafusion_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "datafusion_tpu", "triton")


def _imports(path: pathlib.Path, top_level_only=False):
    tree = ast.parse(path.read_text())
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _root(name: str) -> str:
    return name.split(".")[0]


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys, datafusion_tpu_torch, datafusion_tpu_torch.exec.compiler\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'datafusion_tpu', 'triton')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_forbidden_imports(path):
    bad = [m for m in _imports(path) if _root(m) in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_tests_import_no_cuda_code_at_module_scope():
    for path in sorted((ROOT / "tests").glob("test_torch_*.py")):
        mods = list(_imports(path, top_level_only=True))
        assert not any(m.endswith("cuda_lib") or _root(m) == "triton" for m in mods), path


def test_context_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ExecutionError, match="device='cpu'"):
        port.ExecutionContext()
    with pytest.raises(ExecutionError):
        port.ExecutionContext(device="cuda")
    with pytest.raises(ExecutionError):
        port.Table.from_pydict({"a": [1, 2]})
    assert port.ExecutionContext(device="cpu").device.type == "cpu"
    with pytest.raises(ExecutionError, match="device='cpu'"):
        PlanCompiler({})
    plan = port.ExecutionContext(device="cpu").plan("SELECT 1")
    with pytest.raises(ExecutionError, match="device='cpu'"):
        compile_plan(plan, {})
    assert PlanCompiler({}, device="cpu").device.type == "cpu"


def test_kernel_wrappers_never_fall_back(monkeypatch):
    """A CUDA request builds and launches the kernel or raises; a device
    that is neither CPU nor CUDA raises. Nothing takes the plain path."""
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: (_ for _ in ()).throw(ExecutionError("nvcc not found")))
    cuda_lib.load_library.cache_clear()
    if not cuda_lib.library_path().exists():
        with pytest.raises(ExecutionError):
            fs.run_fused(fs.Program(), [], [], 4, "cuda")
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sr.segmented_reduce(meta, [None], [None], ops=("count",), num_groups=2)
    with pytest.raises(ValueError, match="unsupported device"):
        fs.run_fused(fs.Program(), [], [], 4, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pt.slab_partition(meta, [meta], n_buckets=1, id_mod=2048)
    with pytest.raises(ValueError, match="unsupported device"):
        pt.windowed_reduce(meta, [None], [None], ops=("count",), num_groups=2)
    sizes = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    region = torch.zeros(256, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rs.ragged_exchange([[region], [region]], sizes, n_dev=2, split_cap=128, chunk=128)
    with pytest.raises(ValueError, match="unsupported device"):
        rs.ragged_exchange_fold([region, region], [[None], [None]], [[], []], sizes, ops=("count",), mask_map=(0,),
                                n_dev=2, split_cap=128, num_groups=2)
    cuda_lib.load_library.cache_clear()


def _enum(src: str, first: str) -> list[str]:
    body = re.search(r"enum\s*\{([^}]*\b" + first + r"\b[^}]*)\}", src).group(1)
    return [tok.split("=")[0].strip() for tok in body.replace("\n", " ").split(",") if tok.strip()]


def test_cuda_sources_match_the_python_tables():
    """The .cu sources are only read here: their opcode, type and op-kind
    enums must line up with the constants the wrappers send."""
    k1 = (PKG / "csrc" / "fused_stage.cu").read_text()
    for first in ("T_BOOL", "OP_LOAD"):
        for i, name in enumerate(_enum(k1, first)):
            assert getattr(fs, name) == i, name
    assert [n.lower()[2:] for n in _enum(k1, "F_SQRT")] == [
        k for k, _ in sorted(((k, v) for k, v in fs.MATH1.items() if k != "ln"), key=lambda kv: kv[1])
    ]
    for macro, value in (("MAX_INSTR", fs.MAX_INSTR), ("MAX_REGS", fs.MAX_REGS), ("MAX_IN", fs.MAX_IN),
                         ("MAX_OUT", fs.MAX_OUT), ("MAX_CONST", fs.MAX_CONST)):
        assert re.search(rf"#define DFT_{macro} {value}\b", k1), macro
    k2 = (PKG / "csrc" / "segreduce.cu").read_text()
    common = (PKG / "csrc" / "reduce_common.cuh").read_text()
    assert '#include "reduce_common.cuh"' in k2
    kinds = _enum(common, "K_SUM_F32")
    for (op, dt), code in sr._KIND.items():
        suffix = {None: "", torch.float32: "_F32", torch.float64: "_F64",
                  torch.int32: "_I32", torch.int64: "_I64"}[dt]
        assert kinds[code] == f"K_{op.upper()}{suffix}"
    for dt, code in sr._FIX.items():  # the fold tile's fixed-point float SUM
        assert kinds[code] == {torch.float32: "K_FIX_F32", torch.float64: "K_FIX_F64"}[dt]
    for macro, value in (("FIX_TABLES", sr.FIX_TABLES), ("FOLD_MAX_OPS", sr.FOLD_MAX_OPS)):
        assert re.search(rf"#define DFT_{macro} {value}\b", common), macro
    assert f"DENSE_MAX_SLOTS {sr.DENSE_MAX_SLOTS}" in k2
    k34 = (PKG / "csrc" / "partition.cu").read_text()
    assert '#include "reduce_common.cuh"' in k34
    for macro, value in (("SLAB_CHUNK", pt.SLAB_CHUNK), ("SENTINEL", f"(1 << {23})"),
                         ("MAX_BUCKETS", pt.MAX_BUCKETS), ("MAX_COLS", pt.MAX_COLS)):
        assert re.search(rf"#define DFT_{macro} {re.escape(str(value))}", k34), macro
    # the shared-memory windows of K4 and K6
    for macro, value in (("WINDOW", pt.WINDOW), ("MAX_OPS", pt.MAX_OPS)):
        assert re.search(rf"#define DFT_{macro} {value}\b", common), macro
    k56 = (PKG / "csrc" / "ragged_shuffle.cu").read_text()
    assert '#include "reduce_common.cuh"' in k56
    assert re.search(rf"#define DFT_MAX_DEV {rs.MAX_DEV}\b", k56)
    assert pt.SENTINEL == 1 << 23 and pt.MAX_OPS * pt.WINDOW * 8 <= pt.WINDOW_SMEM_BYTES
    assert set(cuda_lib.SOURCES) == {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert set(cuda_lib.HEADERS) == {p.name for p in (PKG / "csrc").glob("*.cuh")}
    for entry in ("dft_fused_stage(", "dft_fused_stage_program_size(", "dft_segreduce(", "dft_slab_partition(",
                  "dft_windowed_reduce(", "dft_ragged_exchange(", "dft_ragged_exchange_fold("):
        assert f'extern "C" int {entry}' in (k1 + k2 + k34 + k56)
