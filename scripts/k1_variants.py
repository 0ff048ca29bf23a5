"""Three designs of K1 (the fused stage) timed on the card in one process.

    python3 scripts/k1_variants.py --parent DIR [--reps 5]

DIR is a checkout of a commit whose `datafusion_tpu_torch/csrc/fused_stage.cu`
holds the row-per-thread kernel (one row a thread through the whole
program, the register file indexed at run time) with the C entry
`dft_fused_stage(const Program*, long long n, void* stream)` and this
checkout's `Program` layout. That source is built here with nvcc
(`-Xptxas -v`, printed) and loaded beside this checkout's library. On
q1's program (chip_smoke.py's table, 2^25 rows) and on m1's program at
one shard's rows (2^22), the script runs:

  (a) the row-per-thread kernel on the builder's program (one register
      per instruction, constants in registers: `build_program`)
  (b) the row-per-thread kernel on the same program with its registers
      allocated (`allocate_registers`; no immediates, which that kernel
      does not read), so its local frame is smaller
  (c) this checkout's tile interpreter on the program the compiler
      builds (`compile_program`: immediates, allocated registers)

Each is held to the plain version bit for bit, then timed: the CUDA-event
time of one call (median), the kernel alone (torch.profiler) and the
host time of one call. Prints one JSON line with the card's name and power
limit. Exits non-zero without a card.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="checkout holding the row-per-thread fused_stage.cu")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("k1_variants: no CUDA device; the variants are timed on the card only")
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.ops.pallas import cuda_lib
    from datafusion_tpu_torch.ops.pallas import fused_stage as fs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    src = os.path.join(os.path.abspath(args.parent), "datafusion_tpu_torch", "csrc", "fused_stage.cu")
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=cuda_lib.BUILD_DIR)
    so = os.path.join(tmp, "librow_per_thread.so")
    build = subprocess.run([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", src, "-o", so],
                           capture_output=True, text=True, timeout=600)
    if build.returncode != 0:
        sys.exit(f"k1_variants: nvcc failed for {src}:\n{build.stdout}{build.stderr}")
    ptxas_parent = smoke.ptxas_reports(build.stdout + build.stderr, ("fused_stage_kernel",))
    old = ctypes.CDLL(so)
    old.dft_fused_stage.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    old.dft_fused_stage.restype = ctypes.c_int
    if old.dft_fused_stage_program_size() != ctypes.sizeof(fs._CProgram):
        sys.exit("k1_variants: the parent's Program layout differs from this checkout's")
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run_old(prog, in_data, in_valid, n, device):
        """The wrapper's work around the row-per-thread kernel."""
        outs = [(torch.empty(n, dtype=fs._storage(t), device=device),
                 torch.empty(n, dtype=torch.bool, device=device) if nl else None) for _, t, nl in prog.outputs]
        sel = torch.empty(n, dtype=torch.bool, device=device) if prog.sel_reg >= 0 else None
        cp = fs.c_program(prog)
        fs.bind_program(cp, in_data, in_valid, outs, sel)
        if old.dft_fused_stage(ctypes.byref(cp), n, stream) != 0:
            raise RuntimeError("the row-per-thread kernel failed to launch")
        return sel, outs

    arrays = smoke.main_arrays()
    ctx = port.ExecutionContext(device=dev)
    ctx.register_table("big", smoke.main_table(port, arrays))
    out = {"card": card, "reps": args.reps, "ptxas_parent": ptxas_parent}
    shapes = (("q1", smoke.MAIN_QUERIES[0][1], smoke.N), ("m1 shard", smoke.MESH_QUERIES[0][1], 1 << 22))
    for label, sql, rows in shapes:
        logical, ins = smoke.fused_program(ctx, "big", sql, build=fs.build_program)
        ins = ([d[:rows] for d in ins[0]], [None if v is None else v[:rows] for v in ins[1]])
        variants = {"a": (logical, run_old), "b": (fs.allocate_registers(logical), run_old),
                    "c": (fs.allocate_registers(fs.fold_immediates(logical)), fs.run_fused)}
        res = {}
        for name, (prog, run) in variants.items():
            smoke.compare_k1(prog, ins, rows, dev, run=run)

            def call(prog=prog, run=run):
                return run(prog, *ins, rows, dev)

            res[name] = {"instructions": len(prog.code), "registers": prog.n_regs,
                         "event_ms": smoke.time_ms(call, reps=args.reps),
                         "kernel_ms": smoke.kernel_only_ms(call, "fused_stage_kernel", reps=args.reps),
                         "host_ms": smoke.host_only_ms(call)}
        res["bound_ms"] = smoke.program_bytes(variants["c"][0], ins, rows) / smoke.HBM_BYTES_PER_S * 1e3
        out[label] = {"rows": rows, **res}
        print(f"{label}: " + json.dumps(res), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
