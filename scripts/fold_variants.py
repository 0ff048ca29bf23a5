"""The fold tile's kernels (K2 dense, K3 + K4, K6) of two checkouts, and
this checkout's ablations, timed on the card in one process.

    python3 scripts/fold_variants.py --parent DIR [--reps 5] [--variant NAME=-DMACRO=VALUE,...]

DIR is a checkout of the parent commit. Its `segreduce.cu` and
`partition.cu` (with its own headers) are built here with nvcc into one
library, beside this checkout's library and two ablation builds of it
(`DFT_ABLATE` in csrc/reduce_common.cuh: 1 computes every float SUM's
digits but adds none, 2 skips the flush of the shared tables); all the
nvcc processes start together. The shapes are the main path's: the
arguments that q3 gives K2 dense and that q4 and q5 give `slab_reduce`
(K3 + K4) on chip_smoke.py's seeded table (2^25 rows), captured from the
queries themselves, and the arguments m3 gives K6 on 8 shards of the
card (the parent's whole library, built by its own cuda_lib.py, runs
under this checkout's K6 wrapper: K6's C entry and packing did not
change). At each shape, in turns, `--reps` times each:

  parent     the parent's kernels, called as the parent's wrappers call them
  new        this checkout's wrappers
  sink       the same, DFT_ABLATE=1: the float SUMs' digits into a register sink
  no_flush   the same, DFT_ABLATE=2: no flush to the device tables
  int_ops    this checkout's wrappers on the shape's ops that are not float SUMs
  NAME       each `--variant`: this checkout built with its macros (comma-separated
             -D flags; e.g. check4k=-DDFT_FIX_CHECK_ROWS=4096)

Each is the CUDA-event time of one call (median) and its kernels'
device times by name (torch.profiler, mean per call): the first pass
(`fold_scale_kernel`), the fold, and K3 where the shape has it, so the
work moved between K3 and K4 shows, with K3 + K4 together. The parent's
and this checkout's outputs are held to each other bit for bit, and the
float SUMs to `segreduce.fixed_sum_plain`. Prints one JSON line with the
card's name and power limit. Exits non-zero without a card.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

ABLATIONS = {"sink": ("-DDFT_ABLATE=1",), "no_flush": ("-DDFT_ABLATE=2",)}
SHAPES = ("q3", "q4", "q5", "m3")
K6_ENTRIES = ("dft_ragged_exchange_fold", "dft_enable_peer_access")


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_parent(parent, cuda_lib):
    """The parent's segreduce.cu and partition.cu as one library (started,
    not waited for): (Popen, library path)."""
    src = os.path.join(parent, "datafusion_tpu_torch", "csrc")
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    so = os.path.join(tempfile.mkdtemp(dir=cuda_lib.BUILD_DIR), "libparent_fold.so")
    cmd = [cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-I", src,
           os.path.join(src, "segreduce.cu"), os.path.join(src, "partition.cu"), "-o", so]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def bind_parent(so):
    lib = ctypes.CDLL(so)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dft_segreduce_dense.argtypes = [vp, i64, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp]
    lib.dft_slab_partition.argtypes = [vp, vp, i64, i32, i32, i32, i32, i32, vp, vp, vp, vp]
    lib.dft_windowed_reduce.argtypes = [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp, vp]
    for f in (lib.dft_segreduce_dense, lib.dft_slab_partition, lib.dft_windowed_reduce):
        f.restype = i32
    return lib


class Parent:
    """The parent's wrappers around its library: its segreduce.py (loaded
    by path; it imports only torch) packs the launches, and K3 + K4 follow
    the parent's `slab_reduce` (ops/aggregate.py)."""

    PBLOCK, SLAB_CHUNK, ALIGN, SENTINEL, WINDOW = 8192, 256, 1024, 1 << 23, 2048

    def __init__(self, parent, lib, torch):
        self.sr = load_module("parent_segreduce",
                              os.path.join(parent, "datafusion_tpu_torch", "ops", "pallas", "segreduce.py"))
        self.lib, self.torch = lib, torch

    def _stream(self, dev):
        return self.torch.cuda.current_stream(dev).cuda_stream

    def _fold(self, entry, gid, n, vals, masks, ops, g, window):
        sr = self.sr
        launches = sr.fold_launches(sr.fold_widths(ops, vals), window or g)
        ft = sr.fold_tables(ops, vals, g, gid.device, counters=len(launches), fixed=True)
        for (lo, hi, reps), done in zip(launches, ft.counters):
            kinds, outs, aux = sr.c_entries(ops, vals, ft, lo, hi, fixed=True)
            arrays = (kinds, *sr.c_streams(vals, masks, lo, hi), outs, aux, done, self._stream(gid.device))
            if window:
                rc = entry(gid.data_ptr(), n, g, hi - lo, *arrays)
            else:
                rc = entry(gid.data_ptr(), n, g, reps, hi - lo, *arrays)
            if rc:
                raise RuntimeError(f"parent kernel: CUDA error {rc}")
        return tuple(ft.tables)

    def dense(self, gid, vals, masks, ops, num_groups):
        return self._fold(self.lib.dft_segreduce_dense, gid, gid.numel(), vals, masks, ops, num_groups, 0)

    def slab_reduce(self, gid, vals, masks, ops, num_groups):
        torch = self.torch
        id_mod = 1 << num_groups.bit_length()
        packed, bits = gid, {}
        for m in masks:
            if m is not None and id(m) not in bits:
                bits[id(m)] = num_groups.bit_length() + len(bits)
                packed = packed | (m.to(torch.int32) << bits[id(m)])
        packed = packed.contiguous()
        payloads = list({id(v): v for v in vals if v is not None}.values())
        nb = -(-(num_groups + 1) // self.WINDOW)
        scap = -(-(self.PBLOCK + nb * self.SLAB_CHUNK) // self.ALIGN) * self.ALIGN
        n = gid.numel()
        size = -(-n // self.PBLOCK) * scap
        out_gid = torch.empty(size, dtype=torch.int32, device=gid.device)
        outs = [torch.empty(size, dtype=c.dtype, device=gid.device) for c in payloads]
        k = len(payloads)
        rc = self.lib.dft_slab_partition(packed.data_ptr(), out_gid.data_ptr(), n, id_mod, nb, self.PBLOCK, scap, k,
                                         (ctypes.c_int * k)(*[c.element_size() for c in payloads]),
                                         (ctypes.c_void_p * k)(*[c.data_ptr() for c in payloads]),
                                         (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]),
                                         self._stream(gid.device))
        if rc:
            raise RuntimeError(f"parent K3: CUDA error {rc}")
        moved = {id(v): s for v, s in zip(payloads, outs)}
        gid_k = torch.where(out_gid >= self.SENTINEL, out_gid, out_gid & (id_mod - 1))
        vk = [None if v is None else moved[id(v)] for v in vals]
        mk = [None if m is None else ((out_gid >> bits[id(m)]) & 1).bool() for m in masks]
        return self._fold(self.lib.dft_windowed_reduce, gid_k, size, vk, mk, ops, num_groups, self.WINDOW)


def device_ms_by_kernel(fn, torch, reps):
    """Each CUDA kernel's device time per call of `fn`, by name (the
    template arguments cut off): torch.profiler over `reps` calls after a
    warm-up, the mean per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                and not e.key.startswith("dft.")):  # the port's spans' device-side copies are not kernels
            name = e.key.split("<")[0].split("(")[0].replace("void ", "")
            if "kernel" in name:
                out[name] = out.get(name, 0.0) + e.self_device_time_total / reps / 1e3
    return out


def k6_shape(call, parent_whole, libs, with_lib, smoke, rs, sr, torch, reps):
    """K6 at m3's shape: the parent's library and this checkout's under
    this checkout's wrapper, in turns; outputs bit-equal and the float
    SUMs equal to the plain fixed-point function."""
    (gids, vals, masks, sizes), kw = call

    def run(lib):
        return with_lib(lib, lambda: rs.ragged_exchange_fold(gids, vals, masks, sizes, **kw))

    got, want = run(libs["new"]), run(parent_whole)  # per receiver, one table per op
    torch.cuda.synchronize()
    for i, (xs, ys) in enumerate(zip(got, want)):
        for a, (x, y) in enumerate(zip(xs, ys)):
            bits = torch.int64 if x.element_size() == 8 else torch.int32
            if not torch.equal(x.view(bits), y.view(bits)):
                sys.exit(f"fold_variants: m3's K6 receiver {i} op {a} differs between the parent and this checkout")
    kw_plain = {k: v for k, v in kw.items() if k not in ("cards", "agree")}
    for a, w in smoke.k6_fixed_sums((gids, vals, masks, sizes), kw_plain).items():
        if not torch.equal(torch.stack([xs[a] for xs in got]).view(torch.int64), w.view(torch.int64)):
            sys.exit(f"fold_variants: m3's K6 op {a} differs from fixed_sum_plain")
    variants = {"parent": lambda: run(parent_whole)}
    variants.update({name: lambda lib=lib: run(lib) for name, lib in libs.items()})
    res = {name: {"event_ms": []} for name in variants}
    for _ in range(reps):
        for name, fn in variants.items():
            res[name]["event_ms"].append(smoke.time_ms(fn, reps=1))
    for name, fn in variants.items():
        res[name]["event_ms"] = statistics.median(res[name]["event_ms"])
        res[name]["kernels_ms"] = device_ms_by_kernel(fn, torch, reps)
    return {"ops": tuple(kw["ops"]), "num_groups": kw["num_groups"], "routed_rows": int(sizes.sum()), **res}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="checkout of the parent commit")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variant", action="append", default=[], help="NAME=-DMACRO=VALUE[,...]: one more build")
    args = ap.parse_args()
    builds = dict(ABLATIONS)
    for v in args.variant:
        name, flags = v.split("=", 1)
        builds[name] = tuple(flags.split(","))
    import torch

    if not torch.cuda.is_available():
        sys.exit("fold_variants: no CUDA device; the variants are timed on the card only")
    smoke = load_module("smoke", os.path.join(HERE, "chip_smoke.py"))
    import datafusion_tpu_torch as port
    from datafusion_tpu_torch.ops import aggregate as agg
    from datafusion_tpu_torch.ops.pallas import cuda_lib
    from datafusion_tpu_torch.ops.pallas import segreduce as sr

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    # every library at once: the parent's, then this checkout's and its ablations (cuda_lib builds
    # each one's sources in parallel; the builds themselves run in threads)
    import concurrent.futures as cf

    parent_root = os.path.abspath(args.parent)
    parent_cuda_lib = load_module("parent_cuda_lib", os.path.join(parent_root, "datafusion_tpu_torch", "ops", "pallas",
                                                                  "cuda_lib.py"))
    proc, parent_so = build_parent(parent_root, cuda_lib)
    with cf.ThreadPoolExecutor(len(builds) + 2) as pool:
        futs = {name: pool.submit(cuda_lib.build_library, False, d) for name, d in (("new", ()), *builds.items())}
        whole = pool.submit(parent_cuda_lib.build_library)
        built = {name: f.result()[0] for name, f in futs.items()}
        parent_whole = ctypes.CDLL(str(whole.result()[0]))
    out_log, _ = proc.communicate()
    if proc.returncode != 0:
        sys.exit(f"fold_variants: nvcc failed for the parent:\n{out_log}")
    libs = {name: cuda_lib.bind(ctypes.CDLL(str(p))) for name, p in built.items()}
    for name in K6_ENTRIES:  # the parent's K6 under this checkout's wrapper
        getattr(parent_whole, name).argtypes = getattr(libs["new"], name).argtypes
        getattr(parent_whole, name).restype = getattr(libs["new"], name).restype
    parent = Parent(parent_root, bind_parent(parent_so), torch)

    dev = torch.device("cuda", torch.cuda.current_device())
    arrays = smoke.main_arrays()
    ctx = port.ExecutionContext(device=dev, bigdense=True)
    ctx.register_table("big", smoke.main_table(port, arrays))
    queries = {n: q for n, q, _ in smoke.MAIN_QUERIES}
    calls = {"q3": next(c for c in smoke.capture(agg, "segmented_reduce", lambda: ctx.sql(queries["q3"]))
                        if c[1].get("dense"))}
    for name in ("q4", "q5"):
        calls[name] = smoke.capture(agg, "slab_reduce", lambda name=name: ctx.sql(queries[name]))[0]
    from datafusion_tpu_torch.ops.pallas import ragged_shuffle as rs
    from datafusion_tpu_torch.parallel import shuffle as sh

    mesh = port.ExecutionContext(mesh=port.make_mesh(8, device=dev))
    mesh.register_table("big", smoke.mesh_table(port, ctx.table("big"), arrays[5]))
    m3 = next(q for n, q, _ in smoke.MESH_QUERIES if n == "m3")
    calls["m3"] = smoke.capture(sh, "ragged_exchange_fold", lambda: mesh.sql(m3))[-1]
    torch.cuda.synchronize()

    def with_lib(lib, fn):
        real = cuda_lib.load_library
        cuda_lib.load_library = lambda: lib
        try:
            return fn()
        finally:
            cuda_lib.load_library = real

    out = {"card": card, "reps": args.reps, "rows": smoke.N, "shapes": {}}
    for shape in SHAPES:
        if shape == "m3":
            out["shapes"][shape] = k6_shape(calls[shape], parent_whole, libs, with_lib, smoke, rs, sr, torch,
                                            args.reps)
            print(f"{shape}: " + json.dumps(out["shapes"][shape]), flush=True)
            continue
        (gid, vals, masks), kw = calls[shape]
        ops, g = tuple(kw["ops"]), kw["num_groups"]
        if shape == "q3":
            def new_call(ops=ops, vals=vals, masks=masks):
                return sr.segmented_reduce(gid, vals, masks, ops=ops, num_groups=g, dense=True)

            def parent_call():
                return parent.dense(gid, vals, masks, ops, g)
        else:
            def new_call(ops=ops, vals=vals, masks=masks):
                return agg.slab_reduce(gid, vals, masks, ops=ops, num_groups=g)

            def parent_call():
                return parent.slab_reduce(gid, vals, masks, ops, g)
        # the same bits: parent and this checkout, and the float SUMs against the plain fixed-point function
        got_new, got_parent = with_lib(libs["new"], new_call), parent_call()
        torch.cuda.synchronize()
        for a, (x, y) in enumerate(zip(got_new, got_parent)):
            bits = torch.int64 if x.element_size() == 8 else torch.int32
            if not torch.equal(x.view(bits), y.view(bits)):
                sys.exit(f"fold_variants: {shape} op {a} ({ops[a]}) differs between the parent and this checkout")
        for a, (op, v, m) in enumerate(zip(ops, vals, masks)):
            if sr.float_sum(op, v):
                want = sr.fixed_sum_plain(gid, v, m, g)
                if not torch.equal(got_new[a].view(torch.int64), want.view(torch.int64)):
                    sys.exit(f"fold_variants: {shape} op {a} differs from fixed_sum_plain")
        del got_new, got_parent
        ints = [a for a, (op, v) in enumerate(zip(ops, vals)) if not sr.float_sum(op, v)]
        variants = {"parent": parent_call, "new": lambda: with_lib(libs["new"], new_call)}
        has_fix = len(ints) < len(ops)
        for name in builds:
            if has_fix or name not in ABLATIONS:
                variants[name] = lambda name=name: with_lib(libs[name], new_call)
        if has_fix and ints:
            variants["int_ops"] = lambda: with_lib(libs["new"], lambda: new_call(
                tuple(ops[a] for a in ints), [vals[a] for a in ints], [masks[a] for a in ints]))
        res = {name: {"event_ms": [], "kernels_ms": {}} for name in variants}
        for _ in range(args.reps):  # in turns
            for name, fn in variants.items():
                res[name]["event_ms"].append(smoke.time_ms(fn, reps=1))
        for name, fn in variants.items():
            res[name]["event_ms"] = statistics.median(res[name]["event_ms"])
            res[name]["kernels_ms"] = device_ms_by_kernel(fn, torch, args.reps)
            res[name]["kernels_total_ms"] = sum(res[name]["kernels_ms"].values())
        width = 4 + sum(v.element_size() for v in {id(v): v for v in vals if v is not None}.values())
        width += sum(1 for m in {id(m): m for m in masks if m is not None}.values())
        rows = gid.numel()
        # the bound of the kernels of the shape: K2 dense reads each stream once; K3 reads them and
        # writes the slab (1.25x), K4 reads the slab's ids and its live rows' payloads
        passes = 1 if shape == "q3" else 3.25
        out["shapes"][shape] = {
            "ops": ops, "num_groups": g, "rows": rows, "floats": len(ops) - len(ints),
            "bytes_bound_ms": rows * width * passes / smoke.hbm_bytes_per_s() * 1e3,
            **res,
        }
        print(f"{shape}: " + json.dumps(out["shapes"][shape]), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
