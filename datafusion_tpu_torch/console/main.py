"""Interactive SQL console over the torch port.

Port of datafusion_tpu/console/main.py, which mirrors the reference's
console binary (reference: src/bin/console/main.rs + linereader.rs): an
interactive REPL reading semicolon-terminated, possibly multi-line
statements (the prompt switches while a statement is open), `quit` /
`exit`, and a `--script file.sql` batch mode. Each query's wall time is
printed (the reference computed it and dropped it, main.rs:133-148).

Run: python -m datafusion_tpu_torch.console [--script FILE] [--mesh N]
[--device DEV] [--profile DIR] [--ref-output]. It runs on the card
unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from datafusion_tpu_torch.errors import ExecutionError
from datafusion_tpu_torch.exec.context import ExecutionContext
from datafusion_tpu_torch.ops.functions import register_geospatial


class Console:
    def __init__(self, ctx: ExecutionContext | None = None, out=None, ref_output: bool = False):
        """`ctx`: the session (default: a context on the card). `out`: where
        results go (default: `sys.stdout` when the console is made).
        `ref_output`: the reference POC console's exact format — 'Executing
        query ...' per statement, Display-rendered rows (strings unquoted),
        no timing line — so scripts diff cleanly against the reference's
        goldens (reference: test/data/smoketest-expected.txt,
        scripts/smoketest.sh:76-96)."""
        self.ctx = ctx if ctx is not None else ExecutionContext()
        self.out = out if out is not None else sys.stdout
        self.ref_output = ref_output
        # the geospatial UDFs the reference console meant to register
        # (reference: main.rs:123-125, commented out)
        register_geospatial(self.ctx)

    def execute(self, sql: str) -> None:
        """Execute one statement, print its rows and its wall time
        (reference: Console::execute, main.rs:130-154)."""
        sql = sql.strip()
        if not sql:
            return
        if self.ref_output:
            print("Executing query ...", file=self.out)
        t0 = time.perf_counter()
        try:
            result = self.ctx.sql(sql)
        except ExecutionError as e:
            print(f"Error: {e}", file=self.out)
            return
        elapsed = time.perf_counter() - t0
        text = result.display_str() if self.ref_output else result.result_str()
        if text:
            self.out.write(text)
        if not self.ref_output:
            print(f"-- {result.num_rows} row(s) in {elapsed * 1e3:.1f} ms", file=self.out)

    def run_script(self, path: str) -> None:
        """Batch mode: split the file on ';' (reference: main.rs:41-63)."""
        with open(path) as f:
            source = f.read()
        for stmt in source.split(";"):
            if stmt.strip():
                self.execute(stmt)

    def repl(self) -> None:
        """Multi-line reader: statements end with ';'; `quit` / `exit`
        leave (reference: linereader.rs:53-103)."""
        try:
            import readline  # noqa: F401  (history and line editing)
        except ImportError:
            pass
        buf: list[str] = []
        while True:
            prompt = "datafusion-tpu> " if not buf else "             -> "
            try:
                line = input(prompt)
            except (EOFError, KeyboardInterrupt):
                print(file=self.out)
                return
            if not buf and line.strip().lower() in ("quit", "exit"):
                return
            buf.append(line)
            joined = "\n".join(buf)
            while ";" in joined:
                stmt, _, joined = joined.partition(";")
                self.execute(stmt)
            buf = [joined] if joined.strip() else []


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="datafusion-tpu-torch console",
                                     description="SQL engine console on PyTorch / CUDA")
    parser.add_argument("--script", help="execute a .sql script and exit")
    parser.add_argument("--mesh", type=int, default=0,
                        help="run distributed over N logical shards (0 = one device)")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the card, 'cuda'; 'cpu' for the CPU)")
    parser.add_argument("--profile", metavar="DIR",
                        help="write a torch.profiler Chrome trace of the session into DIR")
    parser.add_argument("--ref-output", action="store_true",
                        help="reference-console output format (banner, 'Executing query ...' lines, "
                             "Display-rendered rows, no timing) for golden diffs")
    args = parser.parse_args(argv)

    if args.ref_output:
        print("DataFusion Console")  # reference: main.rs:86
    if args.mesh:
        from datafusion_tpu_torch.parallel.mesh import make_mesh

        ctx = ExecutionContext(mesh=make_mesh(args.mesh, device=args.device))
    else:
        ctx = ExecutionContext(device=args.device)
    console = Console(ctx, ref_output=args.ref_output)
    run = (lambda: console.run_script(args.script)) if args.script else console.repl
    if not args.profile:
        run()
        return 0
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.device.type == "cuda" else [])
    os.makedirs(args.profile, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            run()
        finally:
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
    prof.export_chrome_trace(os.path.join(args.profile, "console_trace.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
