"""The port's program spans: `record_function` events in the profiler's
own trace, named `dft.<layer>.<what>` (the front end's `dft.sql`, each
plan node's `dft.node.<Kind>[.<route>]`, each kernel wrapper's
`dft.kernel.K<n>`, `dft.to_host`, the mesh's `dft.merge` and
`dft.collective.<op>`, ...), one per layer boundary crossed: never one
per shard, launch, chunk or row.

A span records only while a torch profiler records
(`torch.profiler.profile`, the console's `--profile`); otherwise `span`
returns one shared null context and costs one check of the profiler's
state. There is no setting: the profiler is the switch. While it
records, the garbage collector's pauses show as `dft.gc`."""

from __future__ import annotations

import contextlib
import functools
import gc

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager over `name`'s span: a `record_function` while a
    profiler records, else the shared null context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorate a function so that each call runs inside `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return run

    return wrap


_gc_open: list = []


def _gc_span(phase: str, info: dict) -> None:
    if phase == "start" and _recording():
        _gc_open.append(torch.profiler.record_function("dft.gc").__enter__())
    elif phase == "stop" and _gc_open:
        _gc_open.pop().__exit__(None, None, None)


if _gc_span not in gc.callbacks:
    gc.callbacks.append(_gc_span)
