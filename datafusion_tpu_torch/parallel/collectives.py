"""Collectives over a mesh's logical shards.

The counterparts of the `lax` collectives the JAX package runs inside
`shard_map` (datafusion_tpu/parallel/dist.py). Each takes this process's
list of per-shard tensors, in local shard order, and returns the one
tensor every shard holds afterwards. On a mesh of one process that is a
function of the list, computed on the mesh's first card: on a mesh of
several cards each shard's tensor first comes there by one peer copy
(`to_card`, which counts the bytes it moves between cards in
`to_card.bytes`), and a reduction runs in shard order, so an f64 `psum`
over four cards equals one card's bit for bit. On a mesh that spans processes (parallel/mesh.py)
the shards' tensors first meet in global shard order through
`torch.distributed`: a reduction gathers every shard's operand and
reduces in shard order, so an f64 `psum` over a spanning mesh equals the
same mesh on one process bit for bit.

The transport between processes (`gather_ranks`, `exchange_regions`)
carries bytes: each call packs its tensors into one uint8 buffer, after
one exchange of their lengths where they are ragged. With NCCL the buffer
stays on the card. With Gloo, whose collectives take host tensors, CUDA
tensors are staged through pinned host buffers: the device-to-host copies
pack the buffer, one copy brings the result back. `transport.bytes`
counts the bytes this process sent to the others, `transport.live_bytes`
those of them that carry data (the rest pads ragged parts to one width),
and `transport.calls` the collectives it entered.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from datafusion_tpu_torch.utils.trace import span, spanned

ALIGN = 16  # byte alignment of each tensor in a packed buffer (K5's vector width)


def _spans(mesh) -> bool:
    return mesh is not None and mesh.spans


def _wire(mesh, dev: torch.device) -> tuple[torch.device, bool]:
    """Where the transport takes tensors that live on `dev`: (device,
    pinned). NCCL takes the mesh's card; Gloo takes host tensors, so CUDA
    tensors stage through pinned host memory."""
    if backend() == "nccl":
        return mesh.device, False
    return torch.device("cpu"), dev.type == "cuda"


def _wire_buffer(mesh, nbytes: int, dev: torch.device) -> torch.Tensor:
    """An uninitialized uint8 buffer on the transport's side of `dev`."""
    wdev, pinned = _wire(mesh, dev)
    return torch.empty(nbytes, dtype=torch.uint8, device=wdev, pin_memory=pinned)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _padded(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _sync_staging(mesh, devs) -> None:
    """Wait for the device-to-host copies into a staging buffer before
    Gloo reads it: each copy runs on the stream of the card its tensor
    lies on, so every card of `devs` is waited for."""
    for dev in dict.fromkeys(devs):
        if _wire(mesh, dev)[1]:
            torch.cuda.current_stream(dev).synchronize()


def backend() -> str:
    """The torch.distributed backend a spanning mesh's collectives run on."""
    import torch.distributed as dist

    return dist.get_backend()


def transport(op: str, *args, sent: int = 0, live: Optional[int] = None) -> None:
    """Enter one collective of the default group (`op` names the
    torch.distributed function), counting it, the bytes sent and the
    live bytes among them (default: all)."""
    import torch.distributed as dist

    transport.calls += 1
    transport.bytes += sent
    transport.live_bytes += sent if live is None else live
    getattr(dist, op)(*args, group=dist.group.WORLD)


transport.calls = 0
transport.bytes = 0
transport.live_bytes = 0


@spanned("dft.collective.gather_ranks")
def gather_ranks(mesh, ts: Sequence[torch.Tensor], *, to_device: bool = True) -> list[list[torch.Tensor]]:
    """Every process's `ts`, in rank order: result[k][q] is process q's
    tensor k, flattened. Lengths may differ between processes; dtypes are
    the same everywhere. Two collectives: the lengths, then the payload
    padded to the longest process's. The results lie on `ts`' device, or,
    with `to_device=False`, where the transport left them (host memory
    under Gloo)."""
    dev = ts[0].device
    lens = torch.tensor([t.numel() for t in ts], dtype=torch.int64, device=_wire(mesh, dev)[0])
    got = [torch.empty_like(lens) for _ in range(mesh.world)]
    transport("all_gather", got, lens, sent=lens.nbytes * (mesh.world - 1))
    all_lens = [g.tolist() for g in got]
    sizes = [[_padded(n * t.element_size()) for n, t in zip(row, ts)] for row in all_lens]
    width = max(sum(row) for row in sizes)
    buf = _wire_buffer(mesh, width, dev)
    off = 0
    for t, nb in zip(ts, sizes[mesh.rank]):
        b = _as_bytes(t)
        buf[off:off + b.numel()].copy_(b, non_blocking=True)
        off += nb
    _sync_staging(mesh, [t.device for t in ts])
    bufs = [torch.empty_like(buf) for _ in range(mesh.world)]
    transport("all_gather", bufs, buf, sent=width * (mesh.world - 1),
              live=sum(t.numel() * t.element_size() for t in ts) * (mesh.world - 1))
    out = [[] for _ in ts]
    for q, b in enumerate(bufs):
        if to_device and b.device != dev:
            b = b.to(dev, non_blocking=True)
        off = 0
        for k, (t, n, nb) in enumerate(zip(ts, all_lens[q], sizes[q])):
            out[k].append(b[off:off + n * t.element_size()].view(t.dtype))
            off += nb
    return out


def gather_rows(mesh, xs: Sequence[Optional[torch.Tensor]], *, to_device: bool = True) -> list:
    """Every process's row-aligned tensors `xs` (one length per process)
    concatenated in rank order (`gather_ranks`). A None entry is a bool
    mask that is all true (a validity): it is sent empty, a process that
    sent none gets ones for its rows, and the entry stays None where no
    process has rows under a tensor."""
    live = next(t for t in xs if t is not None)
    parts = gather_ranks(mesh, [live.new_empty(0, dtype=torch.bool) if t is None else t for t in xs],
                         to_device=to_device)
    rows = [max(p[q].shape[0] for p in parts) for q in range(mesh.world)]
    out = []
    for p in parts:
        if not any(t.shape[0] for t in p):
            out.append(None if sum(rows) else torch.cat(p))
            continue
        out.append(torch.cat([t if t.shape[0] == r else torch.ones(r, dtype=torch.bool, device=t.device)
                              for t, r in zip(p, rows)]))
    return out


@spanned("dft.collective.exchange_regions")
def exchange_regions(mesh, sends: Sequence[Sequence[torch.Tensor]], sizes: torch.Tensor,
                     split_cap: int) -> list[list[torch.Tensor]]:
    """The cross-process half of a ragged exchange (parallel/shuffle.py).
    `sends[j]` are local sender j's region-layout arrays, `[n_dev *
    split_cap]` each, on its card, region i for global receiver i, of
    which the first `sizes[first + j, i]` rows are live. Returns, for
    every global sender in order, its arrays' regions for this process's
    receivers, `[n_local * split_cap]` each: a view of the local sender's
    own arrays, on its card, or what a remote sender sent, on the first
    card (local shard 0's). One `all_to_all_single` of bytes moves every
    remote pair's padded regions, packed from every card (a peer copy
    into NCCL's buffer on the first card, or a copy into Gloo's pinned
    staging buffer from each card's stream); the receiving kernel (K5 or
    K6) reads only their valid prefixes."""
    nl, span = mesh.n_local, mesh.n_local * split_cap
    dev = sends[0][0].device
    widths = [span * t.element_size() for t in sends[0]]
    chunk = nl * sum(widths)  # bytes one process sends another
    others = [q for q in range(mesh.world) if q != mesh.rank]
    buf = _wire_buffer(mesh, chunk * len(others), dev)
    off = 0
    for q in others:
        for a in range(len(widths)):
            for arrs in sends:
                buf[off:off + widths[a]].copy_(_as_bytes(arrs[a][q * span:(q + 1) * span]), non_blocking=True)
                off += widths[a]
    _sync_staging(mesh, [arrs[0].device for arrs in sends])
    recv = torch.empty_like(buf)
    splits = [0 if q == mesh.rank else chunk for q in range(mesh.world)]
    mine = sizes[mesh.first:mesh.first + nl].to(torch.int64)
    live_rows = int(mine.sum() - mine[:, mesh.first:mesh.first + nl].sum())
    transport("all_to_all_single", recv, buf, splits, splits, sent=buf.numel(),
              live=live_rows * sum(t.element_size() for t in sends[0]))
    if recv.device != dev:
        recv = recv.to(dev, non_blocking=True)
    out = []
    for q in range(mesh.world):
        for j in range(nl):
            if q == mesh.rank:
                out.append([t[q * span:(q + 1) * span] for t in sends[j]])
                continue
            base = others.index(q) * chunk
            arrs = []
            for a, t in enumerate(sends[0]):
                lo = base + nl * sum(widths[:a]) + j * widths[a]
                arrs.append(recv[lo:lo + widths[a]].view(t.dtype))
            out.append(arrs)
    return out


def to_card(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`t` on card `dev`: `t` itself where it lies there, else one copy
    between cards (a peer copy over NVLink on the H100), whose bytes
    `to_card.bytes` counts."""
    if t.device == dev:
        return t
    with span("dft.to_card"):
        to_card.bytes += t.numel() * t.element_size()
        return t.to(dev)


to_card.bytes = 0


def _on_first_card(xs: Sequence[torch.Tensor], mesh) -> list[torch.Tensor]:
    """The shards' tensors on the mesh's first card, in shard order."""
    if mesh is None:
        return list(xs)
    return [to_card(x, mesh.device) for x in xs]


def _every_shard(xs: Sequence[torch.Tensor], mesh) -> list[torch.Tensor]:
    """Every shard's tensor in global shard order, on the mesh's first
    card; the shards' tensors have one shape."""
    xs = _on_first_card(xs, mesh)
    if not _spans(mesh):
        return xs
    shape = xs[0].shape
    (parts,) = gather_ranks(mesh, [torch.stack(xs)])
    return list(torch.cat(parts).reshape(-1, *shape).unbind(0))


@spanned("dft.collective.all_gather")
def all_gather(xs: Sequence[torch.Tensor], mesh=None) -> torch.Tensor:
    """`lax.all_gather(..., tiled=True)`: the shards concatenated in order,
    on the mesh's first card."""
    local = torch.cat(_on_first_card(xs, mesh))
    if not _spans(mesh):
        return local
    return torch.cat(gather_ranks(mesh, [local])[0])


@spanned("dft.collective.psum")
def psum(xs: Sequence[torch.Tensor], mesh=None) -> torch.Tensor:
    """`lax.psum`, summed in shard order."""
    return functools.reduce(torch.add, _every_shard(xs, mesh))


@spanned("dft.collective.pmin")
def pmin(xs: Sequence[torch.Tensor], mesh=None) -> torch.Tensor:
    """`lax.pmin` (NaN propagates, as XLA's min does)."""
    return functools.reduce(torch.minimum, _every_shard(xs, mesh))


@spanned("dft.collective.pmax")
def pmax(xs: Sequence[torch.Tensor], mesh=None) -> torch.Tensor:
    """`lax.pmax` (NaN propagates, as XLA's max does)."""
    return functools.reduce(torch.maximum, _every_shard(xs, mesh))


@spanned("dft.collective.por")
def por(xs: Sequence[torch.Tensor], mesh=None) -> torch.Tensor:
    """Elementwise OR of the shards' bool tensors."""
    return functools.reduce(torch.logical_or, _every_shard(xs, mesh))


@spanned("dft.collective.size_matrix")
def size_matrix(counts: Sequence[torch.Tensor], mesh=None) -> torch.Tensor:
    """The `[n_dev, n_dev]` int32 matrix of `all_gather`ed per-sender
    counts: row j is what shard j sends to each shard."""
    return torch.stack(_every_shard(counts, mesh)).to(torch.int32)


def agreed_max(value, mesh: Optional[object]):
    """The largest of every process's `value`: a host decision that each
    process takes from its own data, made the same on all of them. `value`
    is an int, or an int64 tensor taken elementwise (K6's float-SUM scale
    words, parallel/shuffle.py), returned on its own device."""
    if not _spans(mesh):
        return value
    if isinstance(value, torch.Tensor):
        (parts,) = gather_ranks(mesh, [value])
        return torch.stack(parts).amax(0)
    (parts,) = gather_ranks(mesh, [torch.tensor([value], dtype=torch.int64)])
    return int(torch.cat(parts).max())
