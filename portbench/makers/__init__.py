"""Table makers: each `make(cfg, seed, devices)` builds a configuration's
tables from `seed` as row blocks, block i on `devices[i]` with a
`torch.Generator` there (one block, on one device, where the
configuration has no shards), and returns them as `core.tables.Tables`
(plain tensors, read by the port and by the reference alike)."""
