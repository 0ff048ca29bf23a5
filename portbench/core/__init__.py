"""The harness's general parts: the cell's files, the traffic generator,
the comparison that decides `correct`, and the reduction of the trace."""
