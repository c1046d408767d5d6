"""The benchmark's harness: finds a cell's parts by name, builds its
traffic and weights from the seed, times the window, reads the trace and
prints the one result line."""
