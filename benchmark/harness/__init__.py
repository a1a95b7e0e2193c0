"""The benchmark harness: cells, traffic kinds, spans and traces, the
judge of correctness and the arithmetic of the per-layer metrics."""
