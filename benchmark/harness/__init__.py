"""The benchmark's harness: cells, weights, spans, trace reduction and the
result line.  Nothing here imports JAX or the JAX package."""
