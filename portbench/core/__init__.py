"""The benchmark's yardstick: traffic generation, weights, peaks and
operation counts, tracing and the reduction of what it records, the
correctness comparison.  Nothing here imports JAX or the JAX package."""
