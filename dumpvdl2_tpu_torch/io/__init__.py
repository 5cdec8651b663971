"""Inputs and outputs (IQ files, raw-frame archives, the SDR drivers,
formatters, file/UDP/ZMQ sinks, StatsD): copies of the JAX package's
jax-free ``io`` modules."""
