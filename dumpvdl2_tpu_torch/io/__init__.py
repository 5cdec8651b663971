"""Inputs and outputs (IQ files, raw-frame archives, formatters, file/UDP/ZMQ
sinks, StatsD): copies of the JAX package's jax-free ``io`` modules, without
its SDR inputs and native helpers."""
