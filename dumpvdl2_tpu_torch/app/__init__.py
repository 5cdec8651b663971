"""Application layer: the command line (``cli``), the frame decoder and its
process pool, and the metrics sink; the last three are copies of the JAX
package's."""
