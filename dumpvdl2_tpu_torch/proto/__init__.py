"""Host protocol stack (AVLC, ACARS, X.25/CLNP/COTP, ICAO ULCS): a copy of
``dumpvdl2_tpu/proto``, kept line for line so that both packages give
the same text and JSON output."""
