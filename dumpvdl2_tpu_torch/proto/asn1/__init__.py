"""ASN.1 unaligned-PER subsystem.

A compact schema-interpreting UPER codec replacing the reference's
~80k LoC of asn1c-generated C (reference: src/asn1/, src/asn1-util.c).
Schemas for the ICAO CM / CPDLC / ADS-C v2 / ACSE message sets live in
``tables_*.py`` as declarative IR (see ``ir.py``); ``runtime.py``
interprets them.
"""
from .ir import Schema
from .runtime import UperDecodeError, decode, encode

__all__ = ["Schema", "decode", "encode", "UperDecodeError"]
