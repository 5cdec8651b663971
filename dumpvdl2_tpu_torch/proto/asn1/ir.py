"""Declarative IR for ASN.1 types (the subset the ICAO ATN B1 message
sets use).

Each type is a tuple whose first element is the kind tag.  Type
references are strings resolved through a :class:`Schema` (a dict of
name -> node).  PER constraints are ``(extensible, lb, ub)`` with
``None`` bounds for unbounded, or ``None`` for "no constraint".

Kinds:

  ("seq", members, ext_after)
      members: tuple of (name, typeref, optional, constraint)
      ext_after: index of the last root member, or -1 when the type has
      no extension marker.  Members with index > ext_after belong to
      the extension group. ``constraint`` is a member-level PER value
      constraint overriding the referenced type's (or None).
  ("choice", alts, root_count)
      alts: tuple of (name, typeref); root_count == len(alts) when not
      extensible, else the number of root alternatives (possibly with
      extension alts listed after).  Extensible iff ext flag True:
      stored as ("choice", alts, root_count, extensible)
  ("enum", items, root_count, extensible)
      items: tuple of (value, label) in canonical (ascending-value)
      order, roots first.
  ("int", constraint)              -- INTEGER / NativeInteger
  ("octstr", size_constraint)
  ("bitstr", size_constraint)
  ("charstr", alphabet_constraint, size_constraint)
      alphabet_constraint: (extensible, lo_char, hi_char) or None
      (None => IA5 7-bit).
  ("seqof", elem_typeref, size_constraint)
  ("null",) ("bool",) ("oid",) ("roid",) ("any",)
  ("alias", typeref, value_constraint, size_constraint)
      a named subtype (e.g. FreeText ::= IA5String (SIZE(1..256))).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

Node = Tuple[Any, ...]
Constraint = Optional[Tuple[bool, Optional[int], Optional[int]]]


class Schema(dict):
    """Name -> IR node mapping with helpers."""

    def resolve(self, ref: str) -> Node:
        node = self.get(ref)
        if node is None:
            raise KeyError(f"unresolved ASN.1 type reference: {ref}")
        return node


BUILTINS: Dict[str, Node] = {
    "NULL": ("null",),
    "BOOLEAN": ("bool",),
    "NativeInteger": ("int", None),
    "INTEGER": ("int", None),
    "OCTET_STRING": ("octstr", None),
    "BIT_STRING": ("bitstr", None),
    "IA5String": ("charstr", None, None),
    "NumericString": ("charstr", (False, 32, 57), None),
    "ObjectDescriptor": ("charstr", None, None),
    "GraphicString": ("octstr", None),
    "OBJECT_IDENTIFIER": ("oid",),
    "RELATIVE_OID": ("roid",),
    "ANY": ("any",),
}


def make_schema(types: Dict[str, Node]) -> Schema:
    s = Schema()
    s.update(BUILTINS)
    s.update(types)
    return s
