"""Address enrichment: ground-station file and aircraft Basestation DB.

Rendering hooks used by the AVLC formatter (reference avlc.c:267-309);
data providers live in io/gs_data.py and io/ac_data.py and register
themselves here.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..config import AddrInfoVerbosity, Config
from .base import JsonObj, TextOut

# provider callables set by io.gs_data / io.ac_data on import/configure
gs_lookup: Optional[Callable[[int], Optional[dict]]] = None
ac_lookup: Optional[Callable[[int], Optional[dict]]] = None


def addrinfo_format_text(out: TextOut, indent: int, addr,
                         inline: bool) -> None:
    v = Config.addrinfo_verbosity
    if addr.is_aircraft and Config.ac_addrinfo_db_available and ac_lookup:
        ac = ac_lookup(addr.addr) or {}
        get = lambda k: ac.get(k) or "-"
        if v == AddrInfoVerbosity.TERSE and inline:
            out.append(" [%s]" % get("registration"))
        elif v == AddrInfoVerbosity.NORMAL and not inline:
            out.iline(indent, "AC info: %s, %s, %s" % (
                get("registration"), get("icaotypecode"),
                get("operatorflagcode")))
        elif v == AddrInfoVerbosity.VERBOSE and not inline:
            out.iline(indent, "AC info: %s, %s, %s, %s" % (
                get("registration"), get("manufacturer"), get("type"),
                get("registeredowners")))
    elif addr.is_gs and Config.gs_addrinfo_db_available and gs_lookup:
        gs = gs_lookup(addr.addr) or {}
        get = lambda k: gs.get(k) or "-"
        if v == AddrInfoVerbosity.TERSE and inline:
            out.append(" [%s]" % get("airport_code"))
        elif v == AddrInfoVerbosity.NORMAL and not inline:
            out.iline(indent, "GS info: %s, %s" % (
                get("airport_code"), get("location")))
        elif v == AddrInfoVerbosity.VERBOSE and not inline:
            out.iline(indent, "GS info: %s" % get("details"))


def addrinfo_format_json(obj: JsonObj, addr) -> None:
    v = Config.addrinfo_verbosity
    if addr.is_aircraft and Config.ac_addrinfo_db_available and ac_lookup:
        ac = ac_lookup(addr.addr)
        if not ac:
            return
        if ac.get("registration"):
            obj["regnr"] = ac["registration"]
        if v >= AddrInfoVerbosity.NORMAL:
            if ac.get("icaotypecode"):
                obj["typecode"] = ac["icaotypecode"]
            if ac.get("operatorflagcode"):
                obj["opercode"] = ac["operatorflagcode"]
        if v >= AddrInfoVerbosity.VERBOSE:
            if ac.get("manufacturer"):
                obj["manuf"] = ac["manufacturer"]
            if ac.get("type"):
                obj["model"] = ac["type"]
            if ac.get("registeredowners"):
                obj["owner"] = ac["registeredowners"]
    elif addr.is_gs and Config.gs_addrinfo_db_available and gs_lookup:
        gs = gs_lookup(addr.addr)
        if not gs:
            return
        if gs.get("airport_code"):
            obj["airport_code"] = gs["airport_code"]
        if v >= AddrInfoVerbosity.NORMAL and gs.get("location"):
            obj["location"] = gs["location"]
        if v >= AddrInfoVerbosity.VERBOSE and gs.get("details"):
            obj["details"] = gs["details"]
