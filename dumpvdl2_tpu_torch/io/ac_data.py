"""Aircraft info from a Basestation SQLite database.

Equivalent of the reference's ac_data.c: lookup by 24-bit ICAO address
with a positive+negative cache (TTL 1800 s, periodic GC, entry-count
gauge).
"""
from __future__ import annotations

import sqlite3
import threading
import time
from typing import Optional

from ..app.stats import stats
from ..config import Config
from ..proto import enrich

CACHE_TTL = 1800.0
CACHE_GC_INTERVAL = 305.0

_QUERY = ("SELECT Registration, ICAOTypeCode, OperatorFlagCode, "
          "Manufacturer, Type, RegisteredOwners FROM Aircraft "
          "WHERE ModeS = ?")

_conn: Optional[sqlite3.Connection] = None
_cache: dict[int, tuple[float, Optional[dict]]] = {}
_lock = threading.Lock()
_last_gc = 0.0


def _gc(now: float) -> None:
    global _last_gc
    if now - _last_gc < CACHE_GC_INTERVAL:
        return
    _last_gc = now
    dead = [k for k, (ts, _v) in _cache.items() if now - ts > CACHE_TTL]
    for k in dead:
        del _cache[k]
    stats.gauge_set("ac_data.cache.entries", len(_cache))


def ac_lookup(addr: int) -> Optional[dict]:
    if _conn is None:
        return None
    now = time.time()
    with _lock:
        _gc(now)
        from ..utils.debug import D_CACHE, debug_print
        hit = _cache.get(addr)
        debug_print(D_CACHE, "ac_data lookup %06X: %s", addr,
                    "hit" if hit is not None else "miss")
        if hit is not None and now - hit[0] <= CACHE_TTL:
            stats.increment("ac_data.cache.hits")
            return hit[1]
        stats.increment("ac_data.cache.misses")
        row = _conn.execute(_QUERY, ("%06X" % addr,)).fetchone()
        entry = None
        if row is not None:
            entry = {
                "registration": row[0],
                "icaotypecode": row[1],
                "operatorflagcode": row[2],
                "manufacturer": row[3],
                "type": row[4],
                "registeredowners": row[5],
            }
        _cache[addr] = (now, entry)
        return entry


def ac_data_init(path: str) -> bool:
    global _conn
    _conn = sqlite3.connect(path, check_same_thread=False)
    # validate schema early
    _conn.execute(_QUERY, ("000000",)).fetchone()
    enrich.ac_lookup = ac_lookup
    Config.ac_addrinfo_db_available = True
    return True
