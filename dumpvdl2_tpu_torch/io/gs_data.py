"""Ground-station info file (MultiPSK format) importer.

Line format: ``hex_addr [airport details] [location]`` (reference
gs_data.c:47-95).  Lookups key on the 24-bit DLC address.
"""
from __future__ import annotations

import re
import sys
from typing import Optional

from ..config import Config
from ..proto import enrich

_DB: dict[int, dict] = {}

_LINE_RE = re.compile(
    r"^\s*([0-9A-Fa-f]{1,6})"
    r"(?:\s+\[([^\]]*)\])?"
    r"(?:\s+\[([^\]]*)\])?\s*$")


def gs_lookup(addr: int) -> Optional[dict]:
    return _DB.get(addr)


def gs_data_import(path: str) -> int:
    """Load the file; returns number of entries imported."""
    count = 0
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = _LINE_RE.match(line)
            if not m:
                print(f"{path}:{lineno}: parse error, skipped",
                      file=sys.stderr)
                continue
            addr = int(m.group(1), 16)
            details = (m.group(2) or "").strip()
            location = (m.group(3) or "").strip()
            airport_code = details.split()[0] if details else None
            _DB[addr] = {
                "airport_code": airport_code,
                "details": details or None,
                "location": location or None,
            }
            count += 1
    enrich.gs_lookup = gs_lookup
    Config.gs_addrinfo_db_available = count > 0
    return count
