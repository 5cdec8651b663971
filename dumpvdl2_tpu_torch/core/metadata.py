"""Per-frame metadata carried from the demodulator to the formatters.

Mirrors the reference's ``vdl2_msg_metadata`` (output-common.h:31-43) so
formatters can render identical headers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass(slots=True)
class MsgMetadata:
    version: int = 1
    station_id: Optional[str] = None
    freq: int = 0                      # channel frequency, Hz
    frame_pwr_dbfs: float = 0.0
    nf_pwr_dbfs: float = 0.0
    ppm_error: float = 0.0
    burst_timestamp: float = 0.0       # unix seconds (fractional)
    datalen_octets: int = 0
    synd_weight: int = 0
    num_fec_corrections: int = 0
    idx: int = 0                       # frame index within the burst


@dataclass(slots=True)
class DecodedFrame:
    """One AVLC frame (FCS still attached) plus its burst metadata."""
    metadata: MsgMetadata
    frame: "np.ndarray | bytes"        # uint8 octets including FCS;
                                       # consumers use bytes(frame)
