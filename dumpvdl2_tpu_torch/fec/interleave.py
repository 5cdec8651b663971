"""VDL2 block deinterleaver.

Transmitted octets are interleaved column-wise across the RS blocks of a
burst: octet stream index i maps to (block=i mod rows, column=i div rows),
except that pad cells of the shortened final block are skipped.  The
reference implements this as an incremental write loop
(decode.c:135-163); here we build explicit gather indices so the same
mapping can run as a vectorized gather on host or TPU.
"""
from __future__ import annotations

import numpy as np

from ..constants import RS_K, RS_N


def get_fec_octetcount(last_block_len: int) -> int:
    """Parity octets carried by a (possibly shortened) final block."""
    if last_block_len < 3:
        return 0
    if last_block_len < 31:
        return 2
    if last_block_len < 68:
        return 4
    return 6


def burst_geometry(datalen_octets: int) -> tuple[int, int, int]:
    """Return (num_blocks, last_block_len_octets, fec_octets) for a burst."""
    num_blocks, last_len = divmod(datalen_octets, RS_K)
    fec = num_blocks * (RS_N - RS_K)
    if last_len != 0:
        num_blocks += 1
    fec += get_fec_octetcount(last_len)
    if last_len == 0:
        last_len = RS_K
    return num_blocks, last_len, fec


def _fill_order(rows: int, cols_per_row: np.ndarray, col_base: int) -> np.ndarray:
    """Column-major (row-fastest) fill order skipping rows already full.

    cols_per_row[r] = number of valid columns for row r (the shortened
    final row has fewer).  Returns an array of flat indices
    row * RS_N + (col_base + col) in transmission order.
    """
    max_cols = int(cols_per_row.max()) if rows > 0 else 0
    cols = np.arange(max_cols)
    rows_idx = np.arange(rows)
    # valid[c, r] says row r has a cell in column c
    valid = cols[:, None] < cols_per_row[None, :]
    flat = rows_idx[None, :] * RS_N + col_base + cols[:, None]
    return flat[valid]


def deinterleave_burst(octets: np.ndarray, datalen_octets: int
                       ) -> tuple[np.ndarray, int, int]:
    """Deinterleave a burst's data+FEC octets into RS codeword rows.

    ``octets`` holds datalen_octets data octets followed by fec octets in
    transmission order.  Returns ``(rs_tab, num_blocks, last_block_len)``
    where rs_tab is (num_blocks, 255) uint8 with pad cells zeroed.
    """
    octets = np.asarray(octets, dtype=np.uint8)
    num_blocks, last_len, fec_octets = burst_geometry(datalen_octets)
    if octets.size != datalen_octets + fec_octets:
        raise ValueError("octet count does not match burst geometry")

    rs_tab = np.zeros((num_blocks, RS_N), dtype=np.uint8)

    data_cols = np.full(num_blocks, RS_K, dtype=np.int64)
    data_cols[-1] = last_len
    data_order = _fill_order(num_blocks, data_cols, 0)
    rs_tab.reshape(-1)[data_order] = octets[:datalen_octets]

    last_fec = get_fec_octetcount(last_len)
    fec_rows = num_blocks if last_fec > 0 else num_blocks - 1
    if fec_rows > 0 and fec_octets > 0:
        fec_cols = np.full(fec_rows, RS_N - RS_K, dtype=np.int64)
        fec_cols[-1] = last_fec if fec_rows == num_blocks else RS_N - RS_K
        fec_order = _fill_order(fec_rows, fec_cols, RS_K)
        rs_tab.reshape(-1)[fec_order] = octets[datalen_octets:]
    return rs_tab, num_blocks, last_len
