"""Protocol and pipeline constants for the VDL Mode 2 receive pipeline.

These are facts of the VDL2 air interface (ICAO Annex 10 Vol III / Doc 9776)
as implemented by the reference decoder (see its src/dumpvdl2.h:37-49 and
src/decode.c:40-50 for the equivalents).  A copy of
``dumpvdl2_tpu/constants.py``: the PyTorch port imports nothing from the
JAX package.
"""

# Reed-Solomon code geometry: RS(255, 249) over GF(2^8)
RS_N = 255              # codeword length in octets
RS_K = 249              # data octets per codeword
RS_POLY = 0x187         # GF(2^8) field generator polynomial x^8+x^7+x^2+x+1
RS_FCR = 120            # first consecutive root of the generator polynomial
RS_PRIM = 1             # primitive element exponent step

# Burst header: 3 reserved bits + 17-bit transmission length + 5-bit FEC
TRLEN = 17              # transmission-length field, bits
HDRFECLEN = 5           # header FEC field, bits
HEADER_LEN = 3 + TRLEN + HDRFECLEN

# Modulation
PREAMBLE_SYMS = 16      # length of the synchronization preamble, symbols
SPS = 10                # samples per symbol after decimation
BPS = 3                 # bits per symbol (D8PSK)
ARITY = 8
SYMBOL_RATE = 10500     # symbols per second
CSC_FREQ = 136_975_000  # common signalling channel, Hz

# Scrambler: 15-bit LFSR, x^15 + x + 1, seeded per burst
LFSR_IV = 0x6959
LFSR_LEN = 15

# Sanity caps on the transmission length field (reference decode.c:45-48)
MAX_FRAME_LENGTH = 0x3FFF
MAX_FRAME_LENGTH_CORRECTED = 0x1FFF

# Frame sync tuning (reference demod.c:37-48)
SYNC_THRESHOLD = 4.0
PHERR_MAX = 1000.0
MAG_LP = 0.9            # signal magnitude EMA coefficient
NF_LP = 0.85            # noise floor EMA coefficient

# Input lowpass filter design (Chebyshev characteristic)
INP_LPF_CUTOFF_FREQ = 8000
INP_LPF_RIPPLE_PERCENT = 0.5
INP_LPF_NPOLES = 2

# File input defaults
FILE_BUFSIZE = 320_000
FILE_OVERSAMPLE = 10

# Cumulative phase of each preamble symbol, in units of pi/4, starting at 0.
# (The unique word of the VDL2 training sequence; reference demod.c:107-124.)
PREAMBLE_PHASE_UNITS = (0, 3, -3, 1, 1, 2, 0, 4, -3, 4, -2, 3, 1, -2, -3, 0)

# AVLC
MIN_AVLC_LEN = 11
GOOD_FCS = 0xF0B8

# Gray code mapping for D8PSK phase index -> 3-bit symbol value
GRAYCODE = (0, 1, 3, 2, 6, 7, 5, 4)

# Output defaults
OUTPUT_QUEUE_HWM_DEFAULT = 1000
OUTPUT_QUEUE_HWM_NONE = 0
DEFAULT_OUTPUT = "decoded:text:file:path=-"
