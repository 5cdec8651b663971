/* Native host-side L2 tail: HDLC bit-unstuffing and CRC-16-CCITT.
 *
 * These are the only inherently sequential per-burst operations left on
 * the host after the device L2 decode (fec/l2.py); at the 256-channel
 * scale the Python loop becomes measurable, so they are implemented
 * natively (the reference's equivalents are bitstream.c:109-150 and
 * crc.c).  Semantics mirror dumpvdl2_tpu_torch/link/unstuff.py EXACTLY:
 * the Python implementation stays as the executable spec, and
 * tests/test_torch_native.py holds both to each other and to the JAX
 * package's.
 *
 * Built by dumpvdl2_tpu_torch/native/__init__.py with the system C
 * compiler into dumpvdl2_tpu_torch/_build/ at first use.  A failed
 * build raises; only DUMPVDL2_TPU_NATIVE=0 selects the Python path.
 */
#include <stdint.h>
#include <stddef.h>

/* Unstuff a descrambled burst payload into frames.
 *
 * src:        bit vector (one bit per byte), n bits
 * out_bits:   caller buffer, at least n bytes
 * lens:       per-frame bit counts (bits written back-to-back in
 *             out_bits), at most max_frames entries
 * Returns the number of frames produced; *err is set to 1 when the
 * stream ended in an invalid stuffing sequence AFTER those frames
 * (seven consecutive ones, or a flag before 8 accumulated bits).
 */
int l2h_unstuff_frames(const uint8_t *src, int32_t n, uint8_t *out_bits,
                       int32_t *lens, int32_t max_frames, int32_t *err) {
    int32_t pos = 0, nframes = 0, total = 0;
    *err = 0;
    while (pos < n) {
        int32_t ones = 0, len = 0, closed = 0;
        uint8_t *dst = out_bits + total;
        while (pos < n) {
            uint8_t bit = src[pos++];
            if (bit == 0 && ones == 5) {        /* stuffed zero */
                ones = 0;
                continue;
            }
            if (bit == 1) {
                ones++;
                if (ones > 6) {                 /* 7 consecutive ones */
                    *err = 1;
                    return nframes;
                }
            }
            dst[len++] = bit;
            if (bit == 0) {
                if (ones == 6) {                /* flag byte complete */
                    if (len == 8) {             /* opening flag */
                        len = 0;
                        ones = 0;
                        continue;
                    }
                    if (len < 8) {              /* flag at stream start */
                        *err = 1;
                        return nframes;
                    }
                    len -= 8;                   /* strip trailing flag */
                    closed = 1;
                    break;
                }
                ones = 0;
            }
        }
        if (nframes < max_frames) {
            lens[nframes++] = len;
            total += len;
        }
        if (!closed)
            break;
    }
    return nframes;
}

/* CRC-16-CCITT, reflected polynomial 0x8408 (crc.c equivalent). */
uint16_t l2h_crc16_ccitt(const uint8_t *data, int32_t len,
                         uint16_t crc_init) {
    static uint16_t table[256];
    static int have_table = 0;
    if (!have_table) {
        for (int b = 0; b < 256; b++) {
            uint16_t crc = (uint16_t)b;
            for (int i = 0; i < 8; i++)
                crc = (crc & 1) ? (uint16_t)((crc >> 1) ^ 0x8408)
                                : (uint16_t)(crc >> 1);
            table[b] = crc;
        }
        have_table = 1;
    }
    uint16_t crc = crc_init;
    for (int32_t i = 0; i < len; i++)
        crc = (uint16_t)((crc >> 8) ^ table[(crc ^ data[i]) & 0xFF]);
    return crc;
}

/* Descramble helper (x^15+x+1 LFSR keystream XOR), for completeness of
 * the native L2 tail; the device path normally handles this. */
void l2h_descramble(uint8_t *bits, int32_t n, uint16_t iv) {
    uint16_t lfsr = iv;
    for (int32_t i = 0; i < n; i++) {
        uint8_t fb = (uint8_t)((lfsr ^ (lfsr >> 14)) & 1);
        lfsr = (uint16_t)((lfsr >> 1) | (fb << 14));
        bits[i] ^= fb;
    }
}

/* ---- raw-frames archive record parser -------------------------------
 *
 * Single-pass proto3 decode of one raw_avlc_frame record body
 * (io/rawframes.py is the executable spec, and decodes what this
 * parser refuses).  Bulk archive replay is bounded by this parse in
 * Python, so it is the one other host-stack stage implemented
 * natively.  Field numbers per the
 * published schema (proto/dumpvdl2.proto in the reference).
 */
typedef struct {
    double   ts;                      /* sec + usec/1e6 */
    float    frame_pwr, nf_pwr, ppm;
    uint64_t freq, synd_weight, datalen_octets, version, num_fec, idx;
    int32_t  station_off, station_len;
    int32_t  frame_off, frame_len;
} l2h_raw_meta;

static int rf_varint(const uint8_t *b, int32_t len, int32_t *pos,
                     uint64_t *out) {
    uint64_t v = 0;
    int shift = 0;
    while (*pos < len) {
        uint8_t c = b[(*pos)++];
        v |= (uint64_t)(c & 0x7F) << shift;
        if (!(c & 0x80)) { *out = v; return 0; }
        shift += 7;
        if (shift > 63) return -1;
    }
    return -1;
}

/* returns 0 on success, -1 on malformed input (the caller then
 * decodes it with the Python spec, which raises informatively) */
int32_t l2h_parse_raw_frame(const uint8_t *body, int32_t len,
                            l2h_raw_meta *m) {
    m->ts = 0.0;
    m->frame_pwr = m->nf_pwr = m->ppm = 0.0f;
    m->freq = m->synd_weight = m->datalen_octets = 0;
    m->version = 1;                   /* MsgMetadata default */
    m->num_fec = m->idx = 0;
    m->station_off = m->station_len = 0;
    m->frame_off = m->frame_len = 0;

    int32_t pos = 0;
    while (pos < len) {
        uint64_t key, v;
        if (rf_varint(body, len, &pos, &key)) return -1;
        int field = (int)(key >> 3), wire = (int)(key & 7);
        if (wire != 2) return -1;     /* top level: two bytes fields */
        if (rf_varint(body, len, &pos, &v)) return -1;
        /* compare in uint64 space: a length with the high bit set
         * must not wrap the signed check into a bounds bypass */
        if (v > (uint64_t)(len - pos)) return -1;
        int32_t sub = pos, sub_end = pos + (int32_t)v;
        pos = sub_end;
        if (field == 2) {             /* frame bytes */
            m->frame_off = sub;
            m->frame_len = sub_end - sub;
            continue;
        }
        if (field != 1) continue;     /* unknown: skip */
        /* metadata submessage */
        uint64_t sec = 0, usec = 0;
        while (sub < sub_end) {
            uint64_t k2, v2;
            if (rf_varint(body, sub_end, &sub, &k2)) return -1;
            int f2 = (int)(k2 >> 3), w2 = (int)(k2 & 7);
            if (w2 == 0) {
                if (rf_varint(body, sub_end, &sub, &v2)) return -1;
                switch (f2) {
                    case 2:  m->freq = v2; break;
                    case 3:  m->synd_weight = v2; break;
                    case 4:  m->datalen_octets = v2; break;
                    case 8:  m->version = v2; break;
                    case 9:  m->num_fec = v2; break;
                    case 10: m->idx = v2; break;
                    default: break;
                }
            } else if (w2 == 5) {
                if (sub + 4 > sub_end) return -1;
                float f;
                __builtin_memcpy(&f, body + sub, 4);
                sub += 4;
                switch (f2) {
                    case 5: m->frame_pwr = f; break;
                    case 6: m->nf_pwr = f; break;
                    case 7: m->ppm = f; break;
                    default: break;
                }
            } else if (w2 == 1) {
                if (sub + 8 > sub_end) return -1;
                sub += 8;
            } else if (w2 == 2) {
                if (rf_varint(body, sub_end, &sub, &v2)) return -1;
                if (v2 > (uint64_t)(sub_end - sub)) return -1;
                int32_t s2 = sub, s2e = sub + (int32_t)v2;
                sub = s2e;
                if (f2 == 1) {        /* station_id */
                    m->station_off = s2;
                    m->station_len = s2e - s2;
                } else if (f2 == 11) {/* timestamp submessage */
                    while (s2 < s2e) {
                        uint64_t k3, v3;
                        if (rf_varint(body, s2e, &s2, &k3)) return -1;
                        if ((k3 & 7) != 0) return -1;
                        if (rf_varint(body, s2e, &s2, &v3)) return -1;
                        if ((k3 >> 3) == 1) sec = v3;
                        else if ((k3 >> 3) == 2) usec = v3;
                    }
                }
            } else {
                return -1;
            }
        }
        m->ts = (double)sec + (double)usec / 1e6;
    }
    return 0;
}
