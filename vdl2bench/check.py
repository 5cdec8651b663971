"""How ``correct`` is decided: what the timed path produced, against the
plain reference (reference/receiver.py) worked out from the scene.

Numbers worked out; those the cell's limits file
(``vdl2bench/limits/<workload>.json``) names are compared, each with
its limit:

``frames_mismatch``  frames whose (burst, channel, pool cycle) the
                     program and the reference do not both emit once,
                     plus valid frames of no transmitted burst (exact);
``plane_err``        largest gap between the program's and the
                     reference's channel sample (from the phase and
                     power planes) on the kept blocks, over the
                     channel's RMS; ``plane_rms`` the RMS of those gaps;
``det_mismatch``     detections (channel, index, symbol clock) of the
                     kept blocks in one and not the other;
``dphi_gap``         largest gap of a matched detection's fitted
                     frequency, radians a symbol;
``l2_mismatch``      transmitted bursts of the kept blocks whose L2 row
                     (header length, RS-corrected table) differs from
                     the transmitted one (exact);
``frame_pwr_gap_db``, ``ppm_gap``, ``nf_gap_db``  largest gap of a
                     matched frame's metadata; ``nf_gap_db_p50`` the
                     median gap of the noise floor.

The control (``control.py``) goes through the same comparison: its
frames and kept blocks, as :func:`emissions` and :func:`block_records`
make them, in the program's place.

The reference runs after the window, once the program's pipeline is
freed.  A closed-loop scene cycles one pool: the reference covers the
first two cycles (the first starts from silence, the second from the
first's tail) and every later cycle is the second again, its channel
samples turned by the NCO's phase at the cycle's start.
"""
from __future__ import annotations

import math
import time
import types

import numpy as np
import torch

from .reference import receiver as R
from .traffic import synth

GOOD_FCS = 0xF0B8
FILTER_DELAY_DEC = 8         # channel filter delay, decimated samples


LEAD_BLOCKS = 2              # a cycle's span starts this early ...
MARGIN_BLOCKS = 1            # ... and ends this late


class Reference:
    """The reference over the fed stream: its channel samples, and the
    receiver's detections, decisions and frames, at stream indices.

    A closed-loop stream cycles one pool.  Its channel samples are
    computed for the first two cycles only: cycle k >= 1 is the second
    cycle's samples turned by the NCO's phase at the cycle's start.  The
    sync metric is not invariant to that turn (its phase unwrap corrects
    each step once), so the receiver runs on every cycle's own samples,
    over the cycle and a lead-in and margin of blocks; each cycle keeps
    the detections, claims and frames that fall in it."""

    def __init__(self, run, win, precision: str = "float64"):
        sc = run.scene
        self.sc = sc
        self.os = sc.oversample
        self.N = run.block
        self.M = self.N // self.os if self.N % self.os == 0 else None
        self.closed = hasattr(run, "pool")
        self.raw_fed = win["raw_fed"]
        self.fed_dec = self.raw_fed // self.os
        if self.closed:
            self.pool_raw = len(run.pool) * self.N
            self.pool_dec = self.pool_raw // self.os
            span_raw = min(self.raw_fed, 2 * self.pool_raw)
        else:
            self.pool_raw = self.pool_dec = None
            span_raw = self.raw_fed
        ch = R.Channelizer(sc.freqs, sc.center, sc.fs, self.os, run.device,
                           precision=precision)
        self.dphi = ch.dphi
        raw = self._raw(run, span_raw)
        self.z = ch.decimate(raw, 0, 0, span_raw // self.os) \
            .to(torch.complex128)
        del raw
        # the fed blocks' ends (decimated), as the pipeline cut them
        nb = -(-self.raw_fed // self.N)
        self.block_ends = np.minimum((np.arange(nb) + 1) * self.N,
                                     self.raw_fed) // self.os
        self.block_starts = np.concatenate([[0], self.block_ends[:-1]])
        self._run_cycles()

    def _raw(self, run, span_raw: int) -> torch.Tensor:
        if self.closed:
            return torch.cat(run.pool, 1)[:, :span_raw] \
                if span_raw <= self.pool_raw else \
                torch.cat(run.pool + run.pool, 1)[:, :span_raw]
        iq = np.concatenate(run.blocks)[:span_raw]
        return torch.as_tensor(np.stack([iq.real, iq.imag]),
                               device=run.device)

    def cycle(self, d):
        return np.zeros_like(np.asarray(d)) if not self.closed \
            else np.asarray(d) // self.pool_dec

    def ref_index(self, d):
        """Index into ``z`` of fed decimated index d (numpy arrays and
        tensors allowed)."""
        if not self.closed:
            return d
        where = torch.where if isinstance(d, torch.Tensor) else np.where
        d = d if isinstance(d, torch.Tensor) else np.asarray(d)
        return where(d >= self.pool_dec, self.pool_dec
                     + d % self.pool_dec, d)

    def turn(self, k: int) -> torch.Tensor:
        """(C,) phase by which cycle k's channel samples lead the second
        cycle's (0 for the first two)."""
        if not self.closed or k <= 1:
            return torch.zeros_like(self.dphi, dtype=torch.float64)
        step = ((k - 1) * self.pool_raw) & R.MASK24
        return ((step * self.dphi) & R.MASK24).to(torch.float64) \
            * (2.0 * np.pi / float(1 << 24))

    def samples(self, lo: int, hi: int, chans=None) -> torch.Tensor:
        """(C, hi - lo) complex channel samples of fed indices [lo, hi),
        of the channels ``chans`` (all by default)."""
        d = np.arange(lo, hi)
        z = self.z if chans is None else self.z[chans]
        zr = z[:, torch.as_tensor(self.ref_index(d), device=self.z.device)]
        if not self.closed:
            return zr
        k = self.cycle(d)
        for kk in np.unique(k[k >= 2]):
            sel = torch.as_tensor(k == kk, device=zr.device)
            turn = self.turn(int(kk))
            if chans is not None:
                turn = turn[chans]
            zr[:, sel] *= torch.exp(1j * turn)[:, None]
        return zr

    def _run_cycles(self) -> None:
        """The receiver on every channel that carries a transmitted burst
        (its frames, its neighbours' echoes there and its claims), cycle
        by cycle."""
        sc = self.sc
        self.chans = np.unique(sc.channel)
        chans_t = torch.as_tensor(self.chans, device=self.z.device)
        exp_sync = R.expected_sync(sc, FILTER_DELAY_DEC * self.os)
        rows_all = np.arange(len(sc.bursts))
        if not self.closed:
            spans = [(0, 0, self.fed_dec, 0, self.fed_dec)]
        else:
            P, M = self.pool_dec, self.N // self.os
            spans = [(k, k * P, min((k + 1) * P, self.fed_dec),
                      max(0, k * P - LEAD_BLOCKS * M),
                      min(self.fed_dec, (k + 1) * P + MARGIN_BLOCKS * M))
                     for k in range(-(-self.fed_dec // P))]
        self.frames, self.claims = [], {}
        for k, lo, hi, s, e in spans:
            z = self.samples(s, e, chans_t)
            phase = torch.atan2(z.imag, z.real)
            pwr = z.real ** 2 + z.imag ** 2
            del z
            if self.closed:
                rows = np.concatenate([rows_all] * 3)
                sync = np.concatenate([exp_sync + (k + m) * self.pool_dec
                                       for m in (-1, 0, 1)])
            else:
                rows, sync = rows_all, exp_sync
            out = R.receive(phase, pwr, sc, e - s, rows, sync,
                            self.block_ends, offset=s)
            del phase, pwr
            d = out["det"]
            d["channel"] = self.chans[d["channel"]]
            for f in out["frames"]:
                if lo <= f["det"] < hi:
                    f["channel"] = int(self.chans[f["channel"]])
                    self.frames.append(dict(f, cycle=k))
            for c in np.unique(d["channel"]):
                self.claims.setdefault(int(c), []).extend(
                    x for x in R.claims(out, int(c)) if lo <= x[2] < hi)

    def detections(self, lo: int, hi: int) -> dict:
        """Every channel's detections on the planes of fed indices
        [lo, hi) alone, as a receiver that works on that block finds
        them."""
        z = self.samples(lo, hi)
        err, freq = R.sync_metric(torch.atan2(z.imag, z.real))
        del z
        det = R.detections(err, freq)
        for key in ("det", "sync"):
            det[key] = det[key] + lo
        return det


def plane_gap(z: torch.Tensor, z_ref: torch.Tensor) -> torch.Tensor:
    """|z - z_ref| of each channel sample over its channel's RMS in the
    reference."""
    rms = torch.sqrt((z_ref.abs() ** 2).mean(1, keepdim=True))
    return (z - z_ref).abs() / rms


METADATA = ("frame_pwr_dbfs", "ppm_error", "nf_pwr_dbfs")


def _largest(x: np.ndarray) -> float:
    return float(x.max()) if x.size else 0.0


def readings(ref: Reference, rows: list) -> list:
    """What a receiver reports with each of ``rows`` (frames of
    ``ref``), as the port's frame metadata defines it: the frame's power
    in dBFS, the carrier error in ppm of the channel's frequency, and
    the noise floor (``ref``'s tracker at the sync point) in dBFS."""
    sc = ref.sc
    floors = _noise_floors(ref, rows)
    return [{"frame_pwr_dbfs": 10.0 * math.log10(max(r["frame_pwr"],
                                                     1e-30)),
             "ppm_error": R.SYMBOL_RATE * r["dphi"]
             / (2.0 * math.pi * sc.freqs[r["channel"]]) * 1e6,
             "nf_pwr_dbfs": 20.0 * math.log10(nf + 0.001)}
            for r, nf in zip(rows, floors)]


def emissions(ref: Reference) -> list:
    """``ref``'s frames (the control's) as the window records the
    program's: (call, return time, frame), the call being the block
    that holds the burst's last sample, the frame its burst's bytes
    with the metadata of :func:`readings`."""
    sc = ref.sc
    out = []
    for f, md in zip(ref.frames, readings(ref, ref.frames)):
        j = f["burst"]
        end = int(sc.end[j]) + (f["cycle"] * ref.pool_raw if ref.closed
                                else 0)
        out.append((end // ref.N, 0.0, types.SimpleNamespace(
            frame=sc.bursts[j].frame, metadata=types.SimpleNamespace(
                freq=sc.freqs[f["channel"]], **md))))
    return out


def block_records(ref: Reference, shapes: list) -> list:
    """What the tap keeps of a block, as ``ref`` (the control) computes
    it for the program's kept blocks [(block, base, M, K)]: the phase
    and power planes and the first K detections of each channel; no L2
    rows."""
    recs = []
    for block, base, M, K in shapes:
        z = ref.samples(base, base + M)
        det = ref.detections(base, base + M)
        C = z.shape[0]
        count = np.zeros(C, np.int64)
        idx = np.zeros((C, K), np.int64)
        sync = np.zeros((C, K), np.int64)
        dphi = np.zeros((C, K))
        for c, d, sp, f in zip(det["channel"], det["det"], det["sync"],
                               det["dphi"]):
            n = count[c]
            if n < K:
                idx[c, n], sync[c, n], dphi[c, n] = d - base, sp - base, f
            count[c] += 1
        recs.append({"block": block, "base": base,
                     "phases": torch.atan2(z.imag, z.real),
                     "pwr": z.real ** 2 + z.imag ** 2,
                     "dets": types.SimpleNamespace(
                         count=torch.as_tensor(count),
                         det_idx=torch.as_tensor(idx),
                         sync_idx=torch.as_tensor(sync),
                         dphi=torch.as_tensor(dphi)),
                     "l2": None, "inv": None})
        del z
    return recs


def judge(run, win, records: list, limits: dict, ref=None) -> dict:
    """The check: ``correct``, ``attempted``, ``failed`` and the numbers
    compared with their limits.  ``win["emitted"]`` and ``records`` are
    the program's (or the control's, see :func:`emissions` and
    :func:`block_records`); ``ref`` the float64 reference if it is
    already worked out."""
    sc = run.scene
    t0 = time.perf_counter()
    ref = ref or Reference(run, win)
    parts = {"reference_s": time.perf_counter() - t0}
    numbers = {}
    by_payload = sc.payload_index()
    N, fed = ref.N, ref.raw_fed

    # ---- reference emissions, per (burst, channel) -> list of cycles
    ref_frames = {}
    ref_rows = {}
    for f in ref.frames:
        j, c, k = f["burst"], f["channel"], f["cycle"]
        ref_frames.setdefault((j, c), []).append(k)
        ref_rows[(j, c, k)] = f

    # ---- program emissions
    prog = {}
    unknown = bad_fcs = 0
    for call, t_ret, fr in win["emitted"]:
        b = bytes(fr.frame)
        if synth.crc16_ccitt(b) != GOOD_FCS:
            bad_fcs += 1
            continue
        j = by_payload.get(b)
        if j is None:
            unknown += 1
            continue
        c = sc.freqs.index(fr.metadata.freq)
        prog.setdefault((j, c), []).append((call, t_ret, fr))

    # each program emission belongs to the latest cycle whose copy of
    # its burst had ended by the call that returned it
    def cycle_of(j: int, call: int) -> int:
        """max k with (k * pool + end_j) // N <= call, else -1"""
        span = (call + 1) * N - 1 - int(sc.end[j])
        if span < 0:
            return -1
        return span // ref.pool_raw if ref.closed else 0

    got = {}
    for (j, c), frames in prog.items():
        for call, t_ret, fr in frames:
            k = cycle_of(j, call) if call < win["blocks"] else \
                cycle_of(j, call - 1)
            got.setdefault((j, c, k), []).append((t_ret, fr))
    want = {(j, c, k) for (j, c), ks in ref_frames.items() for k in ks}
    # a burst's frame on its own channel is judged exactly; its copies
    # that a neighbouring channel's filter lets through (echoes) hang on
    # symbol decisions a rounding can turn, and are counted apart
    # (the reference runs the channels that carry bursts; an echo on
    # another channel is only required to carry a transmitted burst)
    mismatch, echo, unjudged = unknown, 0, 0
    matched = []            # (reference row, program frame, return time, k)
    shown = []              # the first mismatches, for the record
    judged = set(ref.chans.tolist())
    for key in sorted(set(got) | want):
        n = len(got.get(key, []))
        own_channel = key[1] == int(sc.channel[key[0]])
        if key[1] not in judged:
            unjudged += n
            continue
        if own_channel:
            mismatch += abs(n - (key in want))
        else:
            echo += abs(n - (key in want))
        if n != (key in want) and len(shown) < 8:
            j, c, k = key
            shown.append({"burst": j, "channel": c, "cycle": k,
                          "burst_channel": int(sc.channel[j]),
                          "program": n, "reference": int(key in want),
                          "start": int(sc.start[j]), "end": int(sc.end[j]),
                          "octets": len(sc.bursts[j].frame),
                          "amplitude": float(sc.amplitude[j])})
        if n and key in want and own_channel:
            t_ret, fr = got[key][0]
            matched.append((ref_rows[key], fr, t_ret, key[2]))
    numbers["frames_mismatch"] = mismatch
    numbers["echo_mismatch"] = echo

    # attempted: transmitted bursts whose last sample was fed; failed:
    # those the program did not emit once, byte for byte, on their
    # channel, where the reference does; lost: those the reference does
    # not emit either (a detection on noise or a neighbour's burst held
    # the channel busy when the burst began)
    inst = []
    for k in range(-(-fed // ref.pool_raw) if ref.closed else 1):
        off = k * ref.pool_raw if ref.closed else 0
        inst += [(int(j), k) for j in np.nonzero(off + sc.end < fed)[0]]
    failed = ref_lost = 0
    for j, k in inst:
        key = (j, int(sc.channel[j]), k)
        if key in want:
            failed += len(got.get(key, [])) != 1
        else:
            ref_lost += 1

    # ---- frame metadata: each matched frame's against what the
    # reference reports with its frame
    t0 = time.perf_counter()
    want_md = readings(ref, [m[0] for m in matched])
    parts["noise_floor_s"] = time.perf_counter() - t0
    gap = {k: np.array([abs(getattr(fr.metadata, k) - w[k])
                        for (_, fr, _, _), w in zip(matched, want_md)])
           for k in METADATA}
    numbers["frame_pwr_gap_db"] = _largest(gap["frame_pwr_dbfs"])
    numbers["ppm_gap"] = _largest(gap["ppm_error"])
    numbers["nf_gap_db"] = _largest(gap["nf_pwr_dbfs"])
    numbers["nf_gap_db_p50"] = float(np.median(gap["nf_pwr_dbfs"])) \
        if len(matched) else 0.0
    t0 = time.perf_counter()
    numbers.update(_blocks(ref, records))
    parts["blocks_s"] = time.perf_counter() - t0
    correct = all(numbers[k] <= limits[k] for k in limits)
    uncompared = {k: v for k, v in numbers.items() if k not in limits}
    return {"correct": bool(correct), "attempted": len(inst),
            "failed": failed, "numbers": numbers, "limits": limits,
            "info": {"reference_lost": ref_lost, "bad_fcs_frames": bad_fcs,
                     "unknown_frames": unknown, "mismatches": shown,
                     "unjudged_echo_frames": unjudged,
                     "check_parts": parts, "uncompared": uncompared,
                     "frames": len(win["emitted"]),
                     "matched_frames": len(matched),
                     "kept_blocks": [r["block"] for r in records]},
            "matched": matched, "reference": ref}


def _noise_floors(ref: Reference, rows: list) -> list:
    """``ref``'s tracker's floor at each of ``rows``' sync points, over
    every column fed."""
    dev = ref.z.device
    starts = torch.as_tensor(ref.block_starts, device=dev)
    n = (torch.as_tensor(ref.block_ends, device=dev) - starts + 2) // 3
    step = torch.arange(int(n.max()), device=dev)
    cols = (starts[:, None] + 3 * step[None, :])[step[None, :] < n[:, None]]
    floors = [None] * len(rows)
    by_c = {}
    for i, r in enumerate(rows):
        by_c.setdefault(r["channel"], []).append(i)
    for c, idx in by_c.items():
        def mags(p, c=c):
            return ref.z[c, ref.ref_index(p)].abs()
        reads = R.track_noise_floor(cols, mags, ref.claims.get(c, []),
                                    [rows[i]["sync"] for i in idx],
                                    ref.block_starts)
        for i, v in zip(idx, reads):
            floors[i] = v
    return floors


def _blocks(ref: Reference, records: list) -> dict:
    """Planes, detections and L2 rows of the kept blocks."""
    res = {"plane_err": 0.0, "plane_rms": 0.0, "det_mismatch": 0,
           "dphi_gap": 0.0, "l2_mismatch": 0}
    sc = ref.sc
    emitted = {}
    for f in ref.frames:
        emitted[(f["channel"], f["det"])] = f
    for rec in records:
        base = rec["base"]
        phases, pwr = rec["phases"], rec["pwr"]
        M = phases.shape[1]
        zr = ref.samples(base, base + M)
        zp = torch.sqrt(pwr.double()) * torch.exp(1j * phases.double())
        gap = plane_gap(zp, zr)
        res["plane_err"] = max(res["plane_err"], float(gap.max()))
        res["plane_rms"] = max(res["plane_rms"],
                               float(torch.sqrt((gap ** 2).mean())))
        del zr, zp, gap
        # detections in the block's window
        dets = rec["dets"]
        K = dets.det_idx.shape[1]
        cnt = dets.count.cpu().numpy()
        pd = dets.det_idx.cpu().numpy()
        ps = dets.sync_idx.cpu().numpy()
        pf = dets.dphi.cpu().numpy()
        prog_set = {}
        for c in range(cnt.size):
            for j in range(min(int(cnt[c]), K)):
                prog_set[(c, base + int(pd[c, j]))] = (base + int(ps[c, j]),
                                                       float(pf[c, j]), j)
        lo, hi = base + R.LOOKBACK + 2, base + M
        det = ref.detections(base, base + M)
        ref_set = {(int(det["channel"][i]), int(det["det"][i])):
                   (int(det["sync"][i]), float(det["dphi"][i]))
                   for i in np.nonzero((det["det"] >= lo)
                                       & (det["det"] < hi))[0]}
        # the program keeps the first K leaders of a channel
        firsts = {}
        for (c, dd) in sorted(ref_set):
            firsts.setdefault(c, []).append(dd)
        ref_set = {(c, dd): ref_set[(c, dd)] for c, lst in firsts.items()
                   for dd in lst[:K]}
        for key in set(prog_set) | set(ref_set):
            a, b = prog_set.get(key), ref_set.get(key)
            if a is None or b is None or a[0] != b[0]:
                res["det_mismatch"] += 1
                continue
            res["dphi_gap"] = max(res["dphi_gap"], abs(a[1] - b[1]))
        # L2 rows of transmitted bursts the reference emits
        l2, inv = rec["l2"], rec["inv"]
        if l2 is None:
            continue
        hdr_ok = l2["hdr_ok"].cpu().numpy()
        datalen = l2["datalen"].cpu().numpy()
        blocks = l2["blocks"]
        brow = l2["blocks_row"].cpu().numpy() if "blocks_row" in l2 \
            else None
        inv_np = None if inv is None else inv.cpu().numpy()
        for key, (sp, _) in ref_set.items():
            f = emitted.get(key)
            if f is None or key not in prog_set:
                continue
            if sp + R.SPS * f["total"] > base + M - 1:
                continue
            slot = key[0] * K + prog_set[key][2]
            row = slot if inv_np is None else int(inv_np[slot])
            if row < 0:
                continue
            burst = sc.bursts[f["burst"]]
            if not hdr_ok[row] or int(datalen[row]) != burst.datalen:
                res["l2_mismatch"] += 1
                continue
            bi = row if brow is None else int(brow[row])
            if bi < 0:
                continue
            nb = burst.rs_tab.shape[0]
            got = blocks[bi, :nb].cpu().numpy()
            _, last_len, _ = synth.burst_geometry((burst.datalen + 7) // 8)
            data = np.arange(synth.RS_N)[None, :] < np.where(
                np.arange(nb) < nb - 1, synth.RS_K, last_len)[:, None]
            if not np.array_equal(got[data], burst.rs_tab[data]):
                res["l2_mismatch"] += 1
    return res
