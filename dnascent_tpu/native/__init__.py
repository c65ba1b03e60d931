"""ctypes loader (with on-demand build) for the dnascent_native C++ library.

The library provides the host-side sequential pieces that map poorly onto
XLA: the scrappie event FSM, banded backtrace, and libstdc++-exact RNG
streams.  Every entry point has a numpy fallback elsewhere in the package, so
import failure degrades gracefully (slower, not broken).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "dnascent_native.cpp"),
         os.path.join(_HERE, "baseline_cpu.cpp")]
_LIB = os.path.join(_HERE, "libdnascent_native.so")

_lib = None
_load_error: Exception | None = None


def _build() -> None:
    cmd = [
        "g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
        "-fopenmp", *_SRCS, "-o", _LIB,
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def _load():
    global _lib, _load_error
    if _lib is not None:
        return _lib
    try:
        if (not os.path.exists(_LIB)
                or any(os.path.getmtime(_LIB) < os.path.getmtime(s)
                       for s in _SRCS)):
            _build()
        lib = ctypes.CDLL(_LIB)

        i64 = ctypes.c_int64
        u32 = ctypes.c_uint32
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

        lib.event_detect_single.restype = i64
        lib.event_detect_single.argtypes = [
            f64p, i64, i64, i64, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, f64p, i64p, i64p, i64, i64p,
        ]
        lib.banded_backtrace.restype = None
        lib.banded_backtrace.argtypes = [
            u8p, u8p, i64, i64, i64, i64, i64, i64, i64,
            f64p, f32p, f32p, f32p, f32p, i64p, i64p, i64,
            i64p, i64, f64p, i64p, f64p,
        ]
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.process_read_windows.restype = i64
        lib.process_read_windows.argtypes = [
            u8p, i64p, i64p, i64p, i64p, i64p, i64p, i64p,
            i64, i64, i64,
            i64p, i64p, f64p, ctypes.c_double, ctypes.c_double,
            i64p, i64p, i64p, i8p,
            ctypes.c_float, ctypes.c_float, i64,
            i64p, i64p, i64p, i64p, i64p, i64p, i64p, u8p, i64p,
            u8p, i64p, f32p, i64, i64p, i64p,
        ]
        lib.window_chain.restype = i64
        lib.window_chain.argtypes = [
            i64p, i64p, i64, i64p, i64p, i64p, i64, i64, i64,
            i64p, i64p, i64p, i64p,
        ]
        lib.seebreaks_simulation.restype = None
        lib.seebreaks_simulation.argtypes = [
            i64p, i64p, i64, i64p, i64, i64, i64, u32, i64, i64, f64p,
        ]
        lib.seebreaks_observation.restype = None
        lib.seebreaks_observation.argtypes = [u8p, i64, u32, i64, f64p]
        lib.seebreaks_difference.restype = None
        lib.seebreaks_difference.argtypes = [
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            i64, u32, f64p,
        ]
        lib.blockpack_u8.restype = i64
        lib.blockpack_u8.argtypes = [u8p, i64, i64, u8p, u8p, u8p]
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        lib.blockpack_u16.restype = i64
        lib.blockpack_u16.argtypes = [u16p, i64, i64, u8p, u8p, u16p]
        lib.format_eventalign_rows.restype = i64
        lib.format_eventalign_rows.argtypes = [
            i64p, i64p, u8p, f64p, f64p, i64,
            ctypes.c_char_p, i64, i64, i64, ctypes.c_char_p, i64,
        ]
        dbl = ctypes.c_double
        lib.baseline_detect_read.restype = dbl
        lib.baseline_detect_read.argtypes = [
            f64p, i64, i64p, i64, i64p, i64, i64p, f64p, i64,
            i64, i64, dbl, dbl, dbl,
            i64, i64, i64,
            i64, dbl, dbl, dbl, i64, i64,
            f64p, i64, i64,
        ]
        _lib = lib
    except Exception as e:  # pragma: no cover
        _load_error = e
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def get_lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"dnascent_native unavailable: {_load_error}")
    return lib


# ---------------------------------------------------------------------------
# High-level wrappers
# ---------------------------------------------------------------------------

def event_detect(raw: np.ndarray, w1: int = 3, w2: int = 6,
                 thresh1: float = 1.4, thresh2: float = 9.0,
                 peak_height: float = 0.2):
    """Native event detection + merge.  Returns (mean, raw_start, raw_end,
    et_n) mirroring ops.reference.merge_events(detect_events(raw))."""
    lib = get_lib()
    raw = np.ascontiguousarray(raw, dtype=np.float64)
    n = raw.shape[0]
    max_out = n + 1
    mean = np.empty(max_out, dtype=np.float64)
    start = np.empty(max_out, dtype=np.int64)
    end = np.empty(max_out, dtype=np.int64)
    et_n = np.zeros(1, dtype=np.int64)
    m = lib.event_detect_single(raw, n, w1, w2, np.float32(thresh1),
                                np.float32(thresh2), np.float32(peak_height),
                                mean, start, end, max_out, et_n)
    return mean[:m].copy(), start[:m].copy(), end[:m].copy(), int(et_n[0])


def banded_backtrace(trace_packed: np.ndarray, rights_packed: np.ndarray,
                     col: int, n_bands: int,
                     bandwidth: int, n_events: int, n_kmers: int,
                     best_event: int, event_means: np.ndarray,
                     scaled_events: np.ndarray, mu: np.ndarray,
                     inv_sigma: np.ndarray, lp_const: np.ndarray,
                     query_to_ref: np.ndarray, kmer_ranks_ref: np.ndarray):
    """Native banded backtrace of read ``col`` straight from the fill's
    packed outputs (trace (S, B, W) and rights (S, B) u8).  Returns (pairs
    (n,2), cleaned_signals, cleaned_ranks, avg_log_emission, spanned,
    max_gap)."""
    lib = get_lib()
    S, B, W = trace_packed.shape
    if (W != bandwidth or rights_packed.shape != (S, B)
            or 4 * S < n_bands - 2 or not 0 <= col < B):
        raise ValueError(
            f"packed trace {trace_packed.shape} / rights "
            f"{rights_packed.shape} do not hold read {col} with {n_bands} "
            f"bands of width {bandwidth}")
    max_pairs = n_events + n_kmers + 2
    pairs = np.empty(max_pairs * 2, dtype=np.int64)
    cs = np.empty(max_pairs, dtype=np.float64)
    cr = np.empty(max_pairs, dtype=np.int64)
    stats = np.zeros(5, dtype=np.float64)
    lib.banded_backtrace(
        np.ascontiguousarray(trace_packed, dtype=np.uint8),
        np.ascontiguousarray(rights_packed, dtype=np.uint8),
        B, int(col), n_bands, bandwidth, n_events, n_kmers, best_event,
        np.ascontiguousarray(event_means, dtype=np.float64),
        np.ascontiguousarray(scaled_events, dtype=np.float32),
        np.ascontiguousarray(mu, dtype=np.float32),
        np.ascontiguousarray(inv_sigma, dtype=np.float32),
        np.ascontiguousarray(lp_const, dtype=np.float32),
        np.ascontiguousarray(query_to_ref, dtype=np.int64),
        np.ascontiguousarray(kmer_ranks_ref, dtype=np.int64),
        int(kmer_ranks_ref.shape[0]),
        pairs, max_pairs, cs, cr, stats,
    )
    n_pairs = int(stats[3])
    n_cleaned = int(stats[4])
    m = min(n_pairs, max_pairs)
    return (pairs[: 2 * m].reshape(-1, 2).copy(), cs[:n_cleaned].copy(),
            cr[:n_cleaned].copy(), float(stats[0]), bool(stats[1]),
            int(stats[2]))


def window_chain(undef_cum: np.ndarray, bp_pos: np.ndarray,
                 next_bp: np.ndarray, j_at: np.ndarray, guard_cum: np.ndarray,
                 ref_len: int, k: int, total_wl: int):
    """Native twin of the scalar window chain in
    eventalign._build_window_set.  Returns (ri, wl, j0, j1) i64 arrays."""
    lib = get_lib()
    # worst case one window per kmer position (short tail windows)
    n_max = max(1, ref_len - k + 2)
    ri = np.empty(n_max, np.int64)
    wl = np.empty(n_max, np.int64)
    j0 = np.empty(n_max, np.int64)
    j1 = np.empty(n_max, np.int64)
    n = lib.window_chain(
        np.ascontiguousarray(undef_cum, np.int64),
        np.ascontiguousarray(bp_pos, np.int64), int(bp_pos.shape[0]),
        np.ascontiguousarray(next_bp, np.int64),
        np.ascontiguousarray(j_at, np.int64),
        np.ascontiguousarray(guard_cum, np.int64),
        int(ref_len), int(k), int(total_wl), ri, wl, j0, j1)
    n = int(n)
    return ri[:n], wl[:n], j0[:n], j1[:n]


def baseline_detect_read(raw: np.ndarray, rq: np.ndarray, rr: np.ndarray,
                         q2r: np.ndarray, model: np.ndarray, cfg) -> float:
    """Benchmark-only: the full detect hot path (events -> scaling -> banded
    -> Theil-Sen -> windowed Viterbi) as scalar C++ on the host.  Used by
    bench.py to measure the CPU denominator; the production pipeline never
    calls this.  Returns the summed window Viterbi scores (NaN = QC fail)."""
    lib = get_lib()
    hmm = np.asarray([cfg.hmm.external_D2D, cfg.hmm.external_D2M,
                      cfg.hmm.external_I2M, cfg.hmm.external_M2D,
                      cfg.hmm.internal_M2I, cfg.hmm.internal_I2I], np.float64)
    return float(lib.baseline_detect_read(
        np.ascontiguousarray(raw, np.float64), int(raw.shape[0]),
        np.ascontiguousarray(rq, np.int64), int(rq.shape[0]),
        np.ascontiguousarray(rr, np.int64), int(rr.shape[0]),
        np.ascontiguousarray(q2r, np.int64),
        np.ascontiguousarray(model, np.float64), int(model.shape[0]),
        int(cfg.events.window_length1), int(cfg.events.window_length2),
        float(cfg.events.threshold1), float(cfg.events.threshold2),
        float(cfg.events.peak_height),
        int(cfg.scaling.n_quantiles), int(cfg.scaling.theilsen_max_points),
        int(cfg.scaling.theilsen_trim),
        int(cfg.banded.bandwidth), float(cfg.banded.epsilon_skip),
        float(cfg.banded.p_trim), float(cfg.banded.min_average_log_emission),
        int(cfg.banded.max_gap_threshold), int(cfg.banded.min_cleaned_events),
        hmm, int(cfg.window_length_align), int(cfg.kmer_len)))


def process_read_windows(codes, steps_per, ns_per, g_ev, ev_start,
                         ri_arr, rc_arr, indel_arr, is_reverse, k,
                         ev_raw_start, ev_raw_end, raw, shift, scale,
                         ref_to_query, core_rank, res_rank, ref_codes,
                         quant_lo, quant_scale, rawdepth):
    """Native fast-mode window post-processing for one read (the C++ twin of
    eventalign._process_read_windows_batched).  ``g_ev`` is the read's whole
    guarded event-id stream; windows view spans starting at ``ev_start``.
    Returns the acc-style tuple (coord, kmer_start, query_idx, ref_idx,
    core, res, nsig, centerT, indel, sig_flat,
    (scaled_stream, seg_start, nsig))."""
    lib = get_lib()
    total_steps = int(steps_per.sum())
    ev_all = np.ascontiguousarray(g_ev, dtype=np.int64)
    counts_all = (ev_raw_end[ev_all] - ev_raw_start[ev_all] + 1)
    max_samples = int(counts_all.sum()) if ev_all.size else 0
    P_max = max(total_steps, 1)
    coord = np.empty(P_max, np.int64)
    kmer_start = np.empty(P_max, np.int64)
    query_idx = np.empty(P_max, np.int64)
    ref_idx = np.empty(P_max, np.int64)
    core = np.empty(P_max, np.int64)
    res = np.empty(P_max, np.int64)
    nsig = np.empty(P_max, np.int64)
    centerT = np.empty(P_max, np.uint8)
    indel_out = np.empty(P_max, np.int64)
    sig_flat = np.empty(max(min(P_max * rawdepth, max_samples), 1), np.uint8)
    scaled_stream = np.empty(max(max_samples, 1), np.float32)
    seg_start = np.empty(P_max, np.int64)
    fl = np.zeros(1, np.int64)
    nsamp = np.zeros(1, np.int64)
    P = lib.process_read_windows(
        np.ascontiguousarray(codes, np.uint8),
        np.ascontiguousarray(steps_per, np.int64),
        np.ascontiguousarray(ns_per, np.int64),
        ev_all,
        np.ascontiguousarray(ev_start, np.int64),
        np.ascontiguousarray(ri_arr, np.int64),
        np.ascontiguousarray(rc_arr, np.int64),
        np.ascontiguousarray(indel_arr, np.int64),
        int(len(steps_per)), int(bool(is_reverse)), int(k),
        np.ascontiguousarray(ev_raw_start, np.int64),
        np.ascontiguousarray(ev_raw_end, np.int64),
        np.ascontiguousarray(raw, np.float64),
        float(shift), float(scale),
        np.ascontiguousarray(ref_to_query, np.int64),
        np.ascontiguousarray(core_rank, np.int64),
        np.ascontiguousarray(res_rank, np.int64),
        np.ascontiguousarray(ref_codes, np.int8),
        np.float32(quant_lo), np.float32(quant_scale), int(rawdepth),
        coord, kmer_start, query_idx, ref_idx, core, res, nsig, centerT,
        indel_out, sig_flat, fl, scaled_stream, int(scaled_stream.shape[0]),
        seg_start, nsamp)
    P = int(P)
    return (coord[:P], kmer_start[:P], query_idx[:P], ref_idx[:P],
            core[:P], res[:P], nsig[:P], centerT[:P].astype(bool),
            indel_out[:P], sig_flat[: int(fl[0])],
            (scaled_stream[: int(nsamp[0])], seg_start[:P].copy(),
             nsig[:P].copy()))


def blockpack_u8(values: np.ndarray, block: int = 128):
    """Lossless per-block bit-pack of a u8 stream (see ops/blockpack.py for
    the device-side unpack).  Returns (payload, widths, mins, n_payload)."""
    lib = get_lib()
    v = np.ascontiguousarray(values, dtype=np.uint8)
    n = v.shape[0]
    if n % block:
        raise ValueError(f"blockpack_u8: n={n} not a multiple of {block}")
    nb = n // block
    payload = np.zeros(n + 8, dtype=np.uint8)
    widths = np.zeros(nb, dtype=np.uint8)
    mins = np.zeros(nb, dtype=np.uint8)
    n_payload = int(lib.blockpack_u8(v, n, block, payload, widths, mins))
    return payload, widths, mins, n_payload


def blockpack_u16(values: np.ndarray, block: int = 128):
    """u16 variant of blockpack_u8 (widths 0..16, mins u16)."""
    lib = get_lib()
    v = np.ascontiguousarray(values, dtype=np.uint16)
    n = v.shape[0]
    if n % block:
        raise ValueError(f"blockpack_u16: n={n} not a multiple of {block}")
    nb = n // block
    payload = np.zeros(2 * n + 8, dtype=np.uint8)
    widths = np.zeros(nb, dtype=np.uint8)
    mins = np.zeros(nb, dtype=np.uint16)
    n_payload = int(lib.blockpack_u16(v, n, block, payload, widths, mins))
    return payload, widths, mins, n_payload


def format_eventalign_rows(coords, kstarts, is_ins, values, mmeans,
                           seq: str, k: int, is_reverse: bool) -> str:
    """C-side formatting of eventalign table rows (one per raw sample);
    ~60x python's per-row f-string loop.  Arrays are one entry per output
    row; k-mer slicing/revcomp happens in C from the reference bytes."""
    lib = get_lib()
    n = int(coords.shape[0])
    if n == 0:
        return ""
    seq_b = seq.encode()
    cap = n * (64 + 2 * k)
    out = ctypes.create_string_buffer(cap)
    w = int(lib.format_eventalign_rows(
        np.ascontiguousarray(coords, np.int64),
        np.ascontiguousarray(kstarts, np.int64),
        np.ascontiguousarray(is_ins, np.uint8),
        np.ascontiguousarray(values, np.float64),
        np.ascontiguousarray(mmeans, np.float64),
        n, seq_b, len(seq_b), k, int(is_reverse), out, cap))
    if w < 0:
        raise ValueError(f"format_eventalign_rows failed ({w})")
    return out.raw[:w].decode()
