"""Windowed eventalign driver: the wavefront over reads.

The reference aligns each read window-by-window, where the next window's
start depends on the previous window's Viterbi result (``reference_index +=
lastM_ref + 1``, ``readHead += lastM_ev + 1``; reference:
src/alignment.cpp:547-741).  Windows of one read are therefore sequential —
so the device batch axis is *reads*: every active read contributes its current
window to a device batch each round, and all reads advance one window per
round (a wavefront).  Reads drop out as they exhaust their reference span.

Host-side window construction and path post-processing are vectorised numpy
per window; the Viterbi fill + backtrace runs on device
(ops/viterbi.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..config import SubstrateConfig, DNA_R10
from ..io.poremodel import PoreModelSet
from ..ops import viterbi as vit
from ..parallel import compute
from ..utils.seqtools import (encode_bases, core_index_from_codes,
                              residual_index_from_codes)
from .prep import PreparedRead

LOG_INV_SQRT_2PI = float(np.log(0.3989422804014327))
RAWDEPTH = 20  # reads.h:12


@dataclass
class AlignedPositions:
    """Per-read aligned-position table (the arrays behind refCoordToAP,
    reads.h:202/292-304), in genome-walk (insertion) order.

    The raw-sample windows exist in two forms: ``signal_u8_flat`` +
    ``signal_counts`` (the transfer-ready flat u8 stream the CNN consumes,
    built directly by the fast path) and the ``signal`` (P, RAWDEPTH) f32
    matrix (materialised lazily from the scaled-sample store for training /
    parity consumers)."""

    coord: np.ndarray        # (P,) reference coordinate of the position
    kmer_start: np.ndarray   # (P,) index into reference_seq of the 9-mer start
    query_idx: np.ndarray    # (P,) event_indexQuery
    ref_idx: np.ndarray      # (P,) event_indexRef
    core_idx: np.ndarray     # (P,) CNN core-sequence index
    residual_idx: np.ndarray  # (P,) CNN residual-sequence index
    n_signals: np.ndarray    # (P,) total signals seen (may exceed RAWDEPTH)
    center_is_T: np.ndarray  # (P,) bool: 9-mer centre base is T
    indel_score: np.ndarray  # (P,) window indel score (quality)
    signal_u8_flat: Optional[np.ndarray] = None  # flat u8, counts-ordered
    signal_counts: Optional[np.ndarray] = None   # (P,) u8 = min(n_signals, 20)
    _signal: Optional[np.ndarray] = None         # (P, RAWDEPTH) f32
    _sig_store: Optional[tuple] = None           # (scaled, seg_start, seg_nsig)

    @property
    def signal(self) -> np.ndarray:
        """(P, RAWDEPTH) f32 zero-padded raw-sample windows."""
        if self._signal is None:
            scaled, seg_start, seg_nsig = self._sig_store
            j = np.arange(RAWDEPTH)
            gidx = seg_start[:, None] + j[None, :]
            valid = j[None, :] < np.minimum(seg_nsig, RAWDEPTH)[:, None]
            self._signal = np.where(
                valid, scaled[np.clip(gidx, 0, scaled.shape[0] - 1)],
                0.0).astype(np.float32)
            self._sig_store = None
        return self._signal


@dataclass
class EventalignResult:
    positions: Optional[AlignedPositions]
    text: Optional[str]      # human-readable eventalign table (when collected)
    qc_passed: bool


@dataclass
class _ReadState:
    p: PreparedRead
    ref_codes: np.ndarray
    core_rank: np.ndarray       # (refLen-k+1,) core index per ref kmer start
    res_rank: np.ndarray
    mean_ref: np.ndarray        # (refLen-k+1,) model mean per ref kmer
    defined: np.ndarray         # (refLen,) base is ACGT
    reference_index: int = 0
    read_head: int = 0
    # accumulators
    acc: dict = field(default_factory=lambda: {
        "coord": [], "kmer_start": [], "query_idx": [], "ref_idx": [],
        "core": [], "res": [], "sig": [], "sigflat": [], "sigstore": [],
        "nsig": [], "centerT": [], "indel": []})
    text_parts: list = field(default_factory=list)
    exhausted: bool = False
    # fast mode: the read's guarded scaled-observation stream (f16) that
    # windows view into, and its base offset in the batch-flat device array
    g_obs: Optional[np.ndarray] = None
    flat_obs_base: int = -1
    rank_off: int = -1          # per-call flat-rank offset (when built here)
    spec: int = 8               # strict mode: adaptive speculation depth
    # strict mode: the read's guarded pair stream, precomputed so every
    # window is a contiguous slice (the guard filter commutes with pair
    # slicing) and rounds ship only i32 offsets instead of (W, T) f32
    # obs planes (see run_eventalign's strict branch)
    strict_jg: Optional[np.ndarray] = None    # (n_pairs+1,) cum guard count
    strict_g_ev: Optional[np.ndarray] = None  # guarded event ids
    strict_gmeans: Optional[np.ndarray] = None  # guarded scaled means f32
    bp_mask: Optional[np.ndarray] = None      # breakpoint positions (lazy)


@dataclass
class _Window:
    state: _ReadState
    ref_index: int
    window_length: int
    obs_scaled: np.ndarray      # (T,) f32 (strict) / f16 view (fast)
    event_ids: np.ndarray       # (T,) global event index per observation
    first_inrange: int          # pair index of the first in-range event
    indel_score: int
    reference_coord: int
    flat_local: int = -1        # fast mode: offset into state.g_obs


def _build_state(p: PreparedRead, models: PoreModelSet,
                 cfg: SubstrateConfig) -> _ReadState:
    k = cfg.kmer_len
    codes = encode_bases(p.record.reference_seq)
    n = codes.shape[0] - k + 1
    if n <= 0:
        st = _ReadState(p, codes, np.empty(0, np.int64), np.empty(0, np.int64),
                        np.empty(0), np.zeros(0, bool))
        st.exhausted = True
        return st
    safe = np.where(codes < 0, 0, codes).astype(np.int64)
    # sliding 9-mer views for the CNN index tables
    win = np.lib.stride_tricks.sliding_window_view(safe, k)
    core = core_index_from_codes(win)
    res = residual_index_from_codes(win)
    ranks = np.where(p.kmer_ranks_ref < 0, 0, p.kmer_ranks_ref)
    mean_ref = models.pore_model[ranks, 0].astype(np.float64)
    return _ReadState(p, codes, core, res, mean_ref, codes >= 0)


def _window_at(st: _ReadState, ri: int, cfg: SubstrateConfig, t_cap: int,
               read_head: int) -> tuple[Optional[_Window], int]:
    """Try to build a window at ``ri`` (alignment.cpp:555-650).

    Returns (window_or_None, ref_advance_on_skip): when the window is
    unusable the caller advances by the returned amount and retries.
    """
    p = st.p
    k = cfg.kmer_len
    total_wl = cfg.window_length_align
    ref_len = len(p.record.reference_seq)
    r2q = p.record.ref_to_query
    pairs = p.event_alignment
    ev_mean = p.event_mean
    dmin, dmax = cfg.detect.event_mean_min, cfg.detect.event_mean_max

    bases_to_end = ref_len - ri
    wl = min(bases_to_end, total_wl)

    if bases_to_end > 1.5 * total_wl:
        # break-point search (alignment.cpp:562-595); snippet must be
        # fully defined else skip the window
        snip_len = int(1.5 * wl)
        if not st.defined[ri : ri + snip_len].all():
            return None, wl
        limit = int(1.5 * wl - k - 1)
        if st.bp_mask is None:
            # both-gaps-above-0.75 positions, precomputed once per read —
            # the per-window python scan dominated the strict wavefront's
            # host time (~100 iterations x thousands of windows)
            m = st.mean_ref
            d1 = np.abs(np.diff(m))           # d1[i] = |m[i] - m[i+1]|
            bp = np.zeros(m.shape[0], bool)
            if m.shape[0] > 2:
                bp[1:-1] = (d1[1:] > 0.75) & (d1[:-1] > 0.75)
            st.bp_mask = bp
        hit = np.nonzero(st.bp_mask[ri + wl : ri + limit])[0]
        if hit.shape[0]:
            wl = wl + int(hit[0]) + k

    if not st.defined[ri : ri + wl].all():
        return None, wl

    lo = r2q[ri]
    hi = r2q[ri + wl - k + 1]
    # pairs[:,1] ascending: locate the in-range span from the cursor
    j0 = np.searchsorted(pairs[:, 1], lo, side="left")
    j0 = max(j0, read_head)
    j1 = np.searchsorted(pairs[:, 1], hi, side="left")
    if j1 <= j0:
        return None, wl
    first_inrange = int(j0)
    flat_local = -1
    if st.strict_jg is not None:
        # guarded stream precomputed: the window is the contiguous slice
        # [jg[j0], jg[j1]) of it — identical ev_ids/means to the inline
        # filter below, plus a flat offset the dispatcher can ship
        J0 = int(st.strict_jg[j0])
        J1 = int(st.strict_jg[j1])
        if J1 - J0 < 2:
            return None, wl
        nT = min(J1 - J0, t_cap)   # safety clip for pathological windows
        ev_ids = st.strict_g_ev[J0 : J0 + nT]
        means = st.strict_gmeans[J0 : J0 + nT]
        flat_local = J0
        if p.record.is_reverse:
            ref_coord = p.record.ref_end - ri - k // 2
        else:
            ref_coord = p.record.ref_start + ri + k // 2
        query_span = int(hi - lo)
        return _Window(st, ri, wl, means, ev_ids, first_inrange,
                       query_span - (wl - k + 1), ref_coord,
                       flat_local=flat_local), 0
    ev_ids = pairs[j0:j1, 0]
    means = ev_mean[ev_ids]
    guard = (means > dmin) & (means < dmax)
    ev_ids = ev_ids[guard]
    means = means[guard]
    if means.shape[0] < 2:
        return None, wl
    if means.shape[0] > t_cap:  # safety clip for pathological windows
        ev_ids = ev_ids[:t_cap]
        means = means[:t_cap]

    query_span = int(hi - lo)
    indel_score = query_span - (wl - k + 1)
    if p.record.is_reverse:
        ref_coord = p.record.ref_end - ri - k // 2
    else:
        ref_coord = p.record.ref_start + ri + k // 2
    obs = ((means - p.shift) / p.scale).astype(np.float32)
    return _Window(st, ri, wl, obs, ev_ids, first_inrange,
                   indel_score, ref_coord), 0


def _next_window(st: _ReadState, cfg: SubstrateConfig,
                 t_cap: int) -> Optional[_Window]:
    """Strict mode: advance ``st`` to its next usable window or mark it
    exhausted.  The cursor (read_head) couples consecutive windows the way
    the reference does."""
    k = cfg.kmer_len
    ref_len = len(st.p.record.reference_seq)
    while st.reference_index < ref_len - k + 1:
        w, skip = _window_at(st, st.reference_index, cfg, t_cap, st.read_head)
        if w is not None:
            return w
        st.reference_index += skip
    st.exhausted = True
    return None


@dataclass
class _WindowSet:
    """Array-form fast-mode windows of one read (no per-window Python
    objects — a 10 kb read has ~200 windows and object overhead dominated
    the host profile)."""

    ri: np.ndarray          # (Wn,) window reference start
    ns: np.ndarray          # (Wn,) state count = wl - k + 1
    g0: np.ndarray          # (Wn,) start into the read's guarded obs stream
    g1: np.ndarray          # (Wn,) end (exclusive, t_cap-clipped)
    ref_coord: np.ndarray   # (Wn,)
    indel: np.ndarray       # (Wn,)
    g_ev: np.ndarray        # read's guarded event-id stream


def _build_window_set(st: _ReadState, cfg: SubstrateConfig,
                      t_cap: int) -> Optional[_WindowSet]:
    """Fast mode: build every window of the read up front, as arrays.

    Batch-first departure from the reference: instead of advancing by
    ``lastM_ref + 1`` (which makes window n+1 depend on window n's Viterbi
    result and serialises device dispatches), successful windows advance by
    the full k-mer span ``wl - k + 1`` — contiguous, non-overlapping k-mer
    coverage with disjoint event ranges, so every window of every read can
    run in one device batch.  Strict mode (`strict=True`) retains the
    reference's cursor coupling.
    """
    k = cfg.kmer_len
    p = st.p
    ref_len = len(p.record.reference_seq)
    n_kmer_max = ref_len - k + 1
    st.exhausted = True
    if n_kmer_max <= 0:
        return None
    total_wl = cfg.window_length_align
    r2q = p.record.ref_to_query
    pairs = p.event_alignment
    ev_mean = p.event_mean
    dmin, dmax = cfg.detect.event_mean_min, cfg.detect.event_mean_max

    # per-read tables so the window chain below runs in O(1) per step:
    # undefined-base prefix sums (replaces defined[a:b].all()), breakpoint
    # positions (replaces the per-window model-mean gap scan of
    # alignment.cpp:578-593), and guard-passing prefix sums over the pair
    # stream (replaces per-window mean-range filtering)
    undef_cum = np.concatenate(([0], np.cumsum(~st.defined)))
    m = st.mean_ref
    gap = np.abs(np.diff(m))                       # gap[i] = |m[i]-m[i+1]|
    bp = np.zeros(m.shape[0], dtype=bool)
    if m.shape[0] >= 3:
        bp[1:-1] = (gap[1:] > 0.75) & (gap[:-1] > 0.75)
    bp_pos = np.flatnonzero(bp)
    guard_ok = (ev_mean[pairs[:, 0]] > dmin) & (ev_mean[pairs[:, 0]] < dmax)
    guard_cum = np.concatenate(([0], np.cumsum(guard_ok)))
    pair_q = pairs[:, 1]
    # both lookup streams are monotone, so one vectorised searchsorted per
    # read replaces two per window: j_at[i] = first pair with query >= r2q[i],
    # next_bp[i] = first breakpoint position >= i
    j_at = np.searchsorted(pair_q, r2q[: ref_len + 1], side="left")
    next_bp = np.searchsorted(bp_pos, np.arange(m.shape[0] + total_wl + 1))

    # the chain of window starts is inherently sequential (each advance
    # depends on the previous window's length), but every step is a couple
    # of scalar lookups — GIL-released C++ when available, python otherwise
    from .. import native
    if native.available():
        ri_a, wl_a, j0_a, j1_a = native.window_chain(
            undef_cum, bp_pos, next_bp, j_at, guard_cum, ref_len, k,
            total_wl)
        if ri_a.shape[0] == 0:
            return None
    else:
        metas: list[tuple[int, int, int, int]] = []
        ri = 0
        while ri < n_kmer_max:
            bases_to_end = ref_len - ri
            wl = min(bases_to_end, total_wl)
            if bases_to_end > 1.5 * total_wl:
                snip_len = int(1.5 * wl)
                if undef_cum[ri + snip_len] - undef_cum[ri]:
                    ri += wl
                    continue
                limit = int(1.5 * wl - k - 1)
                bi = next_bp[ri + wl]
                if bi < bp_pos.shape[0] and bp_pos[bi] < ri + limit:
                    wl = int(bp_pos[bi]) - ri + k
            if undef_cum[ri + wl] - undef_cum[ri]:
                ri += wl
                continue
            j0 = j_at[ri]
            j1 = j_at[ri + wl - k + 1]
            if j1 <= j0 or guard_cum[j1] - guard_cum[j0] < 2:
                ri += wl
                continue
            metas.append((ri, wl, int(j0), int(j1)))
            ri += wl - k + 1
        if not metas:
            return None
        m = np.asarray(metas, dtype=np.int64)
        ri_a, wl_a, j0_a, j1_a = m[:, 0], m[:, 1], m[:, 2], m[:, 3]

    # windows view into the read's guarded event/observation streams (the
    # per-window [j0, j1) pair spans map to contiguous [g0, g1) spans of the
    # guard-filtered stream), so no per-window copies are made.  The
    # observation VALUES are built lazily: the resident-obs path derives
    # them on device from prep's fill input (run_eventalign), the fallback
    # computes them host-side (_host_obs).
    g_ev = pairs[guard_ok, 0]

    g0 = guard_cum[j0_a]
    g1 = np.minimum(guard_cum[j1_a], g0 + t_cap)
    ns = wl_a - k + 1
    query_span = r2q[ri_a + ns] - r2q[ri_a]
    indel = query_span - ns
    if p.record.is_reverse:
        ref_coord = p.record.ref_end - ri_a - k // 2
    else:
        ref_coord = p.record.ref_start + ri_a + k // 2
    return _WindowSet(ri_a, ns, g0, g1, ref_coord, indel, g_ev)


def _process_window(w: _Window, path_code: np.ndarray, n_states_w: int,
                    cfg: SubstrateConfig, collect_text: bool,
                    calls: Optional[dict] = None,
                    update_cursor: bool = True) -> None:
    """Apply one window's Viterbi path (alignment.cpp:654-740): accumulate
    aligned positions (+ optional text) and advance the read cursors."""
    path_kind, path_pos = vit.decode_path(path_code, n_states_w)
    path_pos = path_pos.astype(np.int64)
    st = w.state
    p = st.p
    k = cfg.kmer_len
    ri = w.ref_index
    S = path_kind.shape[0]
    if S == 0:
        if update_cursor:
            st.read_head = w.first_inrange + 1
            st.reference_index = ri + 1
        return

    non_d = path_kind != vit.KIND_D
    ev_idx = np.cumsum(non_d) - 1  # evIdx per step (valid where non_d)
    is_m = path_kind == vit.KIND_M
    if is_m.any():
        last_m_step = np.nonzero(is_m)[0][-1]
        last_m_ev = int(ev_idx[last_m_step])
        last_m_ref = int(path_pos[last_m_step])
    else:
        last_m_ev = 0
        last_m_ref = 0

    raw = p.record.raw
    rs, re_ = p.event_raw_start, p.event_raw_end

    m_steps = np.nonzero(is_m)[0]
    if m_steps.shape[0]:
        m_pos = path_pos[m_steps].astype(np.int64)
        m_ev = w.event_ids[ev_idx[m_steps]]
        counts = (re_[m_ev] - rs[m_ev] + 1).astype(np.int64)
        # explode raw sample indices per M step
        sample_idx = np.repeat(rs[m_ev], counts) + _ranges(counts)
        scaled = ((raw[sample_idx] - p.shift) / p.scale).astype(np.float32)
        if p.record.is_reverse:
            coords = w.reference_coord - m_pos - 1
        else:
            coords = w.reference_coord + m_pos
        ref_idx_arr = ri + m_pos + k // 2
        query_idx_arr = p.record.ref_to_query[ref_idx_arr]
        kmer_start = ri + m_pos

        skip_coords = None
        if calls is not None and calls:
            skip_coords = np.array([c in calls for c in coords])
        # group stay-repeated positions: consecutive equal coords
        boundaries = np.nonzero(np.diff(m_pos, prepend=m_pos[0] - 1))[0]
        seg_counts = np.diff(np.append(boundaries, m_pos.shape[0]))
        sample_off = np.concatenate([[0], np.cumsum(counts)])
        for si, seg0 in enumerate(boundaries):
            if skip_coords is not None and skip_coords[seg0]:
                continue  # trainCNN second pass prints calls instead
            nseg = seg_counts[si]
            s0 = sample_off[seg0]
            s1 = sample_off[seg0 + nseg]
            sig = scaled[s0:s1]
            acc = st.acc
            acc["coord"].append(int(coords[seg0]))
            acc["kmer_start"].append(int(kmer_start[seg0]))
            acc["query_idx"].append(int(query_idx_arr[seg0]))
            acc["ref_idx"].append(int(ref_idx_arr[seg0]))
            acc["core"].append(int(st.core_rank[kmer_start[seg0]]))
            acc["res"].append(int(st.res_rank[kmer_start[seg0]]))
            padded = np.zeros(RAWDEPTH, dtype=np.float32)
            padded[: min(sig.shape[0], RAWDEPTH)] = sig[:RAWDEPTH]
            acc["sig"].append(padded)
            acc["nsig"].append(sig.shape[0])
            acc["centerT"].append(bool(st.ref_codes[kmer_start[seg0] + k // 2] == 1))
            acc["indel"].append(w.indel_score)

        if collect_text:
            _emit_text(w, path_kind, path_pos, ev_idx, last_m_ev, scaled,
                       sample_off, m_steps, coords, cfg, calls)

    if update_cursor:
        st.read_head = w.first_inrange + last_m_ev + 1
        st.reference_index = ri + last_m_ref + 1


def _advance_cursor(w: _Window, path_code: np.ndarray, n_states_w: int,
                    cfg: SubstrateConfig) -> None:
    """Strict mode: advance the read cursors from one window's path without
    materialising positions (the heavy part is deferred to the batched
    post-processing).  Mirrors _process_window's cursor rule exactly
    (reference: alignment.cpp:738-740)."""
    st = w.state
    path_kind, path_pos = vit.decode_path(path_code, n_states_w)
    if path_kind.shape[0] == 0:
        st.read_head = w.first_inrange + 1
        st.reference_index = w.ref_index + 1
        return
    is_m = path_kind == vit.KIND_M
    m_steps = np.nonzero(is_m)[0]
    if m_steps.shape[0]:
        last = m_steps[-1]
        non_d = path_kind != vit.KIND_D
        last_m_ev = int(np.cumsum(non_d)[last] - 1)
        last_m_ref = int(path_pos[last])
    else:
        last_m_ev = 0
        last_m_ref = 0
    st.read_head = w.first_inrange + last_m_ev + 1
    st.reference_index = w.ref_index + last_m_ref + 1


def _window_set_from_windows(windows: list[_Window],
                             cfg: SubstrateConfig) -> _WindowSet:
    """Array-form _WindowSet over an explicit (committed, in-order) window
    list, so strict mode can reuse the batched fast-mode post-processing.
    Each window's guarded event ids are concatenated into the set's stream
    (windows may overlap in events; spans are self-contained)."""
    k = cfg.kmer_len
    n = len(windows)
    ri = np.fromiter((w.ref_index for w in windows), np.int64, n)
    ns = np.fromiter((w.window_length - k + 1 for w in windows), np.int64, n)
    lens = np.fromiter((w.event_ids.shape[0] for w in windows), np.int64, n)
    g1 = np.cumsum(lens)
    g0 = g1 - lens
    rc = np.fromiter((w.reference_coord for w in windows), np.int64, n)
    indel = np.fromiter((w.indel_score for w in windows), np.int64, n)
    g_ev = (np.concatenate([w.event_ids for w in windows]) if n
            else np.empty(0, np.int64))
    return _WindowSet(ri, ns, g0, g1, rc, indel, g_ev)


def _merge_sig_stores(stores: list[tuple]) -> tuple:
    """Concatenate several (scaled, seg_start, seg_nsig) stores into one
    (offsets rebased into the merged scaled stream)."""
    scaled = np.concatenate([s[0] for s in stores])
    offs = np.cumsum([0] + [s[0].shape[0] for s in stores[:-1]])
    starts = np.concatenate([s[1] + o for s, o in zip(stores, offs)])
    nsig = np.concatenate([s[2] for s in stores])
    return scaled, starts, nsig


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for counts ci."""
    total = int(counts.sum())
    out = np.arange(total)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return out - np.repeat(starts, counts)


def _emit_text(w, path_kind, path_pos, ev_idx, last_m_ev, scaled_m,
               sample_off, m_steps, m_coords, cfg, calls):
    """Human-readable eventalign rows (alignment.cpp:701-733).

    Columns: refCoord, kmerRef, scaledSample, kmerStrand, modelMean
    [, EdU, BrdU when calls exist]; insertions print N-kmers with mean 0.
    """
    st = w.state
    p = st.p
    k = cfg.kmer_len
    ri = w.ref_index
    seq = p.record.reference_seq
    parts = st.text_parts
    m_counter = 0
    from ..utils.seqtools import reverse_complement
    for step in range(path_kind.shape[0]):
        kind = path_kind[step]
        if kind == vit.KIND_D:
            continue
        pos = int(path_pos[step])
        ev = int(ev_idx[step])
        kmer_strand = seq[ri + pos : ri + pos + k]
        if p.record.is_reverse:
            coord = w.reference_coord - pos - 1
            kmer_ref = reverse_complement(kmer_strand)
        else:
            coord = w.reference_coord + pos
            kmer_ref = kmer_strand
        if kind == vit.KIND_M:
            mmean = st.mean_ref[ri + pos]
            s0, s1 = sample_off[m_counter], sample_off[m_counter + 1]
            for v in scaled_m[s0:s1]:
                if calls is not None and coord in calls:
                    e, b = calls[coord]
                    parts.append(f"{coord}\t{kmer_ref}\t{v:.6f}\t{kmer_strand}"
                                 f"\t{mmean:.6f}\t{e:.6f}\t{b:.6f}\n")
                else:
                    parts.append(f"{coord}\t{kmer_ref}\t{v:.6f}\t{kmer_strand}"
                                 f"\t{mmean:.6f}\n")
            m_counter += 1
        elif kind == vit.KIND_I and ev < last_m_ev:
            # insertions after the last match are suppressed
            # (alignment.cpp:728); raw samples of the inserted event
            evg = w.event_ids[ev]
            rs, re_ = st.p.event_raw_start[evg], st.p.event_raw_end[evg]
            for idx in range(rs, re_ + 1):
                v = (st.p.record.raw[idx] - p.shift) / p.scale
                parts.append(f"{coord}\t{kmer_ref}\t{v:.6f}\t{'N' * k}\t0\n")


def _append_window_text(w: _Window, path_code: np.ndarray, n_states_w: int,
                        cfg: SubstrateConfig) -> None:
    """Vectorised text emission for one window (no-calls case): one output
    row per raw sample, arrays built with numpy and formatted in C
    (native.format_eventalign_rows) — byte-identical to _emit_text, which
    formatted per row in python (~60% of align's host profile)."""
    st = w.state
    p = st.p
    k = cfg.kmer_len
    ri = w.ref_index
    path_kind, path_pos = vit.decode_path(path_code, n_states_w)
    if path_kind.shape[0] == 0:
        return
    non_d = path_kind != vit.KIND_D
    ev_idx = np.cumsum(non_d) - 1
    is_m = path_kind == vit.KIND_M
    last_m_ev = int(ev_idx[np.nonzero(is_m)[0][-1]]) if is_m.any() else 0
    # insertions after the last match are suppressed (alignment.cpp:728)
    is_i = (path_kind == vit.KIND_I) & (ev_idx < last_m_ev)
    steps = np.nonzero(is_m | is_i)[0]
    if steps.shape[0] == 0:
        return
    e_g = w.event_ids[ev_idx[steps]]
    rs, re_ = p.event_raw_start, p.event_raw_end
    counts = (re_[e_g] - rs[e_g] + 1).astype(np.int64)
    sample_idx = np.repeat(rs[e_g], counts) + _ranges(counts)
    vals = (p.record.raw[sample_idx] - p.shift) / p.scale
    pos = path_pos[steps].astype(np.int64)
    if p.record.is_reverse:
        coords = w.reference_coord - pos - 1
    else:
        coords = w.reference_coord + pos
    kstarts = ri + pos
    ins_step = is_i[steps]
    row_coord = np.repeat(coords, counts)
    row_kstart = np.repeat(kstarts, counts)
    row_ins = np.repeat(ins_step, counts)
    row_mmean = np.repeat(np.asarray(st.mean_ref[kstarts], np.float64),
                          counts)
    # M rows print the f32-cast scaled value, insertion rows the unrounded
    # one — exactly the two dtypes _emit_text's branches produced
    row_val = np.where(row_ins, vals.astype(np.float64),
                       vals.astype(np.float32).astype(np.float64))
    from .. import native
    if native.available():
        st.text_parts.append(native.format_eventalign_rows(
            row_coord, row_kstart, row_ins.astype(np.uint8), row_val,
            row_mmean, p.record.reference_seq, k, p.record.is_reverse))
        return
    from ..utils.seqtools import reverse_complement
    seq = p.record.reference_seq
    out = []
    for c, ks, ins, v, mm in zip(row_coord.tolist(), row_kstart.tolist(),
                                 row_ins.tolist(), row_val.tolist(),
                                 row_mmean.tolist()):
        kmer_strand = seq[ks : ks + k]
        kmer_ref = (reverse_complement(kmer_strand)
                    if p.record.is_reverse else kmer_strand)
        if ins:
            out.append(f"{c}\t{kmer_ref}\t{v:.6f}\t{'N' * k}\t0\n")
        else:
            out.append(f"{c}\t{kmer_ref}\t{v:.6f}\t{kmer_strand}"
                       f"\t{mm:.6f}\n")
    st.text_parts.append("".join(out))


def _process_read_windows_batched(st: _ReadState, ws: _WindowSet,
                                  paths: list[tuple[np.ndarray, np.ndarray]],
                                  cfg: SubstrateConfig) -> None:
    """Vectorised fast-mode post-processing of ALL of a read's windows at
    once (no per-window Python) — produces the same AlignedPositions content
    as repeated _process_window(update_cursor=False) calls without text or
    calls handling.  Prefers the native C++ twin (GIL-released, so pipeline
    threads overlap on the 2-core host); numpy fallback below is the
    equivalence oracle."""
    p = st.p
    k = cfg.kmer_len
    n_win = ws.ri.shape[0]
    if not n_win:
        return
    from .. import native
    if native.available():
        from ..models.cnn import RAWDEPTH as RD, SIG_QUANT_LO, SIG_QUANT_SCALE
        (coord, kmer_start, query_idx, ref_idx, core, res, nsig, centerT,
         indel_out, sig_flat, sig_store) = native.process_read_windows(
            np.concatenate([pc for pc, _ in paths]),
            np.fromiter((pc.shape[0] for pc, _ in paths), np.int64,
                        len(paths)),
            np.fromiter((ns for _, ns in paths), np.int64, len(paths)),
            ws.g_ev, ws.g0, ws.ri, ws.ref_coord, ws.indel,
            p.record.is_reverse, k, p.event_raw_start, p.event_raw_end,
            p.record.raw, p.shift, p.scale, p.record.ref_to_query,
            st.core_rank, st.res_rank, st.ref_codes,
            SIG_QUANT_LO, SIG_QUANT_SCALE, RD)
        if coord.shape[0] == 0:
            return
        acc = st.acc
        acc["coord"].append(coord)
        acc["kmer_start"].append(kmer_start)
        acc["query_idx"].append(query_idx)
        acc["ref_idx"].append(ref_idx)
        acc["core"].append(core)
        acc["res"].append(res)
        acc["sigflat"].append(sig_flat)
        acc["sigstore"].append(sig_store)
        acc["nsig"].append(nsig)
        acc["centerT"].append(centerT)
        acc["indel"].append(indel_out)
        return
    codes = np.concatenate([pc for pc, _ in paths])
    kinds = (codes & 3).astype(np.uint8)
    # positions: per-window suffix-anchored delta sums, vectorised globally
    steps_per = np.array([pc.shape[0] for pc, _ in paths])
    ns_per = np.array([ns for _, ns in paths], dtype=np.int64)
    deltas = ((codes >> 2) & 1).astype(np.int64)
    csum = np.cumsum(deltas)
    ends = np.cumsum(steps_per) - 1
    total_w = csum[ends] - np.concatenate([[0], csum[ends[:-1]]])
    local_csum = csum - np.repeat(np.concatenate([[0], csum[ends[:-1]]]),
                                  steps_per)
    poss = (np.repeat(ns_per - 1, steps_per)
            - (np.repeat(total_w, steps_per) - local_csum))
    win_id = np.repeat(np.arange(n_win), steps_per)
    step_off = np.concatenate([[0], np.cumsum(steps_per)[:-1]])

    non_d = kinds != vit.KIND_D
    # per-window running event index (evIdx): global cumsum minus the
    # cumulative count at each window start
    cum = np.cumsum(non_d)
    base = np.concatenate([[0], cum])[step_off]
    ev_local = cum - 1 - np.repeat(base, steps_per)

    is_m = kinds == vit.KIND_M
    if not is_m.any():
        return
    m_sel = np.nonzero(is_m)[0]
    m_win = win_id[m_sel]
    m_pos = poss[m_sel]
    # map local event index -> global event id: windows view spans
    # [g0, g1) of the read's guarded stream
    m_ev = ws.g_ev[ws.g0[m_win] + ev_local[m_sel]]

    ri_arr = ws.ri
    rc_arr = ws.ref_coord
    indel_arr = ws.indel
    if p.record.is_reverse:
        coords = rc_arr[m_win] - m_pos - 1
    else:
        coords = rc_arr[m_win] + m_pos
    kmer_start = ri_arr[m_win] + m_pos
    ref_idx = kmer_start + k // 2
    query_idx = p.record.ref_to_query[ref_idx]

    # group consecutive M steps at the same (window, pos): stay chains
    key = m_win * (1 << 32) + m_pos
    new_seg = np.diff(key, prepend=key[0] - 1) != 0
    seg_first = np.nonzero(new_seg)[0]

    # explode raw samples per M step; the CNN's flat u8 stream is built
    # directly (first RAWDEPTH samples per segment), skipping the (P, 20)
    # f32 matrix which is only materialised on demand (AlignedPositions.signal)
    rs, re_ = p.event_raw_start, p.event_raw_end
    counts = (re_[m_ev] - rs[m_ev] + 1).astype(np.int64)
    sample_off = np.concatenate([[0], np.cumsum(counts)])
    sample_idx = np.repeat(rs[m_ev], counts) + _ranges(counts)
    scaled = ((p.record.raw[sample_idx] - p.shift) / p.scale
              ).astype(np.float32)
    seg_sample_start = sample_off[seg_first]
    seg_sample_end = np.append(sample_off[seg_first[1:]],
                               sample_off[-1])
    seg_nsig = seg_sample_end - seg_sample_start
    from ..models.cnn import (RAWDEPTH as RD, SIG_QUANT_LO, SIG_QUANT_SCALE)
    lens = np.minimum(seg_nsig, RD)
    fidx = np.repeat(seg_sample_start, lens) + _ranges(lens)
    taken = scaled[fidx]
    sig_flat = np.clip(np.rint((taken - SIG_QUANT_LO) * SIG_QUANT_SCALE)
                       + 1.0, 1.0, 255.0).astype(np.uint8)

    acc = st.acc
    acc["coord"].append(coords[seg_first])
    acc["kmer_start"].append(kmer_start[seg_first])
    acc["query_idx"].append(query_idx[seg_first])
    acc["ref_idx"].append(ref_idx[seg_first])
    acc["core"].append(st.core_rank[kmer_start[seg_first]])
    acc["res"].append(st.res_rank[kmer_start[seg_first]])
    acc["sigflat"].append(sig_flat)
    acc["sigstore"].append((scaled, seg_sample_start, seg_nsig))
    acc["nsig"].append(seg_nsig)
    acc["centerT"].append(st.ref_codes[kmer_start[seg_first] + k // 2] == 1)
    acc["indel"].append(indel_arr[m_win[seg_first]])


HMM_KEY = ("external_D2D", "external_D2M", "external_I2M", "external_M2D",
           "internal_M2I", "internal_I2I")


_MODEL_TABLE_CACHE: dict[int, object] = {}


def _device_model_table(models: PoreModelSet):
    """Upload the pore-model table once per process; jax reuses the resident
    array across viterbi calls."""
    key = (id(models.pore_model), id(compute.get_compute_mesh()))
    t = _MODEL_TABLE_CACHE.get(key)
    if t is None:
        t = compute.put_rep(models.pore_model.astype(np.float32))
        _MODEL_TABLE_CACHE.clear()
        _MODEL_TABLE_CACHE[key] = t
    return t


def _viterbi_windows_dispatch(windows: list[_Window], models: PoreModelSet,
                              cfg: SubstrateConfig, hmm_probs,
                              n_state_pad: int, t_buckets,
                              obs_dtype=np.float16):
    """Build and enqueue one batched Viterbi call; returns an opaque handle
    for :func:`_viterbi_windows_collect`.  Splitting dispatch from collection
    lets callers queue several chunks on the device before blocking on any
    download.  Emission coefficients are gathered on device from the
    resident pore-model table, so only the rank matrix is uploaded."""
    W = 8
    while W < len(windows):
        W *= 2
    # at least the smallest bucket (8 windows) on every device of a mesh
    W = compute.pad_rows(max(W, 8 * compute.data_axis_size()))
    n = len(windows)
    obs_list = [w.obs_scaled for w in windows]
    lens = np.fromiter((o.shape[0] for o in obs_list), np.int64, n)
    T = next(b for b in t_buckets if b >= int(lens.max()))
    ns_max = max(w.window_length - cfg.kmer_len + 1 for w in windows)
    # same 48-state bucket as the fast path: plain 50 bp windows carry <=42
    # states; only breakpoint-extended windows need the full plane
    N = min(48, n_state_pad) if ns_max <= 48 else n_state_pad
    # scatter-fill the padded batch in a few vectorised ops (a python loop
    # here costs more than the device call for thousands of windows)
    # f16 halves the largest upload; the kernel computes in f32 (strict
    # parity mode keeps f32 end to end)
    obs = np.zeros((W, T), dtype=obs_dtype)
    rows = np.repeat(np.arange(n), lens)
    obs[rows, _ranges(lens)] = np.concatenate(obs_list)
    n_obs = np.zeros(W, dtype=np.int32)
    n_obs[:n] = lens
    ns_arr = np.fromiter((w.window_length - cfg.kmer_len + 1
                          for w in windows), np.int64, n)
    rk = np.full((W, N), -1, dtype=np.int32)
    rank_slices = []
    for w, ns in zip(windows, ns_arr):
        r = w.state.p.kmer_ranks_ref[w.ref_index : w.ref_index + ns]
        rank_slices.append(r)
    rrows = np.repeat(np.arange(n), ns_arr)
    rvals = np.concatenate(rank_slices)
    rk[rrows, _ranges(ns_arr)] = np.where(rvals < 0, 0, rvals)
    n_states = np.ones(W, dtype=np.int32)
    n_states[:n] = ns_arr
    epb = np.ones(W, dtype=np.float32)
    epb[:n] = np.fromiter((w.state.p.events_per_base for w in windows),
                          np.float64, n)
    flat = windows[0].state.p.flat_ranks_device
    mesh = compute.get_compute_mesh()
    if flat is not None and all(w.state.p.flat_ranks_device is flat
                                for w in windows):
        starts = np.zeros(W, dtype=np.int32)
        starts[:n] = np.fromiter(
            (w.state.p.flat_ranks_offset + w.ref_index for w in windows),
            np.int64, n)
        if mesh is not None:
            # shard_map runs each device's fill on its window shard
            pc, pl, _score = vit.viterbi_from_flat_ranks_sharded(
                mesh, compute.put_rows(obs), compute.put_rows(n_obs),
                compute.put_rows(starts), flat,
                _device_model_table(models), compute.put_rows(n_states),
                compute.put_rows(epb), hmm_probs, N)
        else:
            pc, pl, _score = vit.viterbi_from_flat_ranks_jit(
                compute.put_rows(obs), compute.put_rows(n_obs),
                compute.put_rows(starts), flat,
                _device_model_table(models), compute.put_rows(n_states),
                compute.put_rows(epb), hmm_probs, N)
    elif mesh is not None:
        pc, pl, _score = vit.viterbi_from_ranks_sharded(
            mesh, compute.put_rows(obs), compute.put_rows(n_obs),
            compute.put_rows(rk),
            _device_model_table(models), compute.put_rows(n_states),
            compute.put_rows(epb), hmm_probs)
    else:
        pc, pl, _score = vit.viterbi_from_ranks_jit(
            compute.put_rows(obs), compute.put_rows(n_obs),
            compute.put_rows(rk),
            _device_model_table(models), compute.put_rows(n_states),
            compute.put_rows(epb), hmm_probs)
    _enqueue_d2h(pc, pl)
    return pc, pl, ns_arr, len(windows)


def _bucket_up(n: int, step: int) -> int:
    return max(step, ((n + step - 1) // step) * step)


def _enqueue_d2h(*arrays) -> None:
    """Start device->host copies without blocking.  Sequential blocking
    downloads each pay a round-trip latency; async copies overlap each other
    and the remaining device work, so enqueueing every stage output at
    dispatch time and gathering late collapses N latencies into ~one."""
    compute.count_d2h(*arrays)
    for a in arrays:
        try:
            a.copy_to_host_async()
        except AttributeError:
            pass


def _viterbi_dispatch_flat_arrays(lens: np.ndarray, ostarts: np.ndarray,
                                  rstarts: np.ndarray, ns: np.ndarray,
                                  epb: np.ndarray, obs_flat_dev,
                                  ranks_flat_dev, models,
                                  cfg: SubstrateConfig, hmm_probs,
                                  n_state_pad: int, t_buckets):
    """Array-form fast-mode dispatch (no per-window Python objects): a chunk
    ships three i32 offset/length vectors + per-window state counts and
    events-per-base."""
    n = lens.shape[0]
    # W buckets: powers of two to a granularity floor, then multiples of it —
    # the fill cost and the path-code download scale with W, so coarse pow2
    # buckets waste padding, but finer buckets mean more distinct executables
    # (and executable switches are not free); 2048 is the default, not yet
    # tuned on the GPU
    import os as _os
    _gran = int(_os.environ.get("DNASCENT_VIT_W_GRAN", "2048"))
    W = 8
    while W < n and W < _gran:
        W *= 2
    if n > _gran:
        W = -(-n // _gran) * _gran
    # at least the smallest bucket (8 windows) on every device of a mesh
    W = compute.pad_rows(max(W, 8 * compute.data_axis_size()))
    T = next(b for b in t_buckets if b >= int(lens.max()))
    # backtrace scan length from the chunk's TRUE maxima (bucketed to 64 to
    # bound compile variants) instead of the padded T+N+2 — the backtrace
    # is ~45% of viterbi device time and linear in scan length
    bt_len = -(-(int(lens.max()) + int(ns.max()) + 2) // 64) * 64
    n_obs = np.zeros(W, dtype=np.int32)
    n_obs[:n] = lens
    ostarts_p = np.zeros(W, dtype=np.int32)
    ostarts_p[:n] = ostarts
    rstarts_p = np.zeros(W, dtype=np.int32)
    rstarts_p[:n] = rstarts
    n_states = np.ones(W, dtype=np.int32)
    n_states[:n] = ns
    epb_p = np.ones(W, dtype=np.float32)
    epb_p[:n] = epb
    mesh = compute.get_compute_mesh()
    if mesh is not None:
        # shard_map runs each device's fill on its window shard
        pc, pl, _score = vit.viterbi_from_flat_sharded(
            mesh, obs_flat_dev, compute.put_rows(ostarts_p),
            compute.put_rows(n_obs), compute.put_rows(rstarts_p),
            ranks_flat_dev, _device_model_table(models),
            compute.put_rows(n_states), compute.put_rows(epb_p), hmm_probs,
            n_state_pad, T, bt_len)
        _enqueue_d2h(pc, pl)
        return pc, pl, ns, n
    if _os.environ.get("DNASCENT_COMPACT_PC", "1") != "0":
        # compacted path-code download: the padded (W, bt_len) layout ships
        # ~4x its true content (window-axis bucket padding + chunk-max
        # backtrace length); scattering every window's codes at
        # cumsum(n_obs + n_states + 2) bound offsets on device cuts the
        # pipeline's largest d2h stream to sum-of-bounds, and the bounds
        # are host-known so no length vector needs downloading
        bound = (n_obs + n_states + 2).astype(np.int64)
        sb = int(bound.sum())
        sb_b = -(-sb // (1 << 13)) * (1 << 13)
        stream, _pl, _score = vit.viterbi_from_flat_compact_jit(
            obs_flat_dev, compute.put_rows(ostarts_p), compute.put_rows(n_obs),
            compute.put_rows(rstarts_p), ranks_flat_dev,
            _device_model_table(models), compute.put_rows(n_states),
            compute.put_rows(epb_p), hmm_probs, n_state_pad, T, bt_len, sb_b)
        _enqueue_d2h(stream)
        offs = np.concatenate([[0], np.cumsum(bound)])
        return ("compact", stream, offs, ns, n)
    pc, pl, _score = vit.viterbi_from_flat_jit(
        obs_flat_dev, compute.put_rows(ostarts_p), compute.put_rows(n_obs),
        compute.put_rows(rstarts_p), ranks_flat_dev,
        _device_model_table(models), compute.put_rows(n_states),
        compute.put_rows(epb_p), hmm_probs, n_state_pad, T, bt_len)
    _enqueue_d2h(pc, pl)
    return pc, pl, ns, n


def _host_obs(st: _ReadState, ws: _WindowSet) -> np.ndarray:
    """Host-side observation stream for one read (fallback when the
    device-resident rebuild is unavailable)."""
    p = st.p
    return ((p.event_mean[ws.g_ev] - p.shift) / p.scale).astype(np.float16)


def _materialize_windows(st: _ReadState, ws: _WindowSet,
                         cfg: SubstrateConfig) -> list[_Window]:
    """_Window objects from a _WindowSet — only for the text/calls path
    (align, trainCNN), where per-window processing is unavoidable anyway."""
    k = cfg.kmer_len
    if st.g_obs is None:
        st.g_obs = _host_obs(st, ws)
    out = []
    for i in range(ws.ri.shape[0]):
        g0, g1 = int(ws.g0[i]), int(ws.g1[i])
        out.append(_Window(st, int(ws.ri[i]), int(ws.ns[i]) + k - 1,
                           st.g_obs[g0:g1], ws.g_ev[g0:g1], 0,
                           int(ws.indel[i]), int(ws.ref_coord[i]),
                           flat_local=g0))
    return out


import functools as _functools
import jax as _jax


@_functools.partial(_jax.jit)
def _obs_build_jit(groups, d_flat_u8, read_starts, src_base, a, b):
    """Rebuild the batch's flat f16 observation stream ON DEVICE from prep's
    resident fill inputs.

    The fill input row of read r holds its quantile-scaled event means;
    the Viterbi observations are the same means under the Theil-Sen-refined
    scaling — an affine map per read.  A window's observation stream is the
    guard-filtered event-id walk ``g_ev`` (monotone, deltas almost always
    0/1), so the call ships one u8 delta stream + per-read scalars instead
    of re-uploading the f16 values (~half the bytes, zero host float work).

    groups: tuple of resident (B_g, E_g) fill arrays (first-seen order);
    d_flat_u8: concatenated per-read g_ev increments (first element of each
    read's span is 0); read_starts: (Bp,) i32 span starts (padded tail =
    total length); src_base: (Bp,) i32 flat index of each read's g_ev[0]
    (group base + row*E_g + g_ev[0]); a, b: per-read affine coefficients.
    """
    ev_flat = jnp.concatenate(
        [g.reshape(-1).astype(jnp.float32) for g in groups])
    d = d_flat_u8.astype(jnp.int32)
    cs = jnp.cumsum(d)
    j = jnp.arange(d.shape[0], dtype=jnp.int32)
    rid = jnp.clip(jnp.searchsorted(read_starts, j, side="right") - 1,
                   0, read_starts.shape[0] - 1)
    first_cs = cs[jnp.clip(read_starts[rid], 0, d.shape[0] - 1)]
    idx = src_base[rid] + cs - first_cs
    vals = ev_flat[jnp.clip(idx, 0, ev_flat.shape[0] - 1)]
    return (vals * a[rid] + b[rid]).astype(jnp.float16)


@_functools.partial(_jax.jit)
def _obs_build_blockpacked_jit(groups, payload, widths, mins, read_starts,
                               src_base, a, b):
    """_obs_build_jit with the delta stream block-bit-packed
    (ops/blockpack.py): g_ev increments are almost all 1 with occasional
    0/2..6, so per-128-value blocks pack at ~2-3 bits instead of the nibble
    path's fixed 4 — and the same codec already ships the CNN signal."""
    from ..ops import blockpack as _bpk
    d_flat = _bpk.unpack_u8(payload, widths, mins,
                            widths.shape[0] * _bpk.BLOCK)
    return _obs_build_jit(groups, d_flat, read_starts, src_base, a, b)


@_functools.partial(_jax.jit)
def _obs_build_packed_jit(groups, d_packed, read_starts, src_base, a, b):
    """_obs_build_jit with the delta stream nibble-packed (two g_ev
    increments per byte).  Gaps between consecutive guard-kept events are
    bounded by the max_gap<=5 QC (event_handling.cpp:433-441), so deltas
    fit 4 bits for every QC-passing read; the caller falls back to the u8
    stream otherwise.  Halves the per-batch delta upload (~12 KB/read at
    10 kb)."""
    lo = (d_packed & 15).astype(jnp.uint8)
    hi = (d_packed >> 4).astype(jnp.uint8)
    d_flat = jnp.stack([lo, hi], axis=1).reshape(-1)
    return _obs_build_jit(groups, d_flat, read_starts, src_base, a, b)


def _viterbi_windows_collect(handle) -> list[tuple[np.ndarray, np.ndarray]]:
    """Block on a dispatched Viterbi chunk; returns (codes, n_states) per
    window in dispatch order."""
    if isinstance(handle[0], str):  # "compact" marker
        # flat bounded stream (see compact_path_codes): slice each window
        # at its host-computed bound offsets, then PAD-filter as usual
        _, stream, offs, ns_arr, n = handle
        codes = vit.unpack_path_codes(np.asarray(stream)[None, :])[0]
        return [(seg[(seg & 3) != vit.KIND_PAD], int(ns_arr[i]))
                for i in range(n)
                for seg in (codes[offs[i]: offs[i + 1]],)]
    pc, pl, ns_arr, n = handle
    pc = vit.unpack_path_codes(np.asarray(pc))
    # PAD-filter instead of tail-slice: the scan backtrace pads only at the
    # front and the compacted stream leaves PAD gaps between windows (real
    # codes never have kind==PAD); path_len is not needed host-side
    return [(pc[i][(pc[i] & 3) != vit.KIND_PAD], int(ns_arr[i]))
            for i in range(n)]


def _batch_flat_ranks(states: list["_ReadState"]):
    """Resident flat rank array for a batch: reuse prep's shared device
    array when every read points at the same one, else build + upload one
    per-call array of SAFE (N->0) ranks.  Sets ``st.rank_off`` on every
    state; window rank starts are then ``st.rank_off + ref_index``."""
    shared = states[0].p.flat_ranks_device if states else None
    uniform = shared is not None and all(
        st.p.flat_ranks_device is shared for st in states)
    if uniform:
        for st in states:
            st.rank_off = st.p.flat_ranks_offset
        return shared
    parts = []
    off = 0
    for st in states:
        safe = np.where(st.p.kmer_ranks_ref < 0, 0,
                        st.p.kmer_ranks_ref).astype(np.int32)
        st.rank_off = off
        parts.append(safe)
        off += safe.shape[0]
    rk_flat = np.zeros(_bucket_up(off, 1 << 16), dtype=np.int32)
    if parts:
        rk_flat[:off] = np.concatenate(parts)
    return compute.put_rep(rk_flat)


def _viterbi_windows(windows: list[_Window], models: PoreModelSet,
                     cfg: SubstrateConfig, hmm_probs, n_state_pad: int,
                     t_buckets,
                     obs_dtype=np.float16) -> list[tuple[np.ndarray, np.ndarray]]:
    """Dispatch + collect one batched Viterbi call (see the _dispatch and
    _collect halves)."""
    return _viterbi_windows_collect(_viterbi_windows_dispatch(
        windows, models, cfg, hmm_probs, n_state_pad, t_buckets, obs_dtype))


def run_eventalign(prepped: list[PreparedRead], models: PoreModelSet,
                   cfg: SubstrateConfig = DNA_R10, collect_text: bool = False,
                   calls_per_read: Optional[dict] = None,
                   n_state_pad: int = 72, strict: bool = False,
                   max_windows_per_batch: int = 8192
                   ) -> dict[str, EventalignResult]:
    """Drive eventalign for a batch of prepared reads.

    Fast mode (default): every window of every read is built up front and
    processed in a handful of large device batches (windows advance by their
    full k-mer span, so they are independent).  Strict mode reproduces the
    reference's sequential window coupling (``reference_index += lastM_ref +
    1``; alignment.cpp:738-740) via a wavefront over reads — one window per
    read per device round.

    Returns {read_id: EventalignResult}.  Reads that failed earlier stages
    come back with qc_passed=False and no positions.
    """
    hmm = cfg.hmm
    hmm_probs = tuple(getattr(hmm, k) for k in HMM_KEY)
    out: dict[str, EventalignResult] = {}
    states: list[_ReadState] = []
    for p in prepped:
        if not p.passed or p.event_alignment.shape[0] == 0:
            out[p.record.read_id] = EventalignResult(None, None, False)
            continue
        states.append(_build_state(p, models, cfg))

    # T buckets trade scan-length padding against kernel compiles (each
    # distinct (W, T) pair compiles once into the persistent cache)
    # finer low-end granularity: typical 50 bp windows carry ~100-190
    # observations, and the throughput-bound viterbi fill is linear in the
    # padded T — the 192 bucket alone cuts ~25% off the dominant population
    # (each bucket is one more cached executable)
    t_buckets = (128, 192, 256, 384, 512, 1024)
    t_cap = t_buckets[-1]

    def get_calls(w):
        if calls_per_read is None:
            return None
        return calls_per_read.get(w.state.p.record.read_id)

    if strict:
        # Speculative wavefront: the reference couples window n+1 to window
        # n's Viterbi result (reference_index += lastM_ref + 1, readHead +=
        # lastM_ev + 1; alignment.cpp:738-740), which would serialise one
        # tiny device call per window.  Instead each round dispatches a
        # chain of DNASCENT_STRICT_SPEC speculative windows per read built
        # under the fast-mode advance prediction (full k-mer span; the last
        # path step is almost always a match, so lastM_ref + 1 == span), and
        # commits a speculated window only when the true cursors prove it
        # identical to what the sequential loop would have built:
        #   * its start equals the live reference_index, and
        #   * the live read_head <= its first in-range pair (the window was
        #     built with a read_head lower bound, and j0 = max(searchsorted,
        #     read_head), so equality of the built window follows).
        # A mispredicted tail is discarded and rebuilt from the true cursor
        # next round — output is bit-identical to the sequential loop.
        import os as _os
        spec_depth = max(1, int(_os.environ.get("DNASCENT_STRICT_SPEC",
                                                "64")))
        k = cfg.kmer_len
        active = [s for s in states if not s.exhausted]
        # Upload-lean rounds (VERDICT r4 #7): every strict window is a
        # contiguous slice of its read's GUARDED pair stream (the
        # event-mean guard depends only on the event, so filtering commutes
        # with pair slicing).  Precompute the guarded streams, upload ONE
        # f32 batch-flat obs array, and each round ships only i32
        # offset/length vectors through the fast path's flat dispatcher —
        # the old path re-uploaded (W, T) f32 obs planes every round
        # (~375 KB/read over the wavefront at bench shapes, >2x the rest
        # of the pipeline's h2d combined).
        strict_flat_dev = None
        ranks_flat_dev = None
        if active and _os.environ.get("DNASCENT_STRICT_FLAT", "1") != "0":
            dmin = cfg.detect.event_mean_min
            dmax = cfg.detect.event_mean_max
            parts = []
            base = 0
            for st in active:
                pp = st.p
                pr = pp.event_alignment
                means_all = pp.event_mean[pr[:, 0]]
                guard = (means_all > dmin) & (means_all < dmax)
                st.strict_jg = np.concatenate(
                    [[0], np.cumsum(guard)]).astype(np.int64)
                st.strict_g_ev = pr[guard, 0]
                st.strict_gmeans = ((means_all[guard] - pp.shift) / pp.scale
                                    ).astype(np.float32)
                st.flat_obs_base = base
                parts.append(st.strict_gmeans)
                base += st.strict_gmeans.shape[0]
            obs_flat = np.zeros(_bucket_up(base, 1 << 17), np.float32)
            if parts:
                obs_flat[:base] = np.concatenate(parts)
            strict_flat_dev = compute.put_rep(obs_flat)
            ranks_flat_dev = _batch_flat_ranks(active)
        # committed windows + paths per read; the heavy position
        # materialisation runs ONCE per read at the end through the batched
        # (native) fast-mode post-processing — per-window work inside the
        # wavefront is only the cursor advance
        committed: dict[int, tuple[_ReadState, list, list]] = {}
        while True:
            chains: list[tuple[_ReadState, list[_Window]]] = []
            windows: list[_Window] = []
            for st in active:
                chain: list[_Window] = []
                ri = st.reference_index
                rh = st.read_head
                ref_len = len(st.p.record.reference_seq)
                for _ in range(min(st.spec, spec_depth)):
                    w = None
                    while ri < ref_len - k + 1:
                        w, skip = _window_at(st, ri, cfg, t_cap, rh)
                        if w is not None:
                            break
                        ri += skip
                    if w is None:
                        break
                    chain.append(w)
                    ri = w.ref_index + w.window_length - k + 1
                    rh = w.first_inrange
                if chain:
                    chains.append((st, chain))
                    windows.extend(chain)
                else:
                    st.exhausted = True
            if not windows:
                break
            if strict_flat_dev is not None:
                nw = len(windows)
                lens = np.fromiter((w.obs_scaled.shape[0] for w in windows),
                                   np.int64, nw)
                ostarts = np.fromiter(
                    (w.state.flat_obs_base + w.flat_local for w in windows),
                    np.int64, nw)
                rstarts = np.fromiter(
                    (w.state.rank_off + w.ref_index for w in windows),
                    np.int64, nw)
                ns_arr = np.fromiter(
                    (w.window_length - k + 1 for w in windows), np.int64, nw)
                epb = np.fromiter(
                    (w.state.p.events_per_base for w in windows),
                    np.float64, nw)
                ns_pad = (min(48, n_state_pad) if int(ns_arr.max()) <= 48
                          else n_state_pad)
                results = _viterbi_windows_collect(
                    _viterbi_dispatch_flat_arrays(
                        lens, ostarts, rstarts, ns_arr, epb,
                        strict_flat_dev, ranks_flat_dev, models, cfg,
                        hmm_probs, ns_pad, t_buckets))
            else:
                results = _viterbi_windows(windows, models, cfg, hmm_probs,
                                           n_state_pad, t_buckets,
                                           obs_dtype=np.float32)
            pos = 0
            for st, chain in chains:
                ok = True
                for w in chain:
                    codes, ns_w = results[pos]
                    pos += 1
                    if not ok:
                        continue
                    if (w.ref_index != st.reference_index
                            or st.read_head > w.first_inrange):
                        ok = False   # misprediction: rebuild from the
                        continue     # true cursor next round
                    _advance_cursor(w, codes, ns_w, cfg)
                    ent = committed.setdefault(id(st), (st, [], []))
                    ent[1].append(w)
                    ent[2].append((codes, ns_w))
                # adaptive depth: full-chain commits double the read's
                # speculation; a misprediction halves it, bounding the
                # wasted dispatch volume when the advance prediction is
                # off for this read's signal
                st.spec = (min(st.spec * 2, spec_depth) if ok
                           else max(4, st.spec // 2))
            active = [st for st, _ in chains if not st.exhausted]
        no_calls_strict = calls_per_read is None
        for st, wins, paths in committed.values():
            if no_calls_strict:
                _process_read_windows_batched(
                    st, _window_set_from_windows(wins, cfg), paths, cfg)
                if collect_text:
                    for w, (codes, ns_w) in zip(wins, paths):
                        _append_window_text(w, codes, ns_w, cfg)
            else:
                for w, (codes, ns_w) in zip(wins, paths):
                    _process_window(w, codes, ns_w, cfg, collect_text,
                                    get_calls(w), update_cursor=False)
    else:
        sets: list[tuple[_ReadState, _WindowSet, int, int]] = []
        n_windows = 0
        for st in states:
            ws = _build_window_set(st, cfg, t_cap)
            if ws is not None and ws.ri.shape[0]:
                sets.append((st, ws, n_windows, n_windows + ws.ri.shape[0]))
                n_windows += ws.ri.shape[0]

        # the batch's flat observation stream: preferably rebuilt ON DEVICE
        # from prep's resident fill inputs (ships u8 g_ev increments, half
        # the bytes of the f16 values and no host float work); host build +
        # f16 upload when a read lacks a resident array or an increment
        # overflows u8 (pathological guard-failure runs)
        import os as _os
        use_resident = (
            sets
            and _os.environ.get("DNASCENT_RESIDENT_OBS", "1") != "0"
            and all(st.p.events_dev is not None for st, ws, _, _ in sets))
        obs_flat_dev = None
        if use_resident:
            groups: list = []
            gbase: dict[int, int] = {}
            d_parts, src_base, a_aff, b_aff, starts = [], [], [], [], []
            base = 0
            for st, ws, w0, w1 in sets:
                p = st.p
                key = id(p.events_dev)
                if key not in gbase:
                    gbase[key] = sum(int(np.prod(g.shape)) for g in groups)
                    groups.append(p.events_dev)
                d = np.diff(ws.g_ev, prepend=ws.g_ev[:1])
                if d.shape[0] and int(d.max(initial=0)) > 255:
                    use_resident = False
                    break
                st.flat_obs_base = base
                starts.append(base)
                d_parts.append(d.astype(np.uint8))
                src_base.append(gbase[key]
                                + p.events_row * p.events_stride
                                + int(ws.g_ev[0]))
                a_aff.append(p.scale_q / p.scale)
                b_aff.append((p.shift_q - p.shift) / p.scale)
                base += ws.g_ev.shape[0]
            if use_resident:
                Bp = max(8, -(-len(starts) // 8) * 8)
                rs = np.full(Bp, base, dtype=np.int32)
                rs[: len(starts)] = starts
                sb = np.zeros(Bp, dtype=np.int32)
                sb[: len(src_base)] = src_base
                av = np.ones(Bp, dtype=np.float32)
                av[: len(a_aff)] = a_aff
                bv = np.zeros(Bp, dtype=np.float32)
                bv[: len(b_aff)] = b_aff
                d_flat = np.zeros(_bucket_up(base, 1 << 17), dtype=np.uint8)
                if d_parts:
                    d_flat[:base] = np.concatenate(d_parts)
                bpk_args = None
                if _os.environ.get("DNASCENT_PACK_SIG", "1") != "0":
                    from ..ops import blockpack as bpk
                    payload, widths, mins, n_pay = bpk.pack_u8_host(d_flat)
                    n_bucket = _bucket_up(n_pay, 1 << 14)
                    # only pay a dedicated executable when it beats the
                    # nibble path's bytes
                    if n_bucket < d_flat.shape[0] // 2:
                        pay = np.zeros(n_bucket, dtype=np.uint8)
                        pay[:n_pay] = payload[:n_pay]
                        bpk_args = (compute.put_rep(pay),
                                    compute.put_rep(widths),
                                    compute.put_rep(mins))
                if bpk_args is not None:
                    obs_flat_dev = _obs_build_blockpacked_jit(
                        tuple(groups), *bpk_args,
                        compute.put_rep(rs), compute.put_rep(sb),
                        compute.put_rep(av), compute.put_rep(bv))
                elif int(d_flat.max(initial=0)) <= 15:
                    # nibble-pack: two increments per byte (max_gap QC
                    # bounds deltas to 6, so this is the universal case)
                    d_packed = (d_flat[0::2] | (d_flat[1::2] << 4))
                    obs_flat_dev = _obs_build_packed_jit(
                        tuple(groups), compute.put_rep(d_packed),
                        compute.put_rep(rs), compute.put_rep(sb),
                        compute.put_rep(av), compute.put_rep(bv))
                else:
                    obs_flat_dev = _obs_build_jit(
                        tuple(groups), compute.put_rep(d_flat),
                        compute.put_rep(rs), compute.put_rep(sb),
                        compute.put_rep(av), compute.put_rep(bv))
        if obs_flat_dev is None:
            # fallback: host-built f16 stream, uploaded once
            obs_parts = []
            base = 0
            for st, ws, w0, w1 in sets:
                st.flat_obs_base = base
                st.g_obs = _host_obs(st, ws)
                obs_parts.append(st.g_obs)
                base += st.g_obs.shape[0]
            obs_flat = np.zeros(_bucket_up(base, 1 << 17), dtype=np.float16)
            if obs_parts:
                obs_flat[:base] = np.concatenate(obs_parts)
            obs_flat_dev = compute.put_rep(obs_flat)

        # rank side: reuse prep's resident flat array when the whole batch
        # shares it, else build one per call
        ranks_flat_dev = _batch_flat_ranks(states)

        # per-window global arrays — all vector ops, no per-window Python
        if sets:
            all_lens = np.concatenate([ws.g1 - ws.g0 for _, ws, _, _ in sets])
            all_ostarts = np.concatenate(
                [st.flat_obs_base + ws.g0 for st, ws, _, _ in sets])
            all_rstarts = np.concatenate(
                [st.rank_off + ws.ri for st, ws, _, _ in sets])
            all_ns = np.concatenate([ws.ns for _, ws, _, _ in sets])
            all_epb = np.concatenate(
                [np.full(ws.ri.shape[0], st.p.events_per_base)
                 for st, ws, _, _ in sets])
        else:
            all_lens = np.empty(0, np.int64)

        # group by T bucket so the scan length matches the windows (most
        # windows are ~half the smallest power-of-two bucket), then chunk;
        # per-read order is restored during processing
        results: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        wbucket = np.searchsorted(np.asarray(t_buckets), all_lens,
                                  side="left")
        # state-axis bucket: plain 50 bp windows have ns <= 42 (pad 48);
        # only breakpoint-extended windows (up to ~1.5x, ns <= 67) need the
        # full n_state_pad plane.  The viterbi fill is throughput-bound on
        # (N, W) vector planes, so the 48-pad bucket cuts a third of its
        # device time for the dominant window population
        ns_hi = (all_ns > 48).astype(np.int64) if all_lens.shape[0] else \
            np.empty(0, np.int64)
        gkey = wbucket * 2 + ns_hi
        # dispatch every chunk before collecting any: the device queue
        # overlaps chunk k's execution with chunk k+1's host batch build
        handles = []
        for bi in range(len(t_buckets)):
            for nsb, ns_pad in ((0, min(48, n_state_pad)), (1, n_state_pad)):
                order = np.flatnonzero(gkey == bi * 2 + nsb)
                for c0 in range(0, order.shape[0], max_windows_per_batch):
                    cid = order[c0 : c0 + max_windows_per_batch]
                    handles.append((cid, _viterbi_dispatch_flat_arrays(
                        all_lens[cid], all_ostarts[cid], all_rstarts[cid],
                        all_ns[cid], all_epb[cid], obs_flat_dev,
                        ranks_flat_dev, models, cfg, hmm_probs, ns_pad,
                        t_buckets)))
        for cid, h in handles:
            for wid, res in zip(cid, _viterbi_windows_collect(h)):
                results[wid] = res
        # batched position materialisation whenever no per-coord calls are
        # injected; text (align) rides the vectorised emitter on top —
        # the old per-window python path cost ~0.85 s/read at 10 kb
        no_calls = calls_per_read is None
        for st, ws, w0, w1 in sets:
            paths = [results[i] for i in range(w0, w1)]
            if no_calls:
                _process_read_windows_batched(st, ws, paths, cfg)
                if collect_text:
                    for w, (codes, ns_w) in zip(
                            _materialize_windows(st, ws, cfg), paths):
                        _append_window_text(w, codes, ns_w, cfg)
            else:
                for w, (codes, ns_w) in zip(
                        _materialize_windows(st, ws, cfg), paths):
                    _process_window(w, codes, ns_w, cfg,
                                    collect_text, get_calls(w),
                                    update_cursor=False)

    for st in states:
        rid = st.p.record.read_id
        acc = st.acc
        if not acc["coord"]:
            out[rid] = EventalignResult(None, None, False)
            continue
        def cat(xs, dtype):
            return np.concatenate([np.atleast_1d(np.asarray(x, dtype))
                                   for x in xs])

        n_signals = cat(acc["nsig"], np.int64)
        if acc["sigflat"]:
            # fast path: transfer-ready flat u8 stream + lazy f32 matrix;
            # a read's windows are processed in one batched call, so the
            # store holds exactly one (scaled, starts, nsig) tuple
            sig_kw = dict(
                signal_u8_flat=np.concatenate(acc["sigflat"]),
                signal_counts=np.minimum(n_signals, RAWDEPTH
                                         ).astype(np.uint8),
                _sig_store=(acc["sigstore"][0] if len(acc["sigstore"]) == 1
                            else _merge_sig_stores(acc["sigstore"])))
        else:
            sig_kw = dict(_signal=np.concatenate(
                [np.atleast_2d(np.asarray(s, np.float32))
                 for s in acc["sig"]]))
        pos = AlignedPositions(
            coord=cat(acc["coord"], np.int64),
            kmer_start=cat(acc["kmer_start"], np.int64),
            query_idx=cat(acc["query_idx"], np.int64),
            ref_idx=cat(acc["ref_idx"], np.int64),
            core_idx=cat(acc["core"], np.int64),
            residual_idx=cat(acc["res"], np.int64),
            n_signals=n_signals,
            center_is_T=cat(acc["centerT"], bool),
            indel_score=cat(acc["indel"], np.int64),
            **sig_kw,
        )
        header = (f">{rid} {st.p.record.contig} {st.p.record.ref_start} "
                  f"{st.p.record.ref_end} {st.p.record.strand}\n")
        text = header + "".join(st.text_parts) if collect_text else None
        out[rid] = EventalignResult(pos, text, True)
    return out
