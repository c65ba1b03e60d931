"""Pure-numpy oracle implementations of the DNAscent numeric kernels.

These mirror the reference C/C++ semantics exactly (including its quirks,
which are flagged inline) and serve three purposes:

1. the correctness oracle the JAX and CUDA kernels are tested against;
2. a host-side fallback for tiny inputs;
3. executable documentation of the algorithms with file:line citations.

Reference citations point into /root/reference (MBoemo/DNAscent v4.1.1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import (BandedAlignmentParams, EventDetectionParams,
                      HMMTransitionParams, ScalingParams, SubstrateConfig)

LOG_INV_SQRT_2PI = float(np.log(0.3989422804014327))  # event_handling.cpp:134


# ---------------------------------------------------------------------------
# Event detection (reference: src/scrappie/event_detection.c)
# ---------------------------------------------------------------------------

def compute_tstat(sums: np.ndarray, sumsqs: np.ndarray, d_length: int,
                  w_length: int) -> np.ndarray:
    """Windowed Student t-statistic (event_detection.c:60-115).

    ``sums``/``sumsqs`` are the length d_length+1 cumulative sums (element i
    excludes element i of the data).
    """
    tstat = np.zeros(d_length, dtype=np.float32)
    if d_length < 2 * w_length or w_length < 2:
        return tstat
    eta = np.float32(np.finfo(np.float32).tiny)
    w = float(w_length)
    i = np.arange(w_length, d_length - w_length + 1)
    sum1 = sums[i].copy()
    sumsq1 = sumsqs[i].copy()
    inner = i > w_length
    sum1[inner] -= sums[i[inner] - w_length]
    sumsq1[inner] -= sumsqs[i[inner] - w_length]
    sum2 = (sums[i + w_length] - sums[i]).astype(np.float32)
    sumsq2 = (sumsqs[i + w_length] - sumsqs[i]).astype(np.float32)
    mean1 = (sum1 / w).astype(np.float32)
    mean2 = sum2 / np.float32(w)
    combined_var = (sumsq1 / w).astype(np.float32) - mean1 * mean1 \
        + sumsq2 / np.float32(w) - mean2 * mean2
    combined_var = np.maximum(combined_var, eta)
    delta_mean = mean2 - mean1
    tstat[i] = np.abs(delta_mean) / np.sqrt(combined_var / np.float32(w))
    return tstat


def short_long_peak_detector(tstat1: np.ndarray, tstat2: np.ndarray,
                             params: EventDetectionParams) -> np.ndarray:
    """Two-detector peak FSM (event_detection.c:122-198).

    Returns the peak positions in emission order.  The short detector masks
    the long detector when it is about to fire.
    """
    n = tstat1.shape[0]
    peak_height = params.peak_height
    # per-detector state: [signal, threshold, window, masked_to, peak_pos,
    #                      peak_value, valid]
    sig = [tstat1, tstat2]
    thresh = [params.threshold1, params.threshold2]
    wlen = [params.window_length1, params.window_length2]
    masked_to = [0, 0]
    peak_pos = [-1, -1]
    peak_value = [np.finfo(np.float32).max, np.finfo(np.float32).max]
    valid = [False, False]
    DEF_PEAK_POS = -1
    DEF_PEAK_VAL = np.finfo(np.float32).max

    peaks = []
    for i in range(n):
        for k in (0, 1):
            if masked_to[k] >= i:
                continue
            current = sig[k][i]
            if peak_pos[k] == DEF_PEAK_POS:
                if current < peak_value[k]:
                    peak_value[k] = current
                elif current - peak_value[k] > peak_height:
                    peak_value[k] = current
                    peak_pos[k] = i
            else:
                if current > peak_value[k]:
                    peak_value[k] = current
                    peak_pos[k] = i
                if k == 0 and peak_value[0] > thresh[0]:
                    # short detector dominates: mask the long one
                    masked_to[1] = peak_pos[0] + wlen[0]
                    peak_pos[1] = DEF_PEAK_POS
                    peak_value[1] = DEF_PEAK_VAL
                    valid[1] = False
                if peak_value[k] - current > peak_height and peak_value[k] > thresh[k]:
                    valid[k] = True
                if valid[k] and (i - peak_pos[k]) > wlen[k] // 2:
                    peaks.append(peak_pos[k])
                    peak_pos[k] = DEF_PEAK_POS
                    peak_value[k] = current
                    valid[k] = False
    return np.asarray(peaks, dtype=np.int64)


@dataclass
class EventTable:
    """Raw event table (event_detection.c create_events)."""

    start: np.ndarray   # (n,) int64 raw index of event start (inclusive)
    length: np.ndarray  # (n,) float32
    mean: np.ndarray    # (n,) float32
    stdv: np.ndarray    # (n,) float32


def detect_events(raw: np.ndarray,
                  params: EventDetectionParams = EventDetectionParams()) -> EventTable:
    """t-stat change-point segmentation (event_detection.c:268-319)."""
    raw = np.asarray(raw, dtype=np.float64)
    n = raw.shape[0]
    sums = np.zeros(n + 1, dtype=np.float64)
    sumsqs = np.zeros(n + 1, dtype=np.float64)
    np.cumsum(raw, out=sums[1:])
    np.cumsum(raw * raw, out=sumsqs[1:])
    tstat1 = compute_tstat(sums, sumsqs, n, params.window_length1)
    tstat2 = compute_tstat(sums, sumsqs, n, params.window_length2)
    peaks = short_long_peak_detector(tstat1, tstat2, params)
    # create_events counts in-range nonzero peaks (event_detection.c:242-247);
    # peak positions are >0 in practice so this equals len(peaks)+1.
    valid = peaks[(peaks > 0) & (peaks < n)]
    bounds = np.concatenate([[0], valid, [n]])
    starts = bounds[:-1]
    ends = bounds[1:]
    lengths = (ends - starts).astype(np.float32)
    means = ((sums[ends] - sums[starts]) / lengths).astype(np.float32)
    deltasqr = (sumsqs[ends] - sumsqs[starts]).astype(np.float32)
    var = deltasqr / lengths - means * means
    stdv = np.sqrt(np.maximum(var, 0.0)).astype(np.float32)
    return EventTable(start=starts, length=lengths, mean=means, stdv=stdv)


@dataclass
class MergedEvents:
    """Per-read merged events as built by ``normaliseEvents``
    (event_handling.cpp:549-575).

    NOTE (parity quirk): the reference's merge loop lags by one, so the first
    emitted event carries mean 0.0 (the initial value of ``mean``) while
    spanning raw-event 0's samples, and the final raw event is never emitted.
    This is mirrored faithfully.
    """

    mean: np.ndarray       # (m,) float64 event means (first entry is 0.0)
    raw_start: np.ndarray  # (m,) int64 inclusive start into the raw signal
    raw_end: np.ndarray    # (m,) int64 inclusive end into the raw signal
    n_raw_events: int      # et.n, used for eventsPerBase


def merge_events(et: EventTable, raw_size: int) -> MergedEvents:
    means, starts, ends = [], [], []
    raw_start = 0
    mean = 0.0
    for i in range(et.mean.shape[0]):
        if et.mean[i] > 0.0:
            if i > 0:
                means.append(mean)
                starts.append(raw_start)
                ends.append(min(int(et.start[i]) - 1, raw_size - 1))
                mean = float(et.mean[i])
                raw_start = int(et.start[i])
    return MergedEvents(
        mean=np.asarray(means, dtype=np.float64),
        raw_start=np.asarray(starts, dtype=np.int64),
        raw_end=np.asarray(ends, dtype=np.int64),
        n_raw_events=int(et.mean.shape[0]),
    )


# ---------------------------------------------------------------------------
# Scaling (reference: src/event_handling.cpp:451-541 and :24-110)
# ---------------------------------------------------------------------------

def quantile_medians(data: np.ndarray, nquantiles: int) -> np.ndarray:
    """quantileMedians (event_handling.cpp:451-475)."""
    s = np.sort(np.asarray(data, dtype=np.float64))
    n = s.shape[0] // nquantiles
    i = np.arange(nquantiles)
    idx = (i * n + (i + 1) * n) // 2
    return s[idx]


def linear_regression(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """Least squares slope/intercept (event_handling.cpp:478-507)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    sum_x = x.sum(); sum_x2 = (x * x).sum(); sum_y = y.sum(); sum_xy = (x * y).sum()
    slope = (n * sum_xy - sum_x * sum_y) / (n * sum_x2 - sum_x * sum_x)
    intercept = (sum_y - slope * sum_x) / n
    return float(slope), float(intercept)


def estimate_scaling_quantiles(event_means: np.ndarray, model_means: np.ndarray,
                               params: ScalingParams = ScalingParams()) -> tuple[float, float]:
    """Quantile scaling: returns (shift, scale)
    (event_handling.cpp:510-541).  ``model_means`` are the pore-model means of
    the *reference* k-mer ranks."""
    sq = quantile_medians(event_means, params.n_quantiles)
    mq = quantile_medians(model_means, params.n_quantiles)
    slope, intercept = linear_regression(mq, sq)
    return intercept, slope  # shift, scale


def estimate_scaling_theilsen(signals: np.ndarray, model_means_at_ranks: np.ndarray,
                              shift: float, scale: float,
                              params: ScalingParams = ScalingParams()) -> tuple[float, float]:
    """Theil-Sen refinement of (shift, scale) (event_handling.cpp:24-110).

    ``signals`` are the cleaned signals from the banded backtrace;
    ``model_means_at_ranks`` the pore-model means at the cleaned ranks.
    Returns (-1.0, -1.0) when the median slope is zero (failure sentinel,
    event_handling.cpp:90-95); returns the inputs unchanged for short reads.
    """
    signals = np.asarray(signals, dtype=np.float64)
    model_means = np.asarray(model_means_at_ranks, dtype=np.float64)
    max_points = params.theilsen_max_points
    trim = params.theilsen_trim
    if model_means.shape[0] < max_points:  # minLength = maxPoints (line 30-33)
        return shift, scale
    effective = signals.shape[0] - 2 * trim
    skip = effective // max_points if effective > max_points else 1
    num_points = max_points if effective > max_points else effective
    idx = trim + skip * np.arange(num_points)
    x = (signals[idx] - shift) / scale
    y = model_means[idx]
    dy = y[:, None] - y[None, :]
    dx = x[:, None] - x[None, :]
    iu = np.triu_indices(num_points, k=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        slopes = dy[iu] / dx[iu]
    slopes = np.sort(slopes)
    m = slopes[slopes.shape[0] // 2]
    intercepts = np.sort(y - m * x)
    b = intercepts[intercepts.shape[0] // 2]
    if m == 0.0:
        return -1.0, -1.0
    scale_corr = 1.0 / m
    shift_corr = -b / m
    return shift + shift_corr * scale, scale * scale_corr


# ---------------------------------------------------------------------------
# Adaptive banded event alignment (reference: src/event_handling.cpp:116-448)
# ---------------------------------------------------------------------------

FROM_D, FROM_U, FROM_L = 0, 1, 2


@dataclass
class BandedResult:
    event_alignment: np.ndarray   # (n_pairs, 2) int64 (event_idx, kmer_idx), ascending
    cleaned_signals: np.ndarray   # (m,) float64, in backtrace (descending-kmer) order
    cleaned_ranks: np.ndarray     # (m,) int64
    avg_log_emission: float
    spanned: bool
    max_gap: int
    qc_pass: bool                 # emission/span/gap QC plus >=1000 cleaned events
    # internals exposed for kernel testing:
    bands: Optional[np.ndarray] = None        # (n_bands, bandwidth) float32
    trace: Optional[np.ndarray] = None        # (n_bands, bandwidth) uint8
    band_lower_left: Optional[np.ndarray] = None  # (n_bands, 2) int64 (event, kmer)


def log_probability_match(model: np.ndarray, kmer_rank: int, event_mean: float,
                          shift: float, scale: float) -> np.float32:
    """Scaled-event Gaussian log density (event_handling.cpp:116-137)."""
    mu, sigma = float(model[kmer_rank, 0]), float(model[kmer_rank, 1])
    x = (event_mean - shift) / scale
    a = np.float32((x - mu) / sigma)
    return np.float32(LOG_INV_SQRT_2PI - np.log(sigma) + (-0.5 * a * a))


def adaptive_banded_align(event_means: np.ndarray, kmer_ranks_query: np.ndarray,
                          kmer_ranks_ref: np.ndarray, query_to_ref: dict[int, int],
                          model: np.ndarray, shift: float, scale: float,
                          params: BandedAlignmentParams = BandedAlignmentParams(),
                          keep_matrices: bool = False) -> BandedResult:
    """Nanopolish-style adaptive banded DP with Suzuki band placement
    (event_handling.cpp:148-448).

    ``query_to_ref`` maps a query base index to a reference base index for
    matched positions (used to swap in reference k-mer ranks for the cleaned
    signal, event_handling.cpp:384-394).
    """
    n_events = int(event_means.shape[0])
    n_kmers = int(kmer_ranks_query.shape[0])
    bandwidth = params.bandwidth
    half = bandwidth // 2
    events_per_kmer = n_events / n_kmers
    p_stay = 1.0 - (1.0 / (events_per_kmer + 1.0))
    lp_skip = np.float32(np.log(params.epsilon_skip))
    lp_stay = np.float32(np.log(p_stay))
    lp_step = np.float32(np.log(1.0 - np.exp(float(lp_skip)) - np.exp(float(lp_stay))))
    lp_trim = np.float32(np.log(params.p_trim))

    n_bands = n_events + n_kmers + 2
    NEG = np.float32(-np.inf)
    bands = np.full((n_bands, bandwidth), NEG, dtype=np.float32)
    trace = np.zeros((n_bands, bandwidth), dtype=np.uint8)
    bll = np.zeros((n_bands, 2), dtype=np.int64)  # (event_idx, kmer_idx)

    bll[0] = (half - 1, -1 - half)
    bll[1] = (bll[0, 0] + 1, bll[0, 1])  # move_down

    # precompute per-query-kmer emission terms (model gather), float32
    mu = model[kmer_ranks_query, 0].astype(np.float32)
    sigma = model[kmer_ranks_query, 1].astype(np.float32)
    lp_const = (LOG_INV_SQRT_2PI - np.log(sigma)).astype(np.float32)
    inv_sigma = (1.0 / sigma).astype(np.float32)
    scaled_events = ((event_means - shift) / scale).astype(np.float32)

    start_cell_offset = -1 - bll[0, 1]  # band_kmer_to_offset(0, -1)
    bands[0, start_cell_offset] = 0.0
    first_trim_offset = bll[1, 0] - 0   # band_event_to_offset(1, 0)
    bands[1, first_trim_offset] = lp_trim
    trace[1, first_trim_offset] = FROM_U

    offs = np.arange(bandwidth)
    for bi in range(2, n_bands):
        ll = bands[bi - 1, 0]
        ur = bands[bi - 1, bandwidth - 1]
        ll_ob = ll == NEG
        ur_ob = ur == NEG
        if ll_ob and ur_ob:
            right = (bi % 2) == 1
        else:
            right = ll < ur  # Suzuki's rule (event_handling.cpp:246)
        if right:
            bll[bi] = (bll[bi - 1, 0], bll[bi - 1, 1] + 1)
        else:
            bll[bi] = (bll[bi - 1, 0] + 1, bll[bi - 1, 1])
        e0, k0 = int(bll[bi, 0]), int(bll[bi, 1])

        trim_offset = -1 - k0
        if 0 <= trim_offset < bandwidth:
            event_idx = e0 - trim_offset
            if 0 <= event_idx < n_events:
                bands[bi, trim_offset] = lp_trim * (event_idx + 1)
                trace[bi, trim_offset] = FROM_U
            else:
                bands[bi, trim_offset] = NEG

        kmer_min_offset = 0 - k0
        kmer_max_offset = n_kmers - k0
        event_min_offset = e0 - (n_events - 1)
        event_max_offset = e0 - (-1)
        min_offset = max(kmer_min_offset, event_min_offset, 0)
        max_offset = min(kmer_max_offset, event_max_offset, bandwidth)
        if min_offset >= max_offset:
            continue

        sl_o = slice(min_offset, max_offset)
        event_idx = e0 - offs[sl_o]
        kmer_idx = k0 + offs[sl_o]

        # predecessor offsets collapse to shifts of the previous bands
        # (macros at event_handling.cpp:139-146):
        e_prev1, k_prev1 = int(bll[bi - 1, 0]), int(bll[bi - 1, 1])
        e_prev2, k_prev2 = int(bll[bi - 2, 0]), int(bll[bi - 2, 1])
        offset_up = e_prev1 - (event_idx - 1)
        offset_left = (kmer_idx - 1) - k_prev1
        offset_diag = (kmer_idx - 1) - k_prev2

        def pick(band_row: np.ndarray, o: np.ndarray) -> np.ndarray:
            valid = (o >= 0) & (o < bandwidth)
            out = np.full(o.shape, NEG, dtype=np.float32)
            out[valid] = band_row[o[valid]]
            return out

        up = pick(bands[bi - 1], offset_up)
        left = pick(bands[bi - 1], offset_left)
        diag = pick(bands[bi - 2], offset_diag)

        x = scaled_events[event_idx]
        a = (x - mu[kmer_idx]) * inv_sigma[kmer_idx]
        lp_emission = (lp_const[kmer_idx] - np.float32(0.5) * a * a).astype(np.float32)

        score_d = diag + lp_step + lp_emission
        score_u = up + lp_stay + lp_emission
        score_l = left + lp_skip
        # tie-breaking mirrors event_handling.cpp:300-306: U beats D on ties,
        # L beats both on ties with the running max.
        max_du = np.maximum(score_d, score_u)
        from_du = np.where(max_du == score_u, FROM_U, FROM_D)
        max_all = np.maximum(max_du, score_l)
        frm = np.where(max_all == score_l, FROM_L, from_du)
        bands[bi, sl_o] = max_all
        trace[bi, sl_o] = frm.astype(np.uint8)

    # --- backtrace (event_handling.cpp:318-443) ---
    max_score = NEG
    curr_event = 0
    curr_kmer = n_kmers - 1
    for event_idx in range(n_events):
        band_idx = (event_idx + 1) + (curr_kmer + 1)
        offset = int(bll[band_idx, 0]) - event_idx
        if 0 <= offset < bandwidth:
            s = bands[band_idx, offset] + np.float32((n_events - event_idx)) * lp_trim
            if s > max_score:
                max_score = s
                curr_event = event_idx

    pairs = []
    cleaned_signals: list[float] = []
    cleaned_ranks: list[int] = []
    signal_buffer: list[float] = []
    sum_emission = 0.0
    n_aligned = 0
    curr_gap = 0
    max_gap = 0
    n_ref_kmers = int(kmer_ranks_ref.shape[0])
    while curr_kmer >= 0 and curr_event >= 0:
        pairs.append((curr_event, curr_kmer))
        x = scaled_events[curr_event]
        a = (x - mu[curr_kmer]) * inv_sigma[curr_kmer]
        sum_emission += float(lp_const[curr_kmer] - np.float32(0.5) * a * a)
        n_aligned += 1
        band_idx = (curr_event + 1) + (curr_kmer + 1)
        offset = int(bll[band_idx, 0]) - curr_event
        frm = trace[band_idx, offset]
        if frm == FROM_D:
            signal_buffer.append(float(event_means[curr_event]))
            if curr_kmer in query_to_ref:
                pos_on_ref = query_to_ref[curr_kmer]
                if pos_on_ref < n_ref_kmers:
                    cleaned_ranks.append(int(kmer_ranks_ref[pos_on_ref]))
                    cleaned_signals.append(float(np.mean(signal_buffer)))
            signal_buffer.clear()
            curr_kmer -= 1
            curr_event -= 1
            curr_gap = 0
        elif frm == FROM_U:
            signal_buffer.append(float(event_means[curr_event]))
            curr_event -= 1
            curr_gap = 0
        else:
            curr_kmer -= 1
            curr_gap += 1
            max_gap = max(max_gap, curr_gap)
    pairs.reverse()
    pairs_arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)

    avg_log_emission = sum_emission / n_aligned if n_aligned else float("-inf")
    spanned = bool(pairs_arr.size) and pairs_arr[0, 1] == 0 \
        and pairs_arr[-1, 1] == n_kmers - 1
    qc_pass = (avg_log_emission >= params.min_average_log_emission and spanned
               and max_gap <= params.max_gap_threshold
               and len(cleaned_signals) >= params.min_cleaned_events
               and len(cleaned_ranks) >= params.min_cleaned_events)

    return BandedResult(
        event_alignment=pairs_arr if qc_pass else np.empty((0, 2), dtype=np.int64),
        cleaned_signals=np.asarray(cleaned_signals, dtype=np.float64),
        cleaned_ranks=np.asarray(cleaned_ranks, dtype=np.int64),
        avg_log_emission=avg_log_emission,
        spanned=spanned,
        max_gap=max_gap,
        qc_pass=qc_pass,
        bands=bands if keep_matrices else None,
        trace=trace if keep_matrices else None,
        band_lower_left=bll if keep_matrices else None,
    )


# ---------------------------------------------------------------------------
# Windowed 3-state Viterbi (reference: src/alignment.cpp:193-516)
# ---------------------------------------------------------------------------

@dataclass
class ViterbiResult:
    score: float
    # path of (state_kind, state_pos): kind 0=D, 1=M, 2=I, forward order
    path: np.ndarray  # (n_steps, 2) int64


def builtin_viterbi(observations: np.ndarray, kmer_ranks: np.ndarray,
                    model: np.ndarray, shift: float, scale: float,
                    events_per_base: float,
                    hmm: HMMTransitionParams = HMMTransitionParams()) -> ViterbiResult:
    """Max-product 3-state-per-kmer Viterbi with backtrace
    (alignment.cpp:193-516).  NAN-as-log0 is mirrored with -inf.
    """
    NEG = -np.inf
    eD2D = np.log(hmm.external_D2D)
    eD2M = np.log(hmm.external_D2M)
    eI2M = np.log(hmm.external_I2M)
    eM2D = np.log(hmm.external_M2D)
    iM2I = np.log(hmm.internal_M2I)
    iI2I = np.log(hmm.internal_I2I)
    iM2M = np.log(1.0 - (1.0 / events_per_base))
    eM2M = np.log(1.0 - hmm.external_M2D - hmm.internal_M2I - (1.0 - 1.0 / events_per_base))
    eM2MorD = np.logaddexp(eM2M, eM2D)
    eOrIM2M = np.logaddexp(eM2M, iM2M)

    n = int(kmer_ranks.shape[0])
    T = int(observations.shape[0])
    mu = model[kmer_ranks, 0]
    sigma = model[kmer_ranks, 1]
    # log N(x; mu, sigma) on the scaled observation (alignment.cpp:273)
    obs = (np.asarray(observations, dtype=np.float64) - shift) / scale
    # emission matrix (T, n)
    z = (obs[:, None] - mu[None, :]) / sigma[None, :]
    log_em = -0.5 * np.log(2.0 * np.pi * sigma[None, :] ** 2) - 0.5 * z * z

    # state indexing: D=i, M=n+i, I=2n+i, start=-1
    D_off, M_off, I_off = 0, n, 2 * n
    # backtrace tables: prev state and prev time per (state, t+1)
    btS = np.full((3 * n, T + 1), -2, dtype=np.int64)
    btT = np.zeros((3 * n, T + 1), dtype=np.int64)

    I_prev = np.full(n, NEG)
    M_prev = np.full(n, NEG)
    D_prev = np.full(n, NEG)
    start_prev = 0.0

    # initialisation: start -> D0 -> D1 ... (alignment.cpp:239-251)
    D_prev[0] = start_prev + eM2D
    btS[D_off + 0, 0] = -1
    btT[D_off + 0, 0] = 0
    for i in range(1, n):
        D_prev[i] = D_prev[i - 1] + eD2D
        btS[D_off + i, 0] = D_off + i - 1
        btT[D_off + i, 0] = 0

    def argmax_first(vals: list[float]) -> int:
        best, arg = vals[0], 0
        for j in range(1, len(vals)):
            if vals[j] > best:
                best, arg = vals[j], j
        return arg

    for t in range(T):
        I_curr = np.full(n, NEG)
        M_curr = np.full(n, NEG)
        D_curr = np.full(n, NEG)
        em = log_em[t]

        # base 1 insertion (alignment.cpp:277-302)
        cand = [I_prev[0] + iI2I, M_prev[0] + iM2I, start_prev + iM2I]
        I_curr[0] = max(cand)
        a = argmax_first(cand)
        btS[I_off + 0, t + 1] = [I_off + 0, M_off + 0, -1][a]
        btT[I_off + 0, t + 1] = t

        # base 1 match (alignment.cpp:304-323)
        cand = [M_prev[0] + iM2M + em[0], start_prev + eOrIM2M + em[0]]
        M_curr[0] = max(cand)
        a = argmax_first(cand)
        btS[M_off + 0, t + 1] = [M_off + 0, -1][a]
        btT[M_off + 0, t + 1] = t

        # base 1 deletion is always NAN (alignment.cpp:326-328)
        D_curr[0] = NEG
        btS[D_off + 0, t + 1] = -1
        btT[D_off + 0, t + 1] = t + 1

        if n > 1:
            i = np.arange(1, n)
            # insertions (vectorised; tie-break I-before-M as in :354-356)
            ci = np.stack([I_prev[i] + iI2I, M_prev[i] + iM2I])
            I_curr[i] = ci.max(axis=0)
            ai = np.argmax(ci, axis=0)  # np.argmax is first-wins, like lnArgMax
            btS[I_off + i, t + 1] = np.where(ai == 0, I_off + i, M_off + i)
            btT[I_off + i, t + 1] = t
            # matches (:372-402); candidate order I,M-ext,M-int,D
            cm = np.stack([
                I_prev[i - 1] + eI2M + em[i],
                M_prev[i - 1] + eM2M + em[i],
                M_prev[i] + iM2M + em[i],
                D_prev[i - 1] + eD2M + em[i],
            ])
            M_curr[i] = cm.max(axis=0)
            am = np.argmax(cm, axis=0)  # first-wins tie-break, like lnArgMax
            prevs = np.stack([I_off + i - 1, M_off + i - 1, M_off + i, D_off + i - 1])
            btS[M_off + i, t + 1] = prevs[am, np.arange(i.shape[0])]
            btT[M_off + i, t + 1] = t
            # deletions: sequential within timestep (:405-427)
            for ii in range(1, n):
                c0 = M_curr[ii - 1] + eM2D
                c1 = D_curr[ii - 1] + eD2D
                if c0 >= c1:
                    D_curr[ii] = c0
                    btS[D_off + ii, t + 1] = M_off + ii - 1
                else:
                    D_curr[ii] = c1
                    btS[D_off + ii, t + 1] = D_off + ii - 1
                btT[D_off + ii, t + 1] = t + 1

        I_prev, M_prev, D_prev = I_curr, M_curr, D_curr
        start_prev = NEG

    # termination (alignment.cpp:445-476)
    cand = [D_prev[n - 1], M_prev[n - 1] + eM2MorD, I_prev[n - 1] + eI2M]
    score = max(cand)
    a = argmax_first(cand)
    tb_old = [D_off + n - 1, M_off + n - 1, I_off + n - 1][a]
    tb_t = T

    rev_path = []
    while tb_old != -1:
        tb_new = btS[tb_old, tb_t]
        tb_t_new = btT[tb_old, tb_t]
        if tb_old < M_off:
            rev_path.append((0, tb_old))
        elif tb_old < I_off:
            rev_path.append((1, tb_old - M_off))
        else:
            rev_path.append((2, tb_old - I_off))
        tb_old = tb_new
        tb_t = tb_t_new
    rev_path.reverse()
    return ViterbiResult(score=float(score),
                         path=np.asarray(rev_path, dtype=np.int64).reshape(-1, 2))


# ---------------------------------------------------------------------------
# Forward HMM log-likelihood (reference: src/detect.cpp:235-378)
# ---------------------------------------------------------------------------

def sequence_probability(observations: np.ndarray, kmer_ranks: np.ndarray,
                         contains_T: np.ndarray, window_size: int, use_brdu: bool,
                         unlabelled_model: np.ndarray, analogue_model: np.ndarray,
                         shift: float, scale: float, events_per_base: float,
                         brdu_start: int, brdu_end: int,
                         hmm: HMMTransitionParams = HMMTransitionParams()) -> float:
    """Forward-algorithm log likelihood over a POI window
    (detect.cpp:235-378).  States are the first 2*window_size k-mers of the
    snippet; when ``use_brdu`` the analogue table replaces the unlabelled one
    for T-containing k-mers in [brdu_start, brdu_end]."""
    eD2D = np.log(hmm.external_D2D)
    eD2M = np.log(hmm.external_D2M)
    eI2M = np.log(hmm.external_I2M)
    eM2D = np.log(hmm.external_M2D)
    iM2I = np.log(hmm.internal_M2I)
    iI2I = np.log(hmm.internal_I2I)
    iM2M = np.log(1.0 - (1.0 / events_per_base))
    eM2M = np.log(1.0 - hmm.external_M2D - hmm.internal_M2I - (1.0 - 1.0 / events_per_base))

    n = 2 * window_size
    ranks = kmer_ranks[:n]
    mu = unlabelled_model[ranks, 0].astype(np.float64).copy()
    sigma = unlabelled_model[ranks, 1].astype(np.float64).copy()
    if use_brdu:
        i = np.arange(n)
        sel = (i >= brdu_start) & (i <= brdu_end) & contains_T[:n]
        mu[sel] = analogue_model[ranks[sel], 0]
        sigma[sel] = analogue_model[ranks[sel], 1]

    obs = (np.asarray(observations, dtype=np.float64) - shift) / scale
    z = (obs[:, None] - mu[None, :]) / sigma[None, :]
    log_em = -0.5 * np.log(2.0 * np.pi * sigma[None, :] ** 2) - 0.5 * z * z

    NEG = -np.inf
    ln25 = np.log(0.25)
    ln50 = np.log(0.5)
    I_prev = np.full(n, NEG)
    M_prev = np.full(n, NEG)
    D_prev = np.full(n, NEG)
    firstI_prev = NEG
    start_prev = 0.0

    D_prev[0] = start_prev + ln25
    for i in range(1, n):
        D_prev[i] = D_prev[i - 1] + eD2D

    for t in range(obs.shape[0]):
        em = log_em[t]
        firstI_curr = np.logaddexp(start_prev + ln25, firstI_prev + ln25)
        I_curr = np.logaddexp(I_prev + iI2I, M_prev + iM2I)
        M_curr = np.full(n, NEG)
        M_curr[0] = np.logaddexp.reduce([
            firstI_prev + ln50 + em[0],
            M_prev[0] + iM2M + em[0],
            start_prev + ln50 + em[0],
        ])
        if n > 1:
            M_curr[1:] = np.logaddexp.reduce(np.stack([
                I_prev[:-1] + eI2M + em[1:],
                M_prev[:-1] + eM2M + em[1:],
                M_prev[1:] + iM2M + em[1:],
                D_prev[:-1] + eD2M + em[1:],
            ]), axis=0)
        D_curr = np.full(n, NEG)
        D_curr[0] = firstI_curr + ln25  # start->D contributes NAN (detect.cpp:308)
        for i in range(1, n):
            D_curr[i] = np.logaddexp(M_curr[i - 1] + eM2D, D_curr[i - 1] + eD2D)
        I_prev, M_prev, D_prev = I_curr, M_curr, D_curr
        firstI_prev = firstI_curr
        start_prev = NEG

    fwd = np.logaddexp.reduce([
        D_prev[n - 1],
        M_prev[n - 1] + np.logaddexp(eM2M, eM2D),
        I_prev[n - 1] + eI2M,
    ])
    return float(fwd)
