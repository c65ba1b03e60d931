// dnascent_native — host-side C++ support for the dnascent_tpu framework.
//
// The device does the dense numeric work (banded fill, Viterbi fill, CNN); this
// library supplies the cheap-but-sequential host pieces that map poorly onto
// XLA: the scrappie event-detection FSM, the banded-DP backtrace pointer
// chase, and libstdc++-exact RNG streams for seeBreaks parity.
//
// Plain C ABI, loaded through ctypes.  Built by native/build.py.
//
// Algorithm citations refer to /root/reference (MBoemo/DNAscent v4.1.1).

#include <algorithm>
#include <array>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Event detection (mirrors src/scrappie/event_detection.c)
// ---------------------------------------------------------------------------

// t-stat with two windows + short/long peak FSM + event merge as done by
// normaliseEvents (event_handling.cpp:544-575).  Outputs the *merged* events:
// first event carries mean 0.0 and the final raw event is dropped, mirroring
// the reference's lag quirk.
//
// Returns number of merged events written (<= max_out).  raw_n is the signal
// length; outputs: mean (f64), raw_start/raw_end (i64, inclusive).
// et_n_out receives the raw event count (for eventsPerBase).
int64_t event_detect_single(const double* raw, int64_t raw_n,
                            int64_t w1, int64_t w2,
                            float thresh1, float thresh2, float peak_height,
                            double* out_mean, int64_t* out_start,
                            int64_t* out_end, int64_t max_out,
                            int64_t* et_n_out) {
    if (raw_n <= 0) { *et_n_out = 0; return 0; }
    std::vector<double> sums(raw_n + 1), sumsqs(raw_n + 1);
    sums[0] = 0.0; sumsqs[0] = 0.0;
    for (int64_t i = 0; i < raw_n; ++i) {
        sums[i + 1] = sums[i] + raw[i];
        sumsqs[i + 1] = sumsqs[i] + raw[i] * raw[i];
    }

    auto tstat = [&](int64_t w, std::vector<float>& out) {
        out.assign(raw_n, 0.0f);
        if (raw_n < 2 * w || w < 2) return;
        const float eta = FLT_MIN;
        const float wf = (float)w;
        for (int64_t i = w; i <= raw_n - w; ++i) {
            double sum1 = sums[i], sumsq1 = sumsqs[i];
            if (i > w) { sum1 -= sums[i - w]; sumsq1 -= sumsqs[i - w]; }
            float sum2 = (float)(sums[i + w] - sums[i]);
            float sumsq2 = (float)(sumsqs[i + w] - sumsqs[i]);
            float mean1 = sum1 / wf, mean2 = sum2 / wf;
            float cv = sumsq1 / wf - mean1 * mean1 + sumsq2 / wf - mean2 * mean2;
            cv = std::max(cv, eta);
            out[i] = std::fabs(mean2 - mean1) / std::sqrt(cv / wf);
        }
    };
    std::vector<float> t1, t2;
    tstat(w1, t1);
    tstat(w2, t2);

    // short/long peak detector (event_detection.c:122-198)
    struct Det {
        const float* sig; float threshold; int64_t window;
        int64_t masked_to; int64_t peak_pos; float peak_value; bool valid;
    };
    Det det[2] = {
        {t1.data(), thresh1, w1, 0, -1, FLT_MAX, false},
        {t2.data(), thresh2, w2, 0, -1, FLT_MAX, false},
    };
    std::vector<int64_t> peaks;
    peaks.reserve(raw_n / 4);
    for (int64_t i = 0; i < raw_n; ++i) {
        for (int k = 0; k < 2; ++k) {
            Det& d = det[k];
            if (d.masked_to >= i) continue;
            float cur = d.sig[i];
            if (d.peak_pos == -1) {
                if (cur < d.peak_value) d.peak_value = cur;
                else if (cur - d.peak_value > peak_height) {
                    d.peak_value = cur; d.peak_pos = i;
                }
            } else {
                if (cur > d.peak_value) { d.peak_value = cur; d.peak_pos = i; }
                if (k == 0 && d.peak_value > d.threshold) {
                    det[1].masked_to = d.peak_pos + d.window;
                    det[1].peak_pos = -1; det[1].peak_value = FLT_MAX;
                    det[1].valid = false;
                }
                if (d.peak_value - cur > peak_height && d.peak_value > d.threshold)
                    d.valid = true;
                if (d.valid && (i - d.peak_pos) > d.window / 2) {
                    peaks.push_back(d.peak_pos);
                    d.peak_pos = -1; d.peak_value = cur; d.valid = false;
                }
            }
        }
    }

    // create_events (event_detection.c:234-266)
    std::vector<int64_t> bounds;
    bounds.reserve(peaks.size() + 2);
    bounds.push_back(0);
    for (int64_t p : peaks) if (p > 0 && p < raw_n) bounds.push_back(p);
    bounds.push_back(raw_n);
    int64_t et_n = (int64_t)bounds.size() - 1;
    *et_n_out = et_n;

    // merged events (event_handling.cpp:550-575): faithful lag quirk
    int64_t n_out = 0;
    int64_t raw_start = 0;
    double mean = 0.0;
    for (int64_t i = 0; i < et_n; ++i) {
        int64_t s = bounds[i], e = bounds[i + 1];
        double m = (sums[e] - sums[s]) / (double)(e - s);
        // float cast as in create_event (event_detection.c:226)
        float mf = (float)m;
        if (mf > 0.0f) {
            if (i > 0) {
                if (n_out >= max_out) break;
                out_mean[n_out] = mean;
                out_start[n_out] = raw_start;
                out_end[n_out] = std::min(s - 1, raw_n - 1);
                ++n_out;
                mean = (double)mf;
                raw_start = s;
            }
        }
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// Banded-DP backtrace (mirrors src/event_handling.cpp:318-443)
// ---------------------------------------------------------------------------

// Inputs come from the device fill kernel:
//   trace: (n_bands-2, W) uint8 codes for bands 2..n_bands-1 (0=D,1=U,2=L)
//   rights: (n_bands-2,) uint8 right/down decisions for bands 2..n_bands-1
//   best_event: backtrace start event (device-computed argmax)
// plus emission coefficients for QC statistics and the cleaned-signal
// aggregation used by Theil-Sen (event_handling.cpp:352-394).
//
// query_to_ref: (n_kmers,) int64, -1 when the query position has no
// reference match.
//
// Outputs (caller-allocated):
//   pairs_out: (max_pairs*2,) int64 (event, kmer) ascending after reversal
//   cleaned_signal_out / cleaned_rank_out: Theil-Sen inputs, backtrace order
//   stats_out: [avg_log_emission, spanned, max_gap, n_pairs, n_cleaned]
// trace/rights arrive as the fill packed them: (S, batch, W) and (S, batch)
// bytes holding four bands each (band 2 + 4s + j in bits 2j / bit j of step
// s); this read is column `col`, so no unpacked copy is ever made
void banded_backtrace(const uint8_t* trace, const uint8_t* rights,
                      int64_t batch, int64_t col,
                      int64_t n_bands, int64_t W,
                      int64_t n_events, int64_t n_kmers,
                      int64_t best_event,
                      const double* event_means,
                      const float* scaled_events,
                      const float* mu, const float* inv_sigma,
                      const float* lp_const,
                      const int64_t* query_to_ref,
                      const int64_t* kmer_ranks_ref, int64_t n_ref_kmers,
                      int64_t* pairs_out, int64_t max_pairs,
                      double* cleaned_signal_out, int64_t* cleaned_rank_out,
                      double* stats_out) {
    // reconstruct band lower-left events: bll_e[band]; band0=(half-1), band1=half
    // bands 2.. advance by (1 - right)
    std::vector<int64_t> bll_e(n_bands);
    int64_t half = W / 2;
    bll_e[0] = half - 1;
    bll_e[1] = half;
    for (int64_t b = 2; b < n_bands; ++b)
        bll_e[b] = bll_e[b - 1]
                   + (((rights[((b - 2) >> 2) * batch + col] >> ((b - 2) & 3))
                       & 1) ? 0 : 1);

    int64_t curr_event = best_event;
    int64_t curr_kmer = n_kmers - 1;
    double sum_emission = 0.0;
    int64_t n_aligned = 0;
    int64_t curr_gap = 0, max_gap = 0;
    int64_t n_pairs = 0, n_cleaned = 0;

    std::vector<double> signal_buffer;
    signal_buffer.reserve(64);

    while (curr_kmer >= 0 && curr_event >= 0) {
        if (n_pairs < max_pairs) {
            pairs_out[2 * n_pairs] = curr_event;
            pairs_out[2 * n_pairs + 1] = curr_kmer;
        }
        ++n_pairs;
        float a = (scaled_events[curr_event] - mu[curr_kmer]) * inv_sigma[curr_kmer];
        sum_emission += (double)(lp_const[curr_kmer] - 0.5f * a * a);
        ++n_aligned;

        int64_t band_idx = (curr_event + 1) + (curr_kmer + 1);
        int64_t offset = bll_e[band_idx] - curr_event;
        const int64_t r = band_idx - 2;
        uint8_t frm = (band_idx >= 2 && offset >= 0 && offset < W)
                          ? (trace[((r >> 2) * batch + col) * W + offset]
                             >> (2 * (r & 3))) & 3
                          : 0;
        if (band_idx < 2) {
            // bands 0/1 only contain start/trim cells; treat as U (trim)
            frm = 1;
        }
        if (frm == 0) {  // FROM_D
            signal_buffer.push_back(event_means[curr_event]);
            int64_t pos_on_ref = query_to_ref[curr_kmer];
            if (pos_on_ref >= 0 && pos_on_ref < n_ref_kmers) {
                double s = 0.0;
                for (double v : signal_buffer) s += v;
                cleaned_signal_out[n_cleaned] = s / (double)signal_buffer.size();
                cleaned_rank_out[n_cleaned] = kmer_ranks_ref[pos_on_ref];
                ++n_cleaned;
            }
            signal_buffer.clear();
            --curr_kmer;
            --curr_event;
            curr_gap = 0;
        } else if (frm == 1) {  // FROM_U
            signal_buffer.push_back(event_means[curr_event]);
            --curr_event;
            curr_gap = 0;
        } else {  // FROM_L
            --curr_kmer;
            ++curr_gap;
            if (curr_gap > max_gap) max_gap = curr_gap;
        }
    }
    // reverse pairs in place to ascending order (event_handling.cpp:413)
    int64_t m = std::min(n_pairs, max_pairs);
    for (int64_t i = 0; i < m / 2; ++i) {
        std::swap(pairs_out[2 * i], pairs_out[2 * (m - 1 - i)]);
        std::swap(pairs_out[2 * i + 1], pairs_out[2 * (m - 1 - i) + 1]);
    }
    bool spanned = false;
    if (m > 0)
        spanned = (pairs_out[1] == 0) && (pairs_out[2 * (m - 1) + 1] == n_kmers - 1);
    stats_out[0] = n_aligned ? sum_emission / (double)n_aligned : -INFINITY;
    stats_out[1] = spanned ? 1.0 : 0.0;
    stats_out[2] = (double)max_gap;
    stats_out[3] = (double)n_pairs;
    stats_out[4] = (double)n_cleaned;
}

// ---------------------------------------------------------------------------
// libstdc++-exact RNG streams for seeBreaks parity (seeBreaks.cpp:430-502)
// ---------------------------------------------------------------------------

// Simulation bootstrap: for each of bs_iterations, draw nForks
// (read, trackLength, start) triples and count run-offs
// (seeBreaks.cpp:430-474).  Uses std::mt19937 + std::uniform_int_distribution
// so results are bit-identical to the reference under libstdc++.
void seebreaks_simulation(const int64_t* v5, const int64_t* v3, int64_t n_reads,
                          const int64_t* fork_len, int64_t n_lens,
                          int64_t n_forks, int64_t bs_iterations, uint32_t seed,
                          int64_t fs_boundary, int64_t read_end_tolerance,
                          double* out_run_off_props) {
    std::mt19937 gen(seed);
    for (int64_t i = 0; i < bs_iterations; ++i) {
        int64_t run_off = 0;
        for (int64_t j = 0; j < n_forks; ++j) {
            std::uniform_int_distribution<> read_dist(0, (int)(n_reads - 1));
            int64_t ri = read_dist(gen);
            int64_t r5 = v5[ri], r3 = v3[ri];
            std::uniform_int_distribution<> track_dist(0, (int)(n_lens - 1));
            int64_t random_len = fork_len[track_dist(gen)];
            std::uniform_int_distribution<> start_dist((int)(r5 + fs_boundary),
                                                       (int)(r3 - fs_boundary));
            int64_t start = start_dist(gen);
            if (r3 - read_end_tolerance - start < random_len) ++run_off;
        }
        out_run_off_props[i] = (double)run_off / (double)n_forks;
    }
}

// Observation bootstrap (seeBreaks.cpp:476-502).
void seebreaks_observation(const uint8_t* run_off, int64_t n, uint32_t seed,
                           int64_t bs_iterations, double* out_props) {
    std::mt19937 gen(seed);
    for (int64_t i = 0; i < bs_iterations; ++i) {
        int64_t obs = 0, no_obs = 0;
        for (int64_t j = 0; j < n; ++j) {
            std::uniform_int_distribution<> dist(0, (int)(n - 1));
            int64_t ri = dist(gen);
            if (run_off[ri]) ++obs; else ++no_obs;
        }
        out_props[i] = (double)obs / (double)(obs + no_obs);
    }
}

// Difference distribution (seeBreaks.cpp:592-599): normal draws with the
// seeded generator.
void seebreaks_difference(double obs_mean, double obs_std, double sim_mean,
                          double sim_std, int64_t n, uint32_t seed,
                          double* out_diff) {
    std::mt19937 gen(seed);
    for (int64_t i = 0; i < n; ++i) {
        std::normal_distribution<double> obs_d(obs_mean, obs_std);
        std::normal_distribution<double> sim_d(sim_mean, sim_std);
        double a = obs_d(gen);
        double b = sim_d(gen);
        out_diff[i] = a - b;
    }
}

// ---------------------------------------------------------------------------
// Fast-mode eventalign post-processing
// ---------------------------------------------------------------------------

// Walk every window's Viterbi path of one read and emit the per-reference-
// position aligned rows plus the CNN's flat u8 signal stream — the native
// twin of pipeline/eventalign._process_read_windows_batched (reference
// semantics: alignment.cpp:654-740).  Runs with the GIL released via ctypes,
// so pipeline threads overlap for real on a 2-core host.
//
// codes: concatenated per-window path codes (kind | delta<<2, forward
// order); positions are recovered by suffix-anchoring the delta sum at
// ns-1.  Segments group consecutive M steps at the same position (stay
// chains); nsig counts every sample of the segment while sig_flat keeps the
// first `rawdepth`.  Returns the number of positions written.
int64_t process_read_windows(
    const uint8_t* codes, const int64_t* steps_per, const int64_t* ns_per,
    const int64_t* g_ev, const int64_t* ev_start,
    const int64_t* ri_arr, const int64_t* rc_arr, const int64_t* indel_arr,
    int64_t n_windows, int64_t is_reverse, int64_t k,
    const int64_t* ev_raw_start, const int64_t* ev_raw_end,
    const double* raw, double shift, double scale,
    const int64_t* ref_to_query, const int64_t* core_rank,
    const int64_t* res_rank, const int8_t* ref_codes,
    float quant_lo, float quant_scale, int64_t rawdepth,
    int64_t* coord, int64_t* kmer_start, int64_t* query_idx, int64_t* ref_idx,
    int64_t* core, int64_t* res, int64_t* nsig, uint8_t* centerT,
    int64_t* indel_out,
    uint8_t* sig_flat, int64_t* sig_flat_len,
    float* scaled_stream, int64_t max_samples, int64_t* seg_start,
    int64_t* n_samples_out) {
    int64_t P = 0, fl = 0, samp = 0;
    int64_t code_off = 0;
    const int64_t half_k = k / 2;
    for (int64_t w = 0; w < n_windows; ++w) {
        const int64_t S = steps_per[w];
        const int64_t ns = ns_per[w];
        const uint8_t* c = codes + code_off;
        int64_t total = 0;
        for (int64_t t = 0; t < S; ++t) total += (c[t] >> 2) & 1;
        int64_t csum = 0;
        int64_t ev_local = -1;
        int64_t prev_pos = INT64_MIN;
        for (int64_t t = 0; t < S; ++t) {
            const uint8_t kind = c[t] & 3;
            csum += (c[t] >> 2) & 1;
            if (kind != 0) ++ev_local;       // non-D advances the event cursor
            if (kind != 1) continue;         // only M steps emit positions
            const int64_t pos = ns - 1 - (total - csum);
            const int64_t ev = g_ev[ev_start[w] + ev_local];
            const int64_t rs = ev_raw_start[ev];
            const int64_t cnt = ev_raw_end[ev] - rs + 1;
            if (pos != prev_pos) {
                const int64_t ksv = ri_arr[w] + pos;
                coord[P] = is_reverse ? rc_arr[w] - pos - 1 : rc_arr[w] + pos;
                kmer_start[P] = ksv;
                ref_idx[P] = ksv + half_k;
                query_idx[P] = ref_to_query[ksv + half_k];
                core[P] = core_rank[ksv];
                res[P] = res_rank[ksv];
                centerT[P] = ref_codes[ksv + half_k] == 1 ? 1 : 0;
                indel_out[P] = indel_arr[w];
                nsig[P] = 0;
                seg_start[P] = samp;
                ++P;
                prev_pos = pos;
            }
            for (int64_t i = 0; i < cnt && samp < max_samples; ++i) {
                const float v = (float)((raw[rs + i] - shift) / scale);
                scaled_stream[samp++] = v;
                if (nsig[P - 1] + i < rawdepth) {
                    float q = nearbyintf((v - quant_lo) * quant_scale) + 1.0f;
                    q = q < 1.0f ? 1.0f : (q > 255.0f ? 255.0f : q);
                    sig_flat[fl++] = (uint8_t)q;
                }
            }
            nsig[P - 1] += cnt;
        }
        code_off += S;
    }
    *sig_flat_len = fl;
    *n_samples_out = samp;
    return P;
}

// ---------------------------------------------------------------------------
// Fast-mode window chain (twin of the scalar loop in
// pipeline/eventalign._build_window_set; window rules from
// alignment.cpp:555-650 with the full-span advance departure)
// ---------------------------------------------------------------------------

// All lookup tables are precomputed vectorised on the host; this walks the
// inherently sequential chain of window starts.  Returns the window count.
int64_t window_chain(const int64_t* undef_cum, const int64_t* bp_pos,
                     int64_t n_bp, const int64_t* next_bp,
                     const int64_t* j_at, const int64_t* guard_cum,
                     int64_t ref_len, int64_t k, int64_t total_wl,
                     int64_t* ri_out, int64_t* wl_out, int64_t* j0_out,
                     int64_t* j1_out) {
    const int64_t n_kmer_max = ref_len - k + 1;
    int64_t n = 0;
    int64_t ri = 0;
    while (ri < n_kmer_max) {
        int64_t bases_to_end = ref_len - ri;
        int64_t wl = bases_to_end < total_wl ? bases_to_end : total_wl;
        if (2 * bases_to_end > 3 * total_wl) {
            // here wl == total_wl; int(1.5*wl) == (3*wl)/2 for wl >= 0
            int64_t snip_len = (3 * wl) / 2;
            if (undef_cum[ri + snip_len] - undef_cum[ri]) {
                ri += wl;
                continue;
            }
            int64_t limit = (3 * wl) / 2 - k - 1;
            int64_t bi = next_bp[ri + wl];
            if (bi < n_bp && bp_pos[bi] < ri + limit)
                wl = bp_pos[bi] - ri + k;
        }
        if (undef_cum[ri + wl] - undef_cum[ri]) {
            ri += wl;
            continue;
        }
        int64_t j0 = j_at[ri];
        int64_t j1 = j_at[ri + wl - k + 1];
        if (j1 <= j0 || guard_cum[j1] - guard_cum[j0] < 2) {
            ri += wl;
            continue;
        }
        ri_out[n] = ri;
        wl_out[n] = wl;
        j0_out[n] = j0;
        j1_out[n] = j1;
        ++n;
        ri += wl - k + 1;
    }
    return n;
}

// ---------------------------------------------------------------------------
// blockpack: lossless per-block bit-packing of a u8 stream.
//
// The detect pipeline's largest upload is the flat u8 CNN signal stream
// (~8 bits/sample); its per-128-sample dynamic range is ~6 bits, so packing
// each block at its own width cuts the interconnect bytes ~25% with exact
// reconstruction on device (ops/blockpack.unpack_u8).  Layout: per block a
// min (u8) + width (u8, 0..8); payload is a little-endian bitstream of
// (value - min) at `width` bits each, blocks concatenated with no padding.
// n must be a multiple of `block` (callers pack bucket-padded streams).
// ---------------------------------------------------------------------------
int64_t blockpack_u8(const uint8_t* v, int64_t n, int64_t block,
                     uint8_t* payload, uint8_t* widths, uint8_t* mins) {
    int64_t nb = n / block;
    uint64_t acc = 0;
    int accbits = 0;
    int64_t out = 0;
    for (int64_t b = 0; b < nb; ++b) {
        const uint8_t* p = v + b * block;
        uint8_t mn = 255, mx = 0;
        for (int64_t j = 0; j < block; ++j) {
            if (p[j] < mn) mn = p[j];
            if (p[j] > mx) mx = p[j];
        }
        int range = mx - mn;
        int w = 0;
        while ((1 << w) - 1 < range) ++w;
        widths[b] = (uint8_t)w;
        mins[b] = mn;
        if (w == 0) continue;
        for (int64_t j = 0; j < block; ++j) {
            acc |= (uint64_t)(p[j] - mn) << accbits;
            accbits += w;
            while (accbits >= 8) {
                payload[out++] = (uint8_t)(acc & 0xFF);
                acc >>= 8;
                accbits -= 8;
            }
        }
    }
    if (accbits > 0) payload[out++] = (uint8_t)(acc & 0xFF);
    return out;
}

// u16 variant (same layout; widths 0..16, mins u16) for index-increment
// streams like the CNN centre-T deltas whose values are tiny but whose
// worst case needs 16 bits.
int64_t blockpack_u16(const uint16_t* v, int64_t n, int64_t block,
                      uint8_t* payload, uint8_t* widths, uint16_t* mins) {
    int64_t nb = n / block;
    uint64_t acc = 0;
    int accbits = 0;
    int64_t out = 0;
    for (int64_t b = 0; b < nb; ++b) {
        const uint16_t* p = v + b * block;
        uint16_t mn = 65535, mx = 0;
        for (int64_t j = 0; j < block; ++j) {
            if (p[j] < mn) mn = p[j];
            if (p[j] > mx) mx = p[j];
        }
        uint32_t range = (uint32_t)mx - mn;
        int w = 0;
        while ((1u << w) - 1 < range) ++w;
        widths[b] = (uint8_t)w;
        mins[b] = mn;
        if (w == 0) continue;
        for (int64_t j = 0; j < block; ++j) {
            acc |= (uint64_t)(p[j] - mn) << accbits;
            accbits += w;
            while (accbits >= 8) {
                payload[out++] = (uint8_t)(acc & 0xFF);
                acc >>= 8;
                accbits -= 8;
            }
        }
    }
    if (accbits > 0) payload[out++] = (uint8_t)(acc & 0xFF);
    return out;
}

// Eventalign table rows (columns per /root/reference/src/alignment.cpp:
// 701-733): one row per raw sample — refCoord, kmerRef, scaledSample,
// kmerStrand, modelMean.  Insertion rows print N^k for the strand column
// and a literal 0 model mean.  Row arrays arrive pre-exploded (one entry
// per OUTPUT row); this routine only slices/revcomps k-mers and formats —
// python's per-row f-string loop was ~60% of align's host time.
long long format_eventalign_rows(
    const long long* coords, const long long* kstarts,
    const unsigned char* is_ins, const double* values, const double* mmeans,
    long long n_rows, const char* seq, long long seq_len, long long k,
    long long is_reverse, char* out, long long out_cap) {
    static const auto comp = [] {
        std::array<char, 256> t{};
        for (int i = 0; i < 256; ++i) t[i] = 'N';
        t['A'] = 'T'; t['C'] = 'G'; t['G'] = 'C'; t['T'] = 'A';
        t['a'] = 't'; t['c'] = 'g'; t['g'] = 'c'; t['t'] = 'a';
        return t;
    }();
    long long w = 0;
    char kmer_ref[64], kmer_strand[64];
    if (k >= 63) return -2;
    for (long long r = 0; r < n_rows; ++r) {
        long long ks = kstarts[r];
        if (ks < 0 || ks + k > seq_len) return -3;
        for (long long j = 0; j < k; ++j) kmer_strand[j] = seq[ks + j];
        kmer_strand[k] = 0;
        if (is_reverse) {
            for (long long j = 0; j < k; ++j)
                kmer_ref[j] = comp[(unsigned char)kmer_strand[k - 1 - j]];
        } else {
            for (long long j = 0; j < k; ++j) kmer_ref[j] = kmer_strand[j];
        }
        kmer_ref[k] = 0;
        if (w + 64 + 2 * k > out_cap) return -1;
        if (is_ins[r]) {
            for (long long j = 0; j < k; ++j) kmer_strand[j] = 'N';
            w += snprintf(out + w, out_cap - w, "%lld\t%s\t%.6f\t%s\t0\n",
                          coords[r], kmer_ref, values[r], kmer_strand);
        } else {
            w += snprintf(out + w, out_cap - w,
                          "%lld\t%s\t%.6f\t%s\t%.6f\n",
                          coords[r], kmer_ref, values[r],
                          kmer_strand, mmeans[r]);
        }
    }
    return w;
}

}  // extern "C"
