// Adaptive banded event-alignment fill: one thread block per read.
//
// Same contract and arithmetic as ops/banded.banded_fill (the XLA scan, and
// the reference's event_handling.cpp:148-340), but the whole band loop runs
// inside one block instead of one XLA loop iteration per four bands:
//
// * thread o owns band cell o (W = bandwidth cells, padded to a warp
//   multiple); the last three bands live in a shared-memory ring with one
//   -inf pad cell on each side, so the +-1-cell predecessor shifts are plain
//   shared-memory reads and a band costs one __syncthreads;
// * emission coefficients and events are staged in shared-memory windows
//   every CHUNK_BANDS bands (a band moves by one cell, so CHUNK_BANDS + W
//   entries cover a chunk);
// * the 2-bit trace codes of four bands are packed per cell and stored
//   coalesced, the right/down bits by thread 0;
// * the final-k-mer start-cell search runs every band, as in the scan.
//
// Arithmetic uses round-to-nearest intrinsics in the scan's operation order
// (no FMA contraction), so a cell's score equals the CPU scan's bit for bit.
//
// The body is written against a few macros so that the same source also
// compiles as plain C++ with one std::thread per CUDA thread (see
// tests/cuda_emu.cpp): nvcc is the only compiler that sees __CUDACC__.

#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#define BF_DEVICE __device__ __forceinline__
#define BF_HOSTDEV __host__ __device__ __forceinline__
#define BF_SYNC() __syncthreads()
#define BF_FADD(a, b) __fadd_rn((a), (b))
#define BF_FSUB(a, b) __fsub_rn((a), (b))
#define BF_FMUL(a, b) __fmul_rn((a), (b))
#else
#define BF_DEVICE inline
#define BF_HOSTDEV inline
// the including translation unit defines BF_SYNC() as a block barrier
#define BF_FADD(a, b) ((a) + (b))
#define BF_FSUB(a, b) ((a) - (b))
#define BF_FMUL(a, b) ((a) * (b))
#endif

namespace dnascent {

constexpr int kChunkSteps = 16;               // 4-band steps per window refill
constexpr int kChunkBands = 4 * kChunkSteps;
constexpr int kFromD = 0, kFromU = 1, kFromL = 2;

struct BandedArgs {
  const float* events;     // (B, E) scaled event means
  const float* mu;         // (B, K) model mean per query k-mer
  const float* inv_sigma;  // (B, K)
  const float* lp_const;   // (B, K) log(1/(sigma*sqrt(2pi))), -inf undefined
  const int32_t* n_events;  // (B,)
  const int32_t* n_kmers;   // (B,)
  const float* lp_stay;     // (B,) per-read transition log-probabilities
  const float* lp_step;     // (B,)
  uint8_t* trace;           // (S, B, W) 4 x 2-bit codes per byte
  uint8_t* rights;          // (S, B) 4 right/down bits per byte
  int32_t* best_event;      // (B,)
  float* best_score;        // (B,)
  int B, E, K, W, S;
  float lp_skip, lp_trim;
};

// floats of shared memory one block needs
BF_HOSTDEV int banded_smem_floats(int W) {
  return 3 * (W + 2) + 4 * (kChunkBands + W);
}

BF_DEVICE float bf_max(float x, float y) { return x > y ? x : y; }

// One block's work: read b, thread `tid` of `nthreads`, `smem` the block's
// shared memory (banded_smem_floats(W) floats).
BF_DEVICE void banded_fill_block(const BandedArgs& a, int b, int tid,
                                 int nthreads, float* smem) {
  const float NEG = -INFINITY;
  const int W = a.W;
  const int half = W / 2;
  const int CW = kChunkBands + W;
  const int RW = W + 2;  // ring row: pad, W cells, pad
  float* ring = smem;
  float* w_mu = ring + 3 * RW;
  float* w_is = w_mu + CW;
  float* w_lc = w_is + CW;
  float* w_ev = w_lc + CW;

  const float* ev = a.events + (int64_t)b * a.E;
  const float* mu = a.mu + (int64_t)b * a.K;
  const float* is = a.inv_sigma + (int64_t)b * a.K;
  const float* lc = a.lp_const + (int64_t)b * a.K;
  const int n_ev = a.n_events[b];
  const int n_km = a.n_kmers[b];
  const float lp_stay = a.lp_stay[b];
  const float lp_step = a.lp_step[b];
  const int o = tid;
  const bool live = o < W;

  // bands 0 and 1 (event_handling.cpp:212-228) in ring rows 0 and 1
  for (int i = tid; i < 3 * RW; i += nthreads) {
    const int r = i / RW, c = i - r * RW - 1;
    float v = NEG;
    if (c == half && r == 0) v = 0.0f;
    if (c == half && r == 1) v = a.lp_trim;
    ring[i] = v;
  }

  int e0 = half, k0 = -1 - half;
  int right_prev = 0;
  float best_score = NEG;
  int best_event = 0;
  int kb = 0, eb = 0;  // window bases
  int band = 2;

  for (int s = 0; s < a.S; ++s) {
    if (s % kChunkSteps == 0) {
      // every thread is past the previous band's barrier, so nobody still
      // reads the old windows
      kb = k0;
      eb = e0 - W + 1;
      for (int j = tid; j < CW; j += nthreads) {
        const int k = kb + j, e = eb + j;
        const bool kin = k >= 0 && k < a.K;
        w_mu[j] = kin ? mu[k] : 0.0f;
        w_is[j] = kin ? is[k] : 1.0f;
        w_lc[j] = kin ? lc[k] : NEG;
        w_ev[j] = (e >= 0 && e < a.E) ? ev[e] : 0.0f;
      }
      BF_SYNC();
    }
    int code_byte = 0, right_byte = 0;
    for (int jj = 0; jj < 4; ++jj, ++band) {
      const float* p1 = ring + ((band - 1) % 3) * RW + 1;
      const float* p2 = ring + ((band - 2) % 3) * RW + 1;
      float* out = ring + (band % 3) * RW + 1;
      const float ll = p1[0], ur = p1[W - 1];
      const int right = (ll == NEG && ur == NEG) ? (band % 2 == 1)
                                                 : (ll < ur ? 1 : 0);
      e0 += 1 - right;
      k0 += right;
      if (live) {
        const int k = k0 + o, e = e0 - o;
        float val = NEG;
        int frm = 0;
        if (e >= 0 && e < n_ev && k >= 0 && k < n_km) {
          const float up = right ? p1[o + 1] : p1[o];
          const float left = right ? p1[o] : p1[o - 1];
          const int dd = right + right_prev;
          const float diag = dd == 0 ? p2[o - 1] : (dd == 1 ? p2[o] : p2[o + 1]);
          const float x = BF_FMUL(BF_FSUB(w_ev[e - eb], w_mu[k - kb]),
                                  w_is[k - kb]);
          const float em = BF_FSUB(w_lc[k - kb], BF_FMUL(BF_FMUL(0.5f, x), x));
          const float sd = BF_FADD(BF_FADD(diag, lp_step), em);
          const float su = BF_FADD(BF_FADD(up, lp_stay), em);
          const float sl = BF_FADD(left, a.lp_skip);
          // tie-break mirrors event_handling.cpp:300-306
          const float max_du = bf_max(sd, su);
          const int from_du = max_du == su ? kFromU : kFromD;
          val = bf_max(max_du, sl);
          frm = val == sl ? kFromL : from_du;
        }
        // trim state (event_handling.cpp:255-265)
        const int ot = -1 - k0, e_trim = e0 - ot;
        if (o == ot && e_trim >= 0 && e_trim < n_ev) {
          val = BF_FMUL(a.lp_trim, BF_FADD((float)e_trim, 1.0f));
          frm = kFromU;
        }
        out[o] = val;
        code_byte |= frm << (2 * jj);
      }
      right_byte |= right << jj;
      right_prev = right;
      BF_SYNC();
      // final-k-mer start cell (event_handling.cpp:324-340), evaluated by
      // every thread on the shared band so the running best stays uniform
      const int o_fin = (n_km - 1) - k0, e_fin = e0 - o_fin;
      if (o_fin >= 0 && o_fin < W && e_fin >= 0 && e_fin < n_ev) {
        const float cand = BF_FADD(out[o_fin],
                                   BF_FMUL((float)(n_ev - e_fin), a.lp_trim));
        if (cand > best_score) {
          best_score = cand;
          best_event = e_fin;
        }
      }
    }
    if (live) a.trace[((int64_t)s * a.B + b) * W + o] = (uint8_t)code_byte;
    if (tid == 0) a.rights[(int64_t)s * a.B + b] = (uint8_t)right_byte;
  }
  if (tid == 0) {
    a.best_event[b] = best_event;
    a.best_score[b] = best_score;
  }
}

}  // namespace dnascent
