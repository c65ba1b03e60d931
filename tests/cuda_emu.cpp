// Runs the CUDA banded-fill block body (dnascent_tpu/cuda/banded_fill_kernel.h)
// on the CPU: one std::thread per CUDA thread, a std::barrier for
// __syncthreads, one block after another.  Test-only: it checks the kernel
// source's indexing and arithmetic where there is no GPU.
//
// g++ -std=c++20 -O2 -ffp-contract=off -pthread -shared -fPIC \
//     -I dnascent_tpu/cuda tests/cuda_emu.cpp -o cuda_emu.so

#include <barrier>
#include <thread>
#include <vector>

static thread_local std::barrier<>* g_barrier = nullptr;
#define BF_SYNC() g_barrier->arrive_and_wait()

#include "banded_fill_kernel.h"

extern "C" void banded_fill_emulated(
    const float* events, const float* mu, const float* inv_sigma,
    const float* lp_const, const int32_t* n_events, const int32_t* n_kmers,
    const float* lp_stay, const float* lp_step, uint8_t* trace,
    uint8_t* rights, int32_t* best_event, float* best_score, int B, int E,
    int K, int W, int S, float lp_skip, float lp_trim) {
  dnascent::BandedArgs a;
  a.events = events;
  a.mu = mu;
  a.inv_sigma = inv_sigma;
  a.lp_const = lp_const;
  a.n_events = n_events;
  a.n_kmers = n_kmers;
  a.lp_stay = lp_stay;
  a.lp_step = lp_step;
  a.trace = trace;
  a.rights = rights;
  a.best_event = best_event;
  a.best_score = best_score;
  a.B = B;
  a.E = E;
  a.K = K;
  a.W = W;
  a.S = S;
  a.lp_skip = lp_skip;
  a.lp_trim = lp_trim;
  const int threads = (W + 31) / 32 * 32;
  std::vector<float> smem(dnascent::banded_smem_floats(W));
  for (int b = 0; b < B; ++b) {
    std::barrier<> bar(threads);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) {
      pool.emplace_back([&, t] {
        g_barrier = &bar;
        dnascent::banded_fill_block(a, b, t, threads, smem.data());
      });
    }
    for (auto& th : pool) th.join();
  }
}
