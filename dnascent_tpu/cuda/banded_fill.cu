// XLA FFI binding of the banded fill kernel (banded_fill_kernel.h).
// Built by dnascent_tpu/cuda/__init__.py for sm_90a.

#include <cuda_runtime.h>

#include "banded_fill_kernel.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

__global__ void banded_fill_kernel(dnascent::BandedArgs args) {
  extern __shared__ float smem[];
  dnascent::banded_fill_block(args, blockIdx.x, threadIdx.x, blockDim.x,
                              smem);
}

ffi::Error BandedFillImpl(cudaStream_t stream,
                          ffi::Buffer<ffi::F32> events,
                          ffi::Buffer<ffi::F32> mu,
                          ffi::Buffer<ffi::F32> inv_sigma,
                          ffi::Buffer<ffi::F32> lp_const,
                          ffi::Buffer<ffi::S32> n_events,
                          ffi::Buffer<ffi::S32> n_kmers,
                          ffi::Buffer<ffi::F32> lp_stay,
                          ffi::Buffer<ffi::F32> lp_step,
                          float lp_skip, float lp_trim,
                          ffi::ResultBuffer<ffi::U8> trace,
                          ffi::ResultBuffer<ffi::U8> rights,
                          ffi::ResultBuffer<ffi::S32> best_event,
                          ffi::ResultBuffer<ffi::F32> best_score) {
  const auto ed = events.dimensions();
  const auto td = trace->dimensions();
  dnascent::BandedArgs a;
  a.events = events.typed_data();
  a.mu = mu.typed_data();
  a.inv_sigma = inv_sigma.typed_data();
  a.lp_const = lp_const.typed_data();
  a.n_events = n_events.typed_data();
  a.n_kmers = n_kmers.typed_data();
  a.lp_stay = lp_stay.typed_data();
  a.lp_step = lp_step.typed_data();
  a.trace = trace->typed_data();
  a.rights = rights->typed_data();
  a.best_event = best_event->typed_data();
  a.best_score = best_score->typed_data();
  a.B = static_cast<int>(ed[0]);
  a.E = static_cast<int>(ed[1]);
  a.K = static_cast<int>(mu.dimensions()[1]);
  a.S = static_cast<int>(td[0]);
  a.W = static_cast<int>(td[2]);
  a.lp_skip = lp_skip;
  a.lp_trim = lp_trim;
  if (a.W < 2 || a.W > 1024) {
    return ffi::Error::InvalidArgument("bandwidth must be in [2, 1024]");
  }
  if (a.B == 0) return ffi::Error::Success();
  const int threads = (a.W + 31) / 32 * 32;
  const size_t smem = sizeof(float) * dnascent::banded_smem_floats(a.W);
  banded_fill_kernel<<<a.B, threads, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    DnascentBandedFill, BandedFillImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()   // events
        .Arg<ffi::Buffer<ffi::F32>>()   // mu
        .Arg<ffi::Buffer<ffi::F32>>()   // inv_sigma
        .Arg<ffi::Buffer<ffi::F32>>()   // lp_const
        .Arg<ffi::Buffer<ffi::S32>>()   // n_events
        .Arg<ffi::Buffer<ffi::S32>>()   // n_kmers
        .Arg<ffi::Buffer<ffi::F32>>()   // lp_stay
        .Arg<ffi::Buffer<ffi::F32>>()   // lp_step
        .Attr<float>("lp_skip")
        .Attr<float>("lp_trim")
        .Ret<ffi::Buffer<ffi::U8>>()    // trace
        .Ret<ffi::Buffer<ffi::U8>>()    // rights
        .Ret<ffi::Buffer<ffi::S32>>()   // best_event
        .Ret<ffi::Buffer<ffi::F32>>()); // best_score
