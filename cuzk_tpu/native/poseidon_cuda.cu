// Poseidon sponge and raw permutation for Hopper (sm_90a), one state per
// thread, called from JAX through the XLA FFI (cuzk_tpu.ops.poseidon_kernel).
//
// The arithmetic is poseidon_fr.h, the same code the host test shim
// compiles with g++.  Each block copies the 192 round constants (6 KB) into
// shared memory once; every thread of a warp then reads the same constant
// in the same round, which shared memory serves as a broadcast.
//
// Inputs are bucket-padded by the Python wrapper; ``active`` (a device
// int32) holds the true element count, and threads past it exit before any
// arithmetic, so padding costs launch geometry only.
//
// Build (done at first use by cuzk_tpu.native.ensure_cuda_built):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> poseidon_cuda.cu

#include <cuda_runtime.h>

#include <cstdint>

#include "poseidon_fr.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

using cuzk::Fe;
using cuzk::u32;
using cuzk::u64;

constexpr int kBlock = 128;

struct RcShared {
  const Fe *t;
  __device__ Fe operator()(int i) const { return t[i]; }
};

__device__ void load_rc(Fe *smem, const u64 *rc) {
  u64 *dst = reinterpret_cast<u64 *>(smem);
  for (int i = threadIdx.x; i < cuzk::kNumRc * 4; i += blockDim.x) dst[i] = rc[i];
  __syncthreads();
}

// inputs [b, n, 16] digits -> out [b, 16] digits (state[1] after squeeze).
__global__ void __launch_bounds__(kBlock)
    sponge_kernel(const u32 *in, int n, u64 ds, const u64 *rc,
                  const int32_t *active, u32 *out) {
  __shared__ Fe rc_s[cuzk::kNumRc];
  load_rc(rc_s, rc);
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= *active) return;
  const u32 *x = in + t * n * cuzk::kDigits;
  auto input = [x](int i) { return cuzk::from_digits(x + cuzk::kDigits * i); };
  Fe h = cuzk::sponge(input, n, ds, RcShared{rc_s});
  cuzk::to_digits(h, out + t * cuzk::kDigits);
}

// states [b, 3, 16] -> [b, 3, 16]; any 256-bit state (full round-0 add).
__global__ void __launch_bounds__(kBlock)
    permutation_kernel(const u32 *in, const u64 *rc, const int32_t *active,
                       u32 *out) {
  __shared__ Fe rc_s[cuzk::kNumRc];
  load_rc(rc_s, rc);
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= *active) return;
  const int64_t base = t * cuzk::kT * cuzk::kDigits;
  Fe s[cuzk::kT];
  for (int i = 0; i < cuzk::kT; ++i)
    s[i] = cuzk::from_digits(in + base + cuzk::kDigits * i);
  cuzk::permute(s, RcShared{rc_s}, true);
  for (int i = 0; i < cuzk::kT; ++i)
    cuzk::to_digits(s[i], out + base + cuzk::kDigits * i);
}

ffi::Error check_common(ffi::Buffer<ffi::U32> rc, ffi::Buffer<ffi::S32> active) {
  if (rc.element_count() != (size_t)cuzk::kNumRc * 8)
    return ffi::Error::InvalidArgument("rc must hold 192 x 8 uint32 words");
  if (active.element_count() != 1)
    return ffi::Error::InvalidArgument("active must be one int32");
  return ffi::Error::Success();
}

ffi::Error launch_status() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("poseidon kernel launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error SpongeImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> inputs,
                      ffi::Buffer<ffi::U32> rc, ffi::Buffer<ffi::S32> active,
                      ffi::ResultBuffer<ffi::U32> out, int32_t ds) {
  auto dims = inputs.dimensions();
  if (dims.size() != 3 || dims[2] != cuzk::kDigits)
    return ffi::Error::InvalidArgument("inputs must be [b, n, 16] uint32");
  ffi::Error e = check_common(rc, active);
  if (e.failure()) return e;
  const int64_t b = dims[0];
  if (b == 0) return ffi::Error::Success();
  const int blocks = (int)((b + kBlock - 1) / kBlock);
  sponge_kernel<<<blocks, kBlock, 0, stream>>>(
      inputs.typed_data(), (int)dims[1], (u64)ds,
      reinterpret_cast<const u64 *>(rc.typed_data()), active.typed_data(),
      out->typed_data());
  return launch_status();
}

ffi::Error PermutationImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> states,
                           ffi::Buffer<ffi::U32> rc,
                           ffi::Buffer<ffi::S32> active,
                           ffi::ResultBuffer<ffi::U32> out) {
  auto dims = states.dimensions();
  if (dims.size() != 3 || dims[1] != cuzk::kT || dims[2] != cuzk::kDigits)
    return ffi::Error::InvalidArgument("states must be [b, 3, 16] uint32");
  ffi::Error e = check_common(rc, active);
  if (e.failure()) return e;
  const int64_t b = dims[0];
  if (b == 0) return ffi::Error::Success();
  const int blocks = (int)((b + kBlock - 1) / kBlock);
  permutation_kernel<<<blocks, kBlock, 0, stream>>>(
      states.typed_data(), reinterpret_cast<const u64 *>(rc.typed_data()),
      active.typed_data(), out->typed_data());
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CuzkPoseidonSponge, SpongeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int32_t>("ds"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(CuzkPoseidonPermutation, PermutationImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());
