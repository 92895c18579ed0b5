// rANS order-0 lane scan for NVIDIA Hopper, called from JAX through the XLA
// foreign function interface (kanzi_tpu/ops/ans_cuda.py).
//
// Wire semantics are those of the XLA reference in kanzi_tpu/ops/ans.py
// (ANSRangeEncoder.java:263-407, ANSRangeDecoder.java:100-581): 4
// interleaved states per chunk, logRange 12, ANS_TOP 1<<15, 16-bit
// renormalization.  One thread owns one chunk: its 4 states stay in
// registers for the whole chain, and its frequency tables live in shared
// memory.  The XLA reference instead launches one loop body per step.
//
// Build (kanzi_tpu/utils/native.py build_cuda):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o libkanzi_cuda.so ans_cuda.cu

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kLogRange = 12;
constexpr uint32_t kScale = 1u << kLogRange;
constexpr uint32_t kAnsTop = 1u << 15;
constexpr int kEncodeChunksPerBlock = 32;  // 32 KiB of tables per block
constexpr int kDecodeChunksPerBlock = 8;   // 40 KiB of tables per block
constexpr int kDecodeTableBytes = 256 * 4 + kScale;

// Encode one chunk per thread.  Scan step t covers positions 4s..4s+3 with
// s = steps-1-t; lane j encodes position 4s+3-j.  The forward payload order
// is reverse scan steps, lanes 3..0 within a step, so the thread writes its
// words backwards from the end of its row and moves them to the front once.
__global__ void ans0_encode_kernel(const uint8_t* __restrict__ chunks,
                                   const int32_t* __restrict__ freq,
                                   const int32_t* __restrict__ cum,
                                   int64_t n, int64_t c,
                                   uint16_t* __restrict__ payload,
                                   int32_t* __restrict__ n_emit,
                                   int32_t* __restrict__ states) {
  __shared__ uint32_t tab[kEncodeChunksPerBlock * 256];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kEncodeChunksPerBlock;
  for (int k = threadIdx.x; k < kEncodeChunksPerBlock * 256; k += blockDim.x) {
    const int64_t row = base + k / 256;
    if (row < n) {
      const int64_t i = row * 256 + k % 256;
      const uint32_t f = min(static_cast<uint32_t>(freq[i]), kScale - 1);
      tab[k] = f | (static_cast<uint32_t>(cum[i]) << 16);
    }
  }
  __syncthreads();
  const int64_t row = base + threadIdx.x;
  if (row >= n) return;
  const uint32_t* t = tab + threadIdx.x * 256;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(chunks + row * c);
  uint16_t* out = payload + row * c;
  uint32_t st[4] = {kAnsTop, kAnsTop, kAnsTop, kAnsTop};
  int64_t w = c;
  for (int64_t s = c / 4 - 1; s >= 0; --s) {
    const uint32_t word = __ldg(src + s);  // byte 4s+k is bits 8k..8k+7
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t e = t[(word >> (8 * (3 - j))) & 0xFF];
      const uint32_t f = e & 0xFFFF;
      uint32_t x = st[j];
      if ((x >> 19) >= f) {
        out[--w] = static_cast<uint16_t>(x & 0xFFFF);
        x >>= 16;
      }
      const uint32_t q = x / f;
      st[j] = (q << kLogRange) + (x - q * f) + (e >> 16);
    }
  }
  const int64_t ne = c - w;
  for (int64_t i = 0; i < ne; ++i) out[i] = out[w + i];
  n_emit[row] = static_cast<int32_t>(ne);
  for (int j = 0; j < 4; ++j) states[row * 4 + j] = static_cast<int32_t>(st[j]);
}

// Decode one chunk per thread.  The 4 states share one read pointer and
// refill in lane order 3, 2, 1, 0; reads past the payload row clamp to its
// last byte, as the XLA reference does.
__global__ void ans0_decode_kernel(const uint8_t* __restrict__ payload,
                                   int64_t p,
                                   const int32_t* __restrict__ states,
                                   const int32_t* __restrict__ freq,
                                   const int32_t* __restrict__ cum,
                                   int64_t n, int64_t chunk,
                                   uint8_t* __restrict__ out,
                                   int32_t* __restrict__ consumed) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kDecodeChunksPerBlock
                      + threadIdx.x;
  if (row >= n) return;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + threadIdx.x * kDecodeTableBytes);
  uint8_t* slot = smem + threadIdx.x * kDecodeTableBytes + 256 * 4;
  for (int s = 0; s < 256; ++s) {
    const uint32_t f = static_cast<uint32_t>(freq[row * 256 + s]);
    const uint32_t cm = static_cast<uint32_t>(cum[row * 256 + s]);
    tab[s] = min(f, kScale - 1) | (cm << 16);
    for (uint32_t k = cm; k < min(cm + f, kScale); ++k) slot[k] = static_cast<uint8_t>(s);
  }
  const uint8_t* pay = payload + row * p;
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + row * chunk);
  uint32_t st[4];
  for (int j = 0; j < 4; ++j) st[j] = static_cast<uint32_t>(states[row * 4 + j]);
  int64_t ptr = 0;
  for (int64_t t = 0; t < chunk / 4; ++t) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t sym = slot[st[j] & (kScale - 1)];
      const uint32_t e = tab[sym];
      st[j] = (e & 0xFFFF) * (st[j] >> kLogRange) + (st[j] & (kScale - 1)) - (e >> 16);
      word |= sym << (8 * (3 - j));  // block order: lane 3 first
    }
    dst[t] = word;
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      if (st[j] < kAnsTop) {
        const uint32_t b0 = __ldg(pay + (ptr < p ? ptr : p - 1));
        const uint32_t b1 = __ldg(pay + (ptr + 1 < p ? ptr + 1 : p - 1));
        st[j] = (st[j] << 16) | (b0 << 8) | b1;
        ptr += 2;
      }
    }
  }
  consumed[row] = static_cast<int32_t>(ptr);
}

ffi::Error launch_status() {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error Ans0EncodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> chunks,
                          ffi::Buffer<ffi::S32> freq, ffi::Buffer<ffi::S32> cum,
                          ffi::ResultBuffer<ffi::U16> payload,
                          ffi::ResultBuffer<ffi::S32> n_emit,
                          ffi::ResultBuffer<ffi::S32> states) {
  const auto dims = chunks.dimensions();
  if (dims.size() != 2 || dims[1] % 4 != 0)
    return ffi::Error::InvalidArgument("chunks must be [N, C] with C % 4 == 0");
  const int64_t n = dims[0], c = dims[1];
  if (n == 0) return ffi::Error::Success();
  const unsigned blocks = static_cast<unsigned>((n + kEncodeChunksPerBlock - 1)
                                                / kEncodeChunksPerBlock);
  ans0_encode_kernel<<<blocks, kEncodeChunksPerBlock, 0, stream>>>(
      chunks.typed_data(), freq.typed_data(), cum.typed_data(), n, c,
      payload->typed_data(), n_emit->typed_data(), states->typed_data());
  return launch_status();
}

ffi::Error Ans0DecodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> payload,
                          ffi::Buffer<ffi::S32> states, ffi::Buffer<ffi::S32> freq,
                          ffi::Buffer<ffi::S32> cum,
                          ffi::ResultBuffer<ffi::U8> out,
                          ffi::ResultBuffer<ffi::S32> consumed) {
  const auto pdims = payload.dimensions();
  const auto odims = out->dimensions();
  if (pdims.size() != 2 || pdims[1] < 1 || odims[1] % 4 != 0)
    return ffi::Error::InvalidArgument("payload [N, P>0], out [N, C % 4 == 0]");
  const int64_t n = pdims[0];
  if (n == 0) return ffi::Error::Success();
  const unsigned blocks = static_cast<unsigned>((n + kDecodeChunksPerBlock - 1)
                                                / kDecodeChunksPerBlock);
  ans0_decode_kernel<<<blocks, kDecodeChunksPerBlock,
                       kDecodeChunksPerBlock * kDecodeTableBytes, stream>>>(
      payload.typed_data(), pdims[1], states.typed_data(), freq.typed_data(),
      cum.typed_data(), n, odims[1], out->typed_data(), consumed->typed_data());
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(KzAns0Encode, Ans0EncodeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U16>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(KzAns0Decode, Ans0DecodeImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
