// The partitionable threefry-2x32 draw of multiraft_tpu_torch/utils/prng.py
// (random_bits, randint, uniform) as one kernel, for Hopper (sm_90a).  Built
// into the same ctypes library as raft_kernels.cu (engine/kernels.py).
//
// It replaces no Pallas kernel: the JAX package draws with jax.random, and
// the port's plain version (prng.py on the CPU) rebuilds that draw from
// int64 tensor ops with 32-bit masks.  On the card that plain draw was 391
// launches and 3.9 ms of device time a tick for the tick's [G, P] election
// jitter (G=600,000, P=3), so it is done here in one launch.
//
// What it computes.  Element e of the flat draw has the 64-bit counter
// offset + e, whose (hi, lo) words go through the 20-round threefry block
// under the key; its 32 bits are the xor of the two output words.  Then,
// by sampler: random_bits stores the bits (zero-extended to int64, as the
// plain version returns them); uniform stores (bits >> 9 | 0x3F800000) as
// a float32, minus 1; randint draws two bit streams under the two halves
// of split(key) and combines them as jax's _randint does, in uint32:
// ((hi % span) * mult + lo % span) % span + minval, stored as int32.
//
// Its arguments.  With a key on the host, prng.py derives the key words
// (fold_in, split) in Python integers and passes them, with span, mult,
// minval and the offset's two words, as launch arguments.  With a key on
// the card the kernel reads the key's two words from device memory and,
// for randint, derives split(key) itself, once a block: the host never
// waits for the card.
//
// What bounds it.  Integer issue: about 80 integer operations a threefry
// block (20 rounds of add, rotate and xor, and the key injections), two
// blocks and three remainders an element for randint, against a 4-byte
// store.  At G=600,000 x P=3 that is about 0.4 G operations against 7.2 MB.
//
// Design.  Each rotate is one funnel shift (__funnelshift_l); the rounds
// are unrolled with the key schedule in registers.  One thread computes 4
// consecutive elements (8 threefry blocks for randint, independent of each
// other, so their latencies overlap) and stores them with one 16-byte
// vector store (two for int64), the last, partial, vector element by
// element.  A grid-stride loop covers any size with at most as many blocks
// as the card holds at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // elements a thread a step: 16 bytes of int32
constexpr int kBlocksPerSm = 2048 / kThreads;  // Hopper: 2,048 threads an SM

enum Sampler : int { kBits = 0, kRandint = 1, kUniform = 2 };

struct DrawArgs {
  const uint32_t* key;  // a key on the card (two words), or null
  uint32_t k[4];        // host key words: (k1, k2), or randint's split keys
  uint32_t span, mult;
  int32_t minval;
  uint64_t offset;
  int64_t n;
  void* out;
};

struct Words {
  uint32_t x0, x1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The 20-round threefry-2x32 block of prng._threefry2x32.
__device__ __forceinline__ Words threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return {x0, x1};
}

__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1, uint32_t hi,
                                         uint32_t lo) {
  const Words w = threefry2x32(k0, k1, hi, lo);
  return w.x0 ^ w.x1;
}

template <int S>
struct Out;
template <>
struct Out<kBits> {
  using T = int64_t;
};
template <>
struct Out<kRandint> {
  using T = int32_t;
};
template <>
struct Out<kUniform> {
  using T = float;
};

template <int S>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(const __grid_constant__ DrawArgs a) {
  using T = typename Out<S>::T;
  uint32_t k[4] = {a.k[0], a.k[1], a.k[2], a.k[3]};
  if (a.key != nullptr) {  // the same for every thread of the grid
    __shared__ uint32_t sk[4];
    if (threadIdx.x == 0) {
      const uint32_t w0 = a.key[0], w1 = a.key[1];
      if constexpr (S == kRandint) {  // split(key, 2): counters (0, 0) and (0, 1)
        const Words h = threefry2x32(w0, w1, 0u, 0u);
        const Words l = threefry2x32(w0, w1, 0u, 1u);
        sk[0] = h.x0, sk[1] = h.x1, sk[2] = l.x0, sk[3] = l.x1;
      } else {
        sk[0] = w0, sk[1] = w1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) k[i] = sk[i];
  }
  T* out = static_cast<T*>(a.out);
  // The values of one step, seen as 16-byte words for the vector stores.
  union Step {
    T v[kVec];
    uint4 q[sizeof(T) * kVec / 16];
  };
  const int64_t nvec = (a.n + kVec - 1) / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    const int64_t e0 = v * kVec;
    Step s;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint64_t c = a.offset + static_cast<uint64_t>(e0 + j);
      const uint32_t hi = static_cast<uint32_t>(c >> 32);
      const uint32_t lo = static_cast<uint32_t>(c);
      if constexpr (S == kRandint) {
        const uint32_t h = bits(k[0], k[1], hi, lo) % a.span;
        const uint32_t l = bits(k[2], k[3], hi, lo) % a.span;
        const uint32_t off = h * a.mult + l;  // wraps at 2**32, as jax's
        s.v[j] = static_cast<T>(off % a.span + static_cast<uint32_t>(a.minval));
      } else if constexpr (S == kUniform) {
        const uint32_t b = bits(k[0], k[1], hi, lo);
        s.v[j] = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
      } else {
        s.v[j] = static_cast<T>(bits(k[0], k[1], hi, lo));
      }
    }
    if (e0 + kVec <= a.n) {
      uint4* o = reinterpret_cast<uint4*>(out + e0);
#pragma unroll
      for (int i = 0; i < static_cast<int>(sizeof(s.q) / 16); ++i) o[i] = s.q[i];
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (e0 + j < a.n) out[e0 + j] = s.v[j];
    }
  }
}

template <int S>
int launch(const DrawArgs& a, int grid, cudaStream_t stream) {
  threefry_kernel<S><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// n draws of `sampler` (0 random_bits -> int64, 1 randint -> int32,
// 2 uniform -> float32) into `out` (16-byte aligned), the flat counters
// offset_hi:offset_lo + 0 .. n-1.  Key: `key`, two uint32 words on the
// card, or, where `key` is null, k0..k3 (random_bits and uniform read k0,
// k1; randint the halves of split(key): k0, k1 for the high draw, k2, k3
// for the low).  randint also takes span (>= 1), mult and minval.  The grid
// is as many blocks as the step count needs, and at most as many as `sms`
// SMs hold at once.  Returns cudaGetLastError() after the launch.
int mrt_threefry(int sampler, const void* key, uint32_t k0, uint32_t k1,
                 uint32_t k2, uint32_t k3, uint32_t span, uint32_t mult,
                 int minval, uint32_t offset_hi, uint32_t offset_lo, int64_t n,
                 void* out, int sms, void* stream) {
  if (n <= 0) return 0;
  if (sms < 1 || (sampler == kRandint && span == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const DrawArgs a{static_cast<const uint32_t*>(key),
                   {k0, k1, k2, k3},
                   span,
                   mult,
                   minval,
                   (static_cast<uint64_t>(offset_hi) << 32) | offset_lo,
                   n,
                   out};
  const int64_t blocks = ((n + kVec - 1) / kVec + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(
      blocks < int64_t{sms} * kBlocksPerSm ? blocks : int64_t{sms} * kBlocksPerSm);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sampler) {
    case kBits:
      return launch<kBits>(a, grid, s);
    case kRandint:
      return launch<kRandint>(a, grid, s);
    case kUniform:
      return launch<kUniform>(a, grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
