// Leader-side consensus reductions of the batched multi-Raft tick, for
// Hopper (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and bound with ctypes (multiraft_tpu_torch/engine/kernels.py).
//
// Replaces the Pallas TPU kernels of multiraft_tpu/engine/pallas_ops.py:
//   quorum_commit  <- _commit_kernel (launched by quorum_commit_pallas)
//   vote_tally     <- _tally_kernel  (launched by vote_tally_pallas)
//
// What bounds them.  Both do a few integer operations per byte, so
// bytes bound them on an H100 SXM (3.35 TB/s).  The bound counts what the
// data needs: quorum_commit must read is_leader and commit and write its
// output, and needs the eff_match row of a leader and, where a leader's
// quorum index passes its commit, its term and base words and one ring
// (or base_term) word.  With about one leader per group that is
// 934,320 B (0.279 us) at the headline shape G=10,000 x P=3, L=192, and
// 12,716,768 B (3.796 us) at G=100,000 x P=5.  vote_tally must read role
// and alive, write its output and read the vote rows of live candidates:
// 268,000 B (0.080 us) and 5,303,392 B (1.583 us).  At the headline
// shape both are far below one launch, so the launch is the floor there.
//
// Design.  The TPU kernels transpose to groups-last, pad G to blocks of
// 512 and read the ring through a one-hot over L.  Here the row-major
// [G,P,...] tensors are cut as they are into tiles of T consecutive
// (g, p) rows, T a multiple of 32.  A tile's slice of each per-row plane
// is one contiguous byte range whose size is a multiple of 16, so one
// thread stages the planes of a tile into shared memory with one
// cp.async.bulk each, all on one mbarrier: one round trip, with no
// registers or instructions spent on addresses.  The grid is persistent
// (kernels.tile_plan sizes it from the shared memory a block takes); each
// block walks tiles with stride gridDim.x through a ring of two stages,
// so the copies of its next tile are in flight while it computes this
// one.  A thread owns a row and counts its P entries straight from the
// staged tile: no row is held in a local array (ptxas reports no stack
// frame), and P stays a runtime argument.  Rows sit P words apart in
// shared memory: no bank conflicts for odd P, 2- to 4-way for even P.
//
// quorum_commit stages eff_match, commit and is_leader.  A row that is
// not a leader writes its commit back; the tile's leaders are compacted
// into the first warps of the block, so the O(P^2) count runs on as few
// warps as there are leaders (about one row in P), not on all of them.
// A leader whose quorum index passes its commit then reads its term,
// base and one ring word in a single round trip.  vote_tally stages
// votes, role and alive, and a live candidate counts its votes from the
// tile.  Each thread stores one value, neighbouring threads on
// neighbouring addresses.  The last tile, when rows % T != 0, is not a
// multiple of 16 bytes per plane and is loaded with ordinary guarded
// loads by the block that would walk it next.
//
// What it costs.  Staging whole tiles reads every row's eff_match and
// votes, not only a leader's or a candidate's: 4P + 5 bytes a row for
// quorum_commit and P + 5 for vote_tally, plus the output.  chip_smoke.py
// reports these bytes (design_bytes) beside the bound, and PERF.md the
// times against the parent kernels and the launch floor.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // the largest tile: one thread per row
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxP = 32;
constexpr int kStages = 2;
constexpr int kBarrierBytes = 16;  // kStages 8-byte mbarriers, padded to 16
constexpr int kMaxSmem = 232448;      // per block, Hopper
constexpr int kDefaultSmem = 49152;  // per block, without an opt-in

// Floor mod, as jnp.remainder: C's % truncates toward zero.
__device__ __forceinline__ int floor_mod(int a, int m) {
  return ((a % m) + m) % m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// quorum_commit's side of the tile walk.  A stage holds these planes of
// a tile of T rows, in this order, every offset a multiple of 16 bytes:
// eff_match (4TP bytes), commit (4T) and is_leader (T).  The block's
// scratch holds a count of leaders for each warp and the list of the
// tile's leader rows.
struct CommitOps {
  struct Args {
    const int* eff_match;
    const int* term;
    const int* commit;
    const int* base;
    const int* base_term;
    const int* log_term;
    const uint8_t* is_leader;
    int* out;
    int rows, P, L, quorum;
  };
  struct Stage {
    int* eff;
    int* commit;
    uint8_t* lead;
    __device__ Stage(unsigned char* s, int T, int P) {
      eff = reinterpret_cast<int*>(s);
      commit = eff + T * P;
      lead = reinterpret_cast<uint8_t*>(commit + T);
    }
  };
  __host__ __device__ static constexpr int row_bytes(int P) {
    return 4 * P + 5;
  }
  __host__ __device__ static constexpr int scratch_bytes(int T) {
    return 4 * kMaxWarps + 4 * T;
  }

  static __device__ __forceinline__ void issue(const Args& a, const Stage& s,
                                               uint64_t* bar, int tile,
                                               int T) {
    const int64_t r0 = static_cast<int64_t>(tile) * T;
    bar_expect(bar, static_cast<uint32_t>(T * row_bytes(a.P)));
    bulk_load(s.eff, a.eff_match + r0 * a.P, 4u * T * a.P, bar);
    bulk_load(s.commit, a.commit + r0, 4u * T, bar);
    bulk_load(s.lead, a.is_leader + r0, static_cast<uint32_t>(T), bar);
  }

  // The ragged last tile of n < T rows from row r0, with guarded loads.
  static __device__ __forceinline__ void load_ragged(const Args& a,
                                                     const Stage& s, int r0,
                                                     int n) {
    const int t = threadIdx.x;
    const int* src = a.eff_match + static_cast<int64_t>(r0) * a.P;
    for (int e = t; e < n * a.P; e += blockDim.x) s.eff[e] = src[e];
    if (t < n) {
      s.commit[t] = a.commit[r0 + t];
      s.lead[t] = a.is_leader[r0 + t];
    }
  }

  // Leader row r, tile row i.  The quorum index
  // q = max_j (cnt_j >= quorum ? m[j] : 0), cnt_j = #{k : m[k] >= m[j]},
  // is counted from shared memory.  Where q passes the commit, the row's
  // term, base and the ring word of q are read in one round trip (the
  // ring word even where q is the snapshot base, whose term then comes
  // from base_term).
  static __device__ __forceinline__ void leader(const Args& a, const Stage& s,
                                                int i, int r) {
    const int* m = s.eff + i * a.P;
    int q = INT_MIN;
    for (int j = 0; j < a.P; ++j) {
      const int mj = m[j];
      int cnt = 0;
#pragma unroll 4
      for (int k = 0; k < a.P; ++k) cnt += m[k] >= mj;
      q = max(q, cnt >= a.quorum ? mj : 0);
    }
    const int c = s.commit[i];
    int res = c;
    if (q > c) {
      const int tm = a.term[r];
      const int b = a.base[r];
      const int ring =
          a.log_term[static_cast<int64_t>(r) * a.L + floor_mod(q, a.L)];
      const int q_term = q == b ? a.base_term[r] : ring;
      if (q_term == tm) res = q;
    }
    a.out[r] = res;
  }

  // The n rows of a staged tile from row r0.  A row that is not a leader
  // writes its commit back.  The leaders are compacted into the first
  // threads of the block (a ballot in each warp, then an offset from the
  // counts of the warps before it), so that only as many warps as there
  // are leaders run the O(P^2) count.
  static __device__ __forceinline__ void tile(const Args& a, const Stage& s,
                                              int* scratch, int r0, int n) {
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    int* counts = scratch;
    int* list = scratch + kMaxWarps;
    const bool lead = t < n && s.lead[t] != 0;
    if (t < n && !lead) a.out[r0 + t] = s.commit[t];
    const unsigned ballot = __ballot_sync(0xffffffffu, lead);
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) {
      const int cw = counts[w];
      before += w < warp ? cw : 0;
      total += cw;
    }
    if (lead) list[before + __popc(ballot & ((1u << lane) - 1u))] = t;
    __syncthreads();
    if (t < total) leader(a, s, list[t], r0 + list[t]);
  }
};

// vote_tally's side of the tile walk.  A stage holds votes (TP bytes),
// role (4T) and alive (T).
struct TallyOps {
  struct Args {
    const uint8_t* votes;
    const int* role;
    const uint8_t* alive;
    uint8_t* out;
    int rows, P, quorum;
  };
  struct Stage {
    uint8_t* votes;
    int* role;
    uint8_t* alive;
    __device__ Stage(unsigned char* s, int T, int P) {
      votes = s;
      role = reinterpret_cast<int*>(s + T * P);
      alive = reinterpret_cast<uint8_t*>(role + T);
    }
  };
  __host__ __device__ static constexpr int row_bytes(int P) { return P + 5; }
  __host__ __device__ static constexpr int scratch_bytes(int) { return 0; }

  static __device__ __forceinline__ void issue(const Args& a, const Stage& s,
                                               uint64_t* bar, int tile,
                                               int T) {
    const int64_t r0 = static_cast<int64_t>(tile) * T;
    bar_expect(bar, static_cast<uint32_t>(T * row_bytes(a.P)));
    bulk_load(s.votes, a.votes + r0 * a.P, static_cast<uint32_t>(T) * a.P,
              bar);
    bulk_load(s.role, a.role + r0, 4u * T, bar);
    bulk_load(s.alive, a.alive + r0, static_cast<uint32_t>(T), bar);
  }

  static __device__ __forceinline__ void load_ragged(const Args& a,
                                                     const Stage& s, int r0,
                                                     int n) {
    const int t = threadIdx.x;
    const uint8_t* src = a.votes + static_cast<int64_t>(r0) * a.P;
    for (int e = t; e < n * a.P; e += blockDim.x) s.votes[e] = src[e];
    if (t < n) {
      s.role[t] = a.role[r0 + t];
      s.alive[t] = a.alive[r0 + t];
    }
  }

  // The n rows of a staged tile from row r0: a live candidate (role 1)
  // counts its P votes from shared memory.
  static __device__ __forceinline__ void tile(const Args& a, const Stage& s,
                                              int*, int r0, int n) {
    const int t = threadIdx.x;
    if (t >= n) return;
    uint8_t res = 0;
    if (s.role[t] == 1 && s.alive[t] != 0) {
      const uint8_t* v = s.votes + t * a.P;
      int granted = 0;
      for (int k = 0; k < a.P; ++k) granted += v[k] != 0;
      res = granted >= a.quorum;
    }
    a.out[r0 + t] = res;
  }
};

// The persistent walk shared by both kernels.  Shared memory holds the
// kStages barriers, the kernel's scratch and kStages staged tiles.  Block
// b computes the full tiles b, b + gridDim.x, ... through the ring of
// stages: thread 0 issues the bulk copies of the next tile before the
// block waits on this one.  The n-th use of a stage waits on its
// barrier's phase of parity n & 1.  The __syncthreads at the end of each
// tile keeps thread 0 from refilling a stage that a thread still reads.
// The ragged last tile, if any, goes to the block that would walk it
// next, after its ring has drained, so no copy is in flight when a block
// exits.
template <class Ops>
__device__ __forceinline__ void walk_tiles(const typename Ops::Args& a) {
  using Stage = typename Ops::Stage;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* scratch = reinterpret_cast<int*>(smem + kBarrierBytes);
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int first = kBarrierBytes + Ops::scratch_bytes(T);
  const int stage_bytes = T * Ops::row_bytes(a.P);
  auto stage = [&](int s) {
    return Stage(smem + first + s * stage_bytes, T, a.P);
  };
  const int grid = gridDim.x;
  const int full = a.rows / T;
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) bar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (static_cast<int>(blockIdx.x) < full)
      Ops::issue(a, stage(0), &bars[0], blockIdx.x, T);
  }
  __syncthreads();
  int it = 0;
  for (int tile = blockIdx.x; tile < full; tile += grid, ++it) {
    const int s = it & 1;
    const int next = tile + grid;
    if (t == 0 && next < full) Ops::issue(a, stage(s ^ 1), &bars[s ^ 1], next, T);
    bar_wait(&bars[s], (it >> 1) & 1);
    Ops::tile(a, stage(s), scratch, tile * T, T);
    __syncthreads();
  }
  const int ragged = a.rows - full * T;
  if (ragged > 0 && static_cast<int>(blockIdx.x) == full % grid) {
    Ops::load_ragged(a, stage(0), full * T, ragged);
    __syncthreads();
    Ops::tile(a, stage(0), scratch, full * T, ragged);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    quorum_commit_kernel(const __grid_constant__ CommitOps::Args a) {
  walk_tiles<CommitOps>(a);
}

__global__ void __launch_bounds__(kMaxThreads)
    vote_tally_kernel(const __grid_constant__ TallyOps::Args a) {
  walk_tiles<TallyOps>(a);
}

__global__ void empty_kernel() {}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Checks a tile plan against what kernel Ops takes: T rows a tile, one
// thread a row, a multiple of 32 and at most kMaxThreads; exactly the
// shared memory of the barriers, the scratch and kStages stages (the
// formula of kernels.tile_plan).
template <class Ops>
int check_plan(int P, int tile, int smem, int grid) {
  if (P < 1 || P > kMaxP || tile < 32 || tile > kMaxThreads || tile % 32 != 0 ||
      grid < 1 ||
      smem != kBarrierBytes + Ops::scratch_bytes(tile) +
                  kStages * tile * Ops::row_bytes(P))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Allows `kernel` `smem` bytes of dynamic shared memory where that is
// more than a block gets without asking.
int allow_smem(const void* kernel, int smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

extern "C" {

// new commit i32[G,P] from eff_match i32[G,P,P], term/commit/base/
// base_term i32[G,P], log_term i32[G,P,L], is_leader bool[G,P], with the
// tile plan (tile rows a block, smem bytes, grid blocks) of
// kernels.tile_plan.  The staged planes (eff_match, commit, is_leader)
// must be 16-byte aligned.  Returns cudaGetLastError() after the launch.
int mrt_quorum_commit(const void* eff_match, const void* term,
                      const void* commit, const void* base,
                      const void* base_term, const void* log_term,
                      const void* is_leader, void* out, int G, int P, int L,
                      int quorum, int tile, int smem, int grid, void* stream) {
  const int rows = G * P;
  if (rows <= 0) return 0;
  if (L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int rc = check_plan<CommitOps>(P, tile, smem, grid);
  if (rc != 0) return rc;
  if (!aligned16(eff_match) || !aligned16(commit) || !aligned16(is_leader))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if ((rc = allow_smem(reinterpret_cast<const void*>(quorum_commit_kernel),
                       smem)) != 0)
    return rc;
  const CommitOps::Args a{static_cast<const int*>(eff_match),
                          static_cast<const int*>(term),
                          static_cast<const int*>(commit),
                          static_cast<const int*>(base),
                          static_cast<const int*>(base_term),
                          static_cast<const int*>(log_term),
                          static_cast<const uint8_t*>(is_leader),
                          static_cast<int*>(out),
                          rows, P, L, quorum};
  quorum_commit_kernel<<<grid, tile, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// become_leader bool[G,P] from votes bool[G,P,P], role i32[G,P],
// alive bool[G,P], with the tile plan of kernels.tile_plan.  The staged
// planes (votes, role, alive) must be 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
int mrt_vote_tally(const void* votes, const void* role, const void* alive,
                   void* out, int G, int P, int quorum, int tile, int smem,
                   int grid, void* stream) {
  const int rows = G * P;
  if (rows <= 0) return 0;
  int rc = check_plan<TallyOps>(P, tile, smem, grid);
  if (rc != 0) return rc;
  if (!aligned16(votes) || !aligned16(role) || !aligned16(alive))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if ((rc = allow_smem(reinterpret_cast<const void*>(vote_tally_kernel),
                       smem)) != 0)
    return rc;
  const TallyOps::Args a{static_cast<const uint8_t*>(votes),
                         static_cast<const int*>(role),
                         static_cast<const uint8_t*>(alive),
                         static_cast<uint8_t*>(out), rows, P, quorum};
  vote_tally_kernel<<<grid, tile, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel launched like the two above (grid, threads, dynamic
// shared memory, stream): the least time any launch by this route takes.
// Returns cudaGetLastError() after the launch.
int mrt_empty(int grid, int threads, int smem, void* stream) {
  int rc = allow_smem(reinterpret_cast<const void*>(empty_kernel), smem);
  if (rc != 0) return rc;
  empty_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
