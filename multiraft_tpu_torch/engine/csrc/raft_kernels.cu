// Leader-side consensus reductions of the batched multi-Raft tick, for
// Hopper (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and bound with ctypes (multiraft_tpu_torch/engine/kernels.py).
//
// Replaces the Pallas TPU kernels of multiraft_tpu/engine/pallas_ops.py:
//   quorum_commit  <- _commit_kernel (launched by quorum_commit_pallas)
//   vote_tally     <- _tally_kernel  (launched by vote_tally_pallas)
//
// Design.  The TPU kernels transpose to groups-last and pad G to blocks
// of 512 so that G rides the 128-wide lane, and read the log ring
// through a one-hot over all L lanes.  Here one thread owns one (g, p)
// row of the row-major [G,P,...] tensors as they are: no transpose, no
// padding, the ragged edge masked.  A thread reads is_leader and commit;
// only a leader loads its P-entry row and runs the O(P^2) count, and
// only a leader whose quorum index passes its commit reads base, term
// and the single ring word it needs.  Every thread writes one value.
// Neighbouring threads read neighbouring rows, so the loads coalesce.
//
// Bounds on an H100 SXM (3.35 TB/s).  Both kernels do a few integer
// operations per byte, so bytes bound them.  quorum_commit at the
// headline shape (G=10,000, P=3, L=192), with one leader per group,
// must read is_leader (30 KB) and commit (120 KB) and write 120 KB;
// eff_match (360 KB), term, base and base_term (120 KB each) and at most
// 10,000 ring words (0.32 MB as 32-byte sectors) only for leaders.
// That is at most about 1.3 MB, about 0.4 us, far below one launch, so
// the kernel is launch-bound there.  vote_tally moves about 270 KB
// there.  At G=100,000 x P=5 the commit kernel moves at most about
// 24 MB (7 us), less where fewer leaders advance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 32;

// Floor mod, as jnp.remainder: C's % truncates toward zero.
__device__ __forceinline__ int floor_mod(int a, int m) {
  return ((a % m) + m) % m;
}

// Only a leader reads its eff_match row, and only a leader whose quorum
// index is past its commit reads base, term and the one ring (or
// base_term) word; every other row writes its commit back.  The loops
// run to the runtime P over a local array of kMaxP.
__global__ void quorum_commit_kernel(
    const int* __restrict__ eff_match, const int* __restrict__ term,
    const int* __restrict__ commit, const int* __restrict__ base,
    const int* __restrict__ base_term, const int* __restrict__ log_term,
    const uint8_t* __restrict__ is_leader, int* __restrict__ out,
    int rows, int P, int L, int quorum) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;  // g * P + p
  if (row >= rows) return;
  const int c = commit[row];
  if (is_leader[row] == 0) {
    out[row] = c;
    return;
  }
  int m[kMaxP];
  const int* mr = eff_match + static_cast<int64_t>(row) * P;
  for (int k = 0; k < P; ++k) m[k] = mr[k];
  // q = max_j (cnt_j >= quorum ? m[j] : 0), cnt_j = #{k : m[k] >= m[j]}.
  int q = 0;
  for (int j = 0; j < P; ++j) {
    int cnt = 0;
    for (int k = 0; k < P; ++k) cnt += m[k] >= m[j];
    const int v = cnt >= quorum ? m[j] : 0;
    q = j == 0 ? v : max(q, v);
  }
  if (q <= c) {
    out[row] = c;
    return;
  }
  const int q_term =
      q == base[row]
          ? base_term[row]
          : log_term[static_cast<int64_t>(row) * L + floor_mod(q, L)];
  out[row] = q_term == term[row] ? q : c;
}

__global__ void vote_tally_kernel(
    const uint8_t* __restrict__ votes, const int* __restrict__ role,
    const uint8_t* __restrict__ alive, uint8_t* __restrict__ out,
    int rows, int P, int quorum) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;  // g * P + p
  if (row >= rows) return;
  if (role[row] != 1 || alive[row] == 0) {
    out[row] = 0;
    return;
  }
  const uint8_t* vr = votes + static_cast<int64_t>(row) * P;
  int n = 0;
  for (int k = 0; k < P; ++k) n += vr[k] != 0;
  out[row] = n >= quorum;
}

}  // namespace

extern "C" {

// new commit i32[G,P] from eff_match i32[G,P,P], term/commit/base/
// base_term i32[G,P], log_term i32[G,P,L], is_leader bool[G,P].
// Returns cudaGetLastError() after the launch.
int mrt_quorum_commit(const void* eff_match, const void* term,
                      const void* commit, const void* base,
                      const void* base_term, const void* log_term,
                      const void* is_leader, void* out, int G, int P, int L,
                      int quorum, void* stream) {
  const int rows = G * P;
  if (rows <= 0) return 0;
  if (P > kMaxP || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kThreads - 1) / kThreads;
  quorum_commit_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(eff_match), static_cast<const int*>(term),
      static_cast<const int*>(commit), static_cast<const int*>(base),
      static_cast<const int*>(base_term), static_cast<const int*>(log_term),
      static_cast<const uint8_t*>(is_leader), static_cast<int*>(out), rows,
      P, L, quorum);
  return static_cast<int>(cudaGetLastError());
}

// become_leader bool[G,P] from votes bool[G,P,P], role i32[G,P],
// alive bool[G,P].  Returns cudaGetLastError() after the launch.
int mrt_vote_tally(const void* votes, const void* role, const void* alive,
                   void* out, int G, int P, int quorum, void* stream) {
  const int rows = G * P;
  if (rows <= 0) return 0;
  const int blocks = (rows + kThreads - 1) / kThreads;
  vote_tally_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(votes), static_cast<const int*>(role),
      static_cast<const uint8_t*>(alive), static_cast<uint8_t*>(out), rows,
      P, quorum);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
