// Genotype-likelihood candidate screen for Hopper (sm_90a).
//
// Built by guacamole_tpu_torch/ops/build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes. The entry point launches on
// the stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch. Built WITHOUT --use_fast_math: the flags below come out of f32
// comparisons, and powf/logf/expf/log10f must be the precise forms.
//
// Replaces guacamole_tpu/ops/pallas_kernels.py::_ll_screen_kernel (launched
// by pallas_likelihood_screen). Plain version:
// guacamole_tpu_torch/ops/kernels.py::ll_screen.
//
// Input wire form (guacamole_tpu_torch/ops/dispatch.py::ll_wire_from_numpy):
//   pack   [L, D] uint16  allele | qual << 4, 0xFFFF = empty slot, or
//          [L, D] uint8   allele | qual_index << 4, 0xFF = empty slot, with a
//                         qual dictionary of at most 16 phred values (passed
//                         by value as a launch parameter)
//   mapq   [L, D] uint8   per-element read MAPQ (tumor form only)
//   flags  [L]    uint32  bit k: allele k is a variant; bit 16 + k: allele k
//                         is a standard allele (a genotype may use it)
// Output: [L] uint8 0/1 (a torch.bool tensor).
//
// Per row: per-allele sums C_k and G_k of the m=0 and m=2 log terms
// (germline: log 2err and log(2 - 2err), err = 10^(-q/10); tumor: log 2(1-pc)
// and log 2pc with pc = (1-err_q)(1-err_m) and the stable complement
// err_q + err_m - err_q err_m); the K(K+1)/2 pairs of standard alleles score
// -C_i - C_j (i != j) or -C_i + G_i; the row is a candidate when it has a
// standard variant allele, a valid element, and best_variant >= best_ref -
// margin. With min_phred > 0 (germline only) a candidate is dropped when the
// genotype quality of its best pair, in runner/total form with a 2-phred
// safety band, cannot reach min_phred. This GQ gate must stay in sync with
// its three other implementations: guacamole_tpu/ops/kernels.py
// (_screen_from_allele_sums), guacamole_tpu/ops/pallas_kernels.py
// (_ll_screen_kernel) and native/guac_pack.cpp (ll_candidates), and with the
// plain version named above.
//
// Design. The TPU kernel's shape does not carry over: its 128/256-row
// blocks and its block_l * D <= 64k rule are Mosaic's VMEM limits, and its
// 16-way select exists because VMEM cannot be indexed. Here the per-qual
// terms, and in the tumor form the 256 MAPQ errors, sit in shared memory
// (built once per block by the functions that serve the untabulated path,
// so a tabulated value has the same bits) and are indexed directly.
//  - Only live rows reach the body. A row without a standard variant allele
//    can never be a candidate (78% of a main-path tile). A warp owns a
//    group of up to 128 consecutive rows: it reads their flag words
//    coalesced, ballots (iv & sa) != 0, writes the live rows' indices to a
//    list in shared memory and hands them to its lanes from that list, so
//    lanes are busy whatever the live share is. Flags meet in shared memory
//    (dead rows are 0) and leave as one coalesced store of 4-byte words.
//    Where rows take teams of lanes a group is one round of rows (a team
//    fills its lanes whatever is live); with one thread a row it shrinks
//    from 128 rows only when the tile has too few rows to give every SM
//    four warps.
//  - Routes by D, chosen per launch. A row is cut into steps of E elements
//    (16 where D allows, else 8, 4 or 1): one or two 16-byte loads. Up to
//    D = 64 a row takes ONE thread: there is no shuffle, and every lane
//    scores its own row. Deeper rows take a team of G = 2..32 lanes (at
//    least two steps a lane), step s going to lane s mod G, reduced with
//    __shfl_xor_sync inside the team, scored by the team's first lane; from
//    D = 1024 that is a warp per row, and every row of a deep tile has its
//    own warp.
//  - Loads in flight: a lane starts the loads of 64 bytes of its row (and
//    the MAPQ bytes beside them) before it adds the first element.
//  - Elements leave a step's registers by funnel shifts, so the loop over
//    elements is rolled and the code of one element exists once. A thread's
//    2K running sums lie in its own column of a [2K][256] array in shared
//    memory (bank = thread, so no conflicts) and are indexed by the
//    element's allele: two loads, two adds, two stores an element, where
//    sums in registers cost K compares and 2K predicated adds (on the card
//    0.0387 ms against 0.0319 ms for a 1M x 32 tile, the same bits).
//
// The uint8 and the uint16 form of one tile give the SAME flags: E, G and
// the group size depend on D and L only, so both forms visit the elements
// in the same lanes and order, and both take their per-qual terms from the
// same non-inlined device functions (the uint8 form through its table, the
// uint16 form per element), with explicitly rounded arithmetic so that the
// compiler fuses nothing differently in the two.
//
// Bound: memory. Each element of a row that has a standard variant allele is
// read once (1 or 2 B, plus 1 B of MAPQ in the tumor form), plus 4 B of flag
// word and 1 B of output per row. At a main-path tile that is a few
// microseconds, less than a launch costs, so the time to judge is the
// larger of the bound and the launch floor (chip_smoke.py prints both).
// The uint16 forms pay powf/logf per element, the tumor forms two logf.
// What holds it is the loop over elements: on an NVIDIA H100 80GB HBM3 at
// 700 W, of the 0.032 ms (germline) and 0.073 ms (tumor) of a 1M x 32 uint8
// tile, leaving that loop out saves 64% and 71%, the pair scores 14% and
// 12%; flag words, live lists and the flags' stores are the 0.007 ms that
// stay (chip_tune.py --no-check; PERF.md).
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kThreadRowDepth = 64;   // rows up to this deep take one thread
constexpr int kMaxGroupRows = 128;    // rows a warp screens for live ones at once
constexpr int kBlocksPerSm = 8;       // the grid's cap, per SM
constexpr int kWantedWarpsPerSm = 4;  // a group shrinks only below these

struct QualTable {
  uint8_t q[16];
  int n;
};

// Non-inlined, explicitly rounded: the table and the per-element path run
// the very same instructions, so equal quals give equal terms.
__device__ __noinline__ float phred_error(float q) {
  return powf(10.0f, __fdiv_rn(q, -10.0f));
}

// (x, y): the m=0 and the m=2 log term of one element.
__device__ __noinline__ float2 germline_terms(float q) {
  const float two_err = __fmul_rn(2.0f, phred_error(q));
  return make_float2(
      logf(two_err),                      // finite: err > 0
      logf(__fsub_rn(2.0f, two_err)));    // -inf only at q == 0
}

__device__ __noinline__ float2 tumor_terms(float err_q, float err_m) {
  const float pc =
      __fmul_rn(__fsub_rn(1.0f, err_q), __fsub_rn(1.0f, err_m));
  const float one_minus_pc =              // stable complement
      __fsub_rn(__fadd_rn(err_q, err_m), __fmul_rn(err_q, err_m));
  return make_float2(logf(__fmul_rn(2.0f, one_minus_pc)),
                     logf(__fmul_rn(2.0f, pc)));
}

// One step of a row in registers: up to 16 elements, the first in the low
// bits of w[0].
template <typename PackT>
struct Step {
  static constexpr int kWords = 4 * sizeof(PackT);
  uint32_t w[kWords];
};

// n elements at p, which is aligned to min(16, n * sizeof(PackT)) bytes;
// n is 16, 8, 4 or 1.
template <typename PackT>
__device__ __forceinline__ void load_step(const PackT* p, int n,
                                          Step<PackT>& s) {
#pragma unroll
  for (int i = 0; i < Step<PackT>::kWords; ++i) s.w[i] = 0;
  const int bytes = n * static_cast<int>(sizeof(PackT));
  if (bytes >= 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    s.w[0] = q.x;
    s.w[1] = q.y;
    s.w[2] = q.z;
    s.w[3] = q.w;
    if constexpr (sizeof(PackT) == 2) {
      if (bytes == 32) {
        const uint4 r = *(reinterpret_cast<const uint4*>(p) + 1);
        s.w[4] = r.x;
        s.w[5] = r.y;
        s.w[6] = r.z;
        s.w[7] = r.w;
      }
    }
  } else if (bytes == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    s.w[0] = q.x;
    s.w[1] = q.y;
  } else if (bytes == 4) {
    s.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    s.w[0] = *p;
  }
}

// Takes the step's first element out and moves the others down.
template <typename PackT>
__device__ __forceinline__ unsigned next_element(Step<PackT>& s) {
  constexpr int kBits = 8 * sizeof(PackT);
  constexpr int kLast = Step<PackT>::kWords - 1;
  const unsigned v = s.w[0] & ((1u << kBits) - 1u);
#pragma unroll
  for (int i = 0; i < kLast; ++i)
    s.w[i] = __funnelshift_r(s.w[i], s.w[i + 1], kBits);
  s.w[kLast] >>= kBits;
  return v;
}

template <typename PackT, bool kTumor, int K>
__device__ __forceinline__ void add_element(unsigned v, unsigned mq,
                                            const float* tab_x,
                                            const float* tab_y,
                                            const float* tab_m, float* sums,
                                            int& any_valid) {
  constexpr unsigned kEmpty = sizeof(PackT) == 1 ? 0xFFu : 0xFFFFu;
  if (v == kEmpty) return;
  any_valid = 1;
  const int aid = static_cast<int>(v & 0xFu);
  if (aid >= K) return;  // counts as valid, belongs to no allele
  float2 xy;
  if constexpr (sizeof(PackT) == 1) {
    const unsigned qi = v >> 4;
    if constexpr (kTumor) {
      xy = tumor_terms(tab_x[qi], tab_m[mq]);
    } else {
      xy = make_float2(tab_x[qi], tab_y[qi]);
    }
  } else {
    const float q = static_cast<float>(v >> 4);
    if constexpr (kTumor) {
      xy = tumor_terms(phred_error(q), tab_m[mq]);
    } else {
      xy = germline_terms(q);
    }
  }
  // This thread's column of the block's sums: c_k at row k, g_k at K + k.
  sums[aid * kThreads] += xy.x;
  sums[(K + aid) * kThreads] += xy.y;
}

// The decision for one row from its reduced sums. The caller has checked
// that the row has a standard variant allele (iv & sa != 0), which is
// any(pair_exists & pair_variant): the has_var guard of the other forms.
template <int K>
__device__ __forceinline__ bool decide(const float (&c)[K], const float (&g)[K],
                                       unsigned iv, unsigned sa, float margin,
                                       bool use_gate, float gq_floor) {
  float best_variant = -INFINITY;
  float best_ref = -INFINITY;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = i; j < K; ++j) {
      const bool exists = ((sa >> i) & (sa >> j) & 1u) != 0;
      const bool variant = (((iv >> i) | (iv >> j)) & 1u) != 0;
      const float score = (i == j) ? (-c[i] + g[i]) : (-c[i] - c[j]);
      if (exists) {
        if (variant) {
          best_variant = fmaxf(best_variant, score);
        } else {
          best_ref = fmaxf(best_ref, score);
        }
      }
    }
  }
  bool cand = best_variant >= best_ref - margin;
  if (cand && use_gate) {
    const float smax = fmaxf(best_variant, best_ref);
    // A row whose best score is not finite is kept (and -inf - -inf would
    // be NaN inside exp); pairs that do not exist are left out before exp.
    if (isfinite(smax)) {
      float total = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int j = i; j < K; ++j) {
          const bool exists = ((sa >> i) & (sa >> j) & 1u) != 0;
          const float score = (i == j) ? (-c[i] + g[i]) : (-c[i] - c[j]);
          if (exists) total += expf(score - smax);  // the best pair adds 1
        }
      }
      const float runner = fmaxf(total - 1.0f, 0.0f);  // no 1 - p cancellation
      const float one_minus =
          __fadd_rn(__fdiv_rn(runner, fmaxf(total, 1.0f)), 1e-10f);
      const float gq = -10.0f * log10f(one_minus);
      cand = gq >= gq_floor;
    }
  }
  return cand;
}

template <typename PackT, bool kTumor, int K>
__global__ void __launch_bounds__(kThreads)
    ll_screen_kernel(const PackT* __restrict__ pack,
                     const uint8_t* __restrict__ mapq,
                     const uint32_t* __restrict__ flag_words, QualTable qt,
                     int64_t L, int D, int n_alleles, int step, int team_log2,
                     int group_rows, float margin, bool use_gate,
                     float gq_floor, uint8_t* __restrict__ out) {
  // 64 bytes of a lane's row in flight: 4 steps of uint8, 2 of uint16.
  constexpr int kBatch = 4 / sizeof(PackT);
  static_assert(kThreads == 256, "one thread per MAPQ value builds tab_m");
  __shared__ float tab_x[16];
  __shared__ float tab_y[16];
  __shared__ float tab_m[kTumor ? 256 : 1];
  __shared__ float sums_all[2 * K][kThreads];
  float* sums = &sums_all[0][threadIdx.x];
  __shared__ uint8_t live_rows[kWarps][kMaxGroupRows];
  __shared__ __align__(4) uint8_t row_flags[kWarps][kMaxGroupRows];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wid = t >> 5;
  if constexpr (sizeof(PackT) == 1) {
    // Germline: the (x, y) terms of each dictionary qual; tumor: its error
    // in tab_x. Entries past the dictionary are 0, as the JAX forms pad.
    if (t < 16) {
      float2 xy = make_float2(0.0f, 0.0f);
      if (t < qt.n) {
        const float q = static_cast<float>(qt.q[t]);
        if constexpr (kTumor) {
          xy.x = phred_error(q);
        } else {
          xy = germline_terms(q);
        }
      }
      tab_x[t] = xy.x;
      tab_y[t] = xy.y;
    }
  }
  if constexpr (kTumor) tab_m[t] = phred_error(static_cast<float>(t));
  __syncthreads();
  const unsigned kmask = (1u << n_alleles) - 1u;
  const int team = 1 << team_log2;         // lanes that share a row
  const int member = lane & (team - 1);    // this lane's place in its team
  const int my_team = lane >> team_log2;
  const int rows_per_round = 32 >> team_log2;
  const int n_steps = D / step;
  const bool word_store =
      group_rows >= 4 && (reinterpret_cast<uintptr_t>(out) & 3u) == 0;
  uint8_t* live = live_rows[wid];
  uint8_t* flags = row_flags[wid];
  const int64_t n_groups = (L + group_rows - 1) / group_rows;
  // Every loop bound below is uniform across the warp, so all lanes reach
  // the votes, the shuffles and the __syncwarp()s.
  for (int64_t grp = static_cast<int64_t>(blockIdx.x) * kWarps + wid;
       grp < n_groups; grp += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t base = grp * group_rows;
    for (int i = lane; i < kMaxGroupRows / 4; i += 32)
      reinterpret_cast<uint32_t*>(flags)[i] = 0;
    int n_live = 0;
    for (int j = 0; j < group_rows; j += 32) {
      const int idx = j + lane;
      unsigned fw = 0;
      if (idx < group_rows && base + idx < L) fw = flag_words[base + idx];
      const bool is_live = (fw & (fw >> 16) & kmask) != 0;
      const unsigned votes = __ballot_sync(kFullMask, is_live);
      if (is_live)
        live[n_live + __popc(votes & ((1u << lane) - 1u))] =
            static_cast<uint8_t>(idx);
      n_live += __popc(votes);
    }
    __syncwarp();
    for (int n0 = 0; n0 < n_live; n0 += rows_per_round) {
      const bool has_row = n0 + my_team < n_live;
      const int idx = has_row ? live[n0 + my_team] : 0;
      const int64_t row = base + idx;
#pragma unroll
      for (int k = 0; k < 2 * K; ++k) sums[k * kThreads] = 0.0f;
      int any_valid = 0;
      if (has_row) {
        const PackT* prow = pack + row * D;
        const uint8_t* mrow = kTumor ? mapq + row * D : nullptr;
        for (int s0 = member; s0 < n_steps; s0 += team * kBatch) {
          Step<PackT> pk[kBatch];
          Step<uint8_t> mq[kBatch];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int s = s0 + b * team;
            if (s < n_steps) {
              load_step<PackT>(prow + s * step, step, pk[b]);
              if constexpr (kTumor)
                load_step<uint8_t>(mrow + s * step, step, mq[b]);
            } else {
#pragma unroll
              for (int i = 0; i < Step<PackT>::kWords; ++i) pk[b].w[i] = 0;
            }
            if (!kTumor || s >= n_steps) {
#pragma unroll
              for (int i = 0; i < 4; ++i) mq[b].w[i] = 0;
            }
          }
          // The steps in order, each taken from pk[0]; the others move up.
#pragma unroll 1
          for (int b = 0; b < kBatch && s0 + b * team < n_steps; ++b) {
#pragma unroll 1
            for (int e = 0; e < step; ++e) {
              const unsigned v = next_element<PackT>(pk[0]);
              const unsigned m = kTumor ? next_element<uint8_t>(mq[0]) : 0u;
              add_element<PackT, kTumor, K>(v, m, tab_x, tab_y, tab_m, sums,
                                            any_valid);
            }
#pragma unroll
            for (int i = 0; i + 1 < kBatch; ++i) {
              pk[i] = pk[i + 1];
              mq[i] = mq[i + 1];
            }
          }
        }
      }
      float c[K], g[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        c[k] = sums[k * kThreads];
        g[k] = sums[(K + k) * kThreads];
      }
      for (int off = team >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          c[k] += __shfl_xor_sync(kFullMask, c[k], off);
          g[k] += __shfl_xor_sync(kFullMask, g[k], off);
        }
        any_valid |= __shfl_xor_sync(kFullMask, any_valid, off);
      }
      if (has_row && member == 0 && any_valid) {
        const unsigned fw = flag_words[row];
        flags[idx] = decide<K>(c, g, fw & kmask, (fw >> 16) & kmask, margin,
                               use_gate, gq_floor)
                         ? 1
                         : 0;
      }
    }
    __syncwarp();
    if (word_store) {
      const int64_t r = base + 4 * lane;
      if (4 * lane < group_rows) {
        if (r + 4 <= L) {
          *reinterpret_cast<uint32_t*>(out + r) =
              reinterpret_cast<const uint32_t*>(flags)[lane];
        } else {
          for (int j = 0; j < 4; ++j)
            if (r + j < L) out[r + j] = flags[4 * lane + j];
        }
      }
    } else {
      for (int idx = lane; idx < group_rows; idx += 32)
        if (base + idx < L) out[base + idx] = flags[idx];
    }
    __syncwarp();  // the lists are rewritten for the next group
  }
}

// The device's count of SMs (asked once per device).
cudaError_t sm_count(int* n) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    rc = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                                dev);
    if (rc != cudaSuccess) return rc;
  }
  *n = cached[dev];
  return *n > 0 ? cudaSuccess : cudaErrorInvalidDevice;
}

// The step of a row D deep: 16 elements where D allows, else 8, 4 or 1.
// It depends on D alone, so both encodings of a tile are cut alike.
int step_of(int D) {
  return D % 16 == 0 ? 16 : D % 8 == 0 ? 8 : D % 4 == 0 ? 4 : 1;
}

template <typename PackT, bool kTumor, int K>
cudaError_t launch(const void* pack, const void* mapq, const void* flag_words,
                   const QualTable& qt, int64_t L, int D, int n_alleles,
                   float margin, bool use_gate, float gq_floor, void* out,
                   cudaStream_t stream) {
  int sms = 0;
  const cudaError_t asked = sm_count(&sms);
  if (asked != cudaSuccess) return asked;
  const int step = step_of(D);
  const int n_steps = D / step;
  // One thread per row up to kThreadRowDepth; beyond it the largest team of
  // 2..32 lanes that leaves every lane two steps.
  int team_log2 = 0;
  if (D > kThreadRowDepth)
    while (team_log2 < 5 && (4 << team_log2) <= n_steps) ++team_log2;
  // Rows a warp screens at once. With one thread a row, 128: about one
  // round of 32 of them is live on a main-path tile, so the lanes are busy.
  // A team fills its lanes whatever is live, so a warp of teams takes one
  // round of rows and more warps run side by side (on the card a warp a row
  // took a 10,240 x 1,024 tile in 0.061 ms with groups of one row, 0.151 ms
  // with groups of 16). Fewer, down to one round, while the tile is too
  // small to give every SM its warps.
  const int rows_per_round = 32 >> team_log2;
  int group_rows = team_log2 == 0 ? kMaxGroupRows : rows_per_round;
  while (group_rows > rows_per_round &&
         L < static_cast<int64_t>(group_rows) * kWantedWarpsPerSm * sms)
    group_rows >>= 1;
  const int64_t n_groups = (L + group_rows - 1) / group_rows;
  int64_t blocks = (n_groups + kWarps - 1) / kWarps;
  const int64_t max_blocks = static_cast<int64_t>(kBlocksPerSm) * sms;
  if (blocks > max_blocks) blocks = max_blocks;
  ll_screen_kernel<PackT, kTumor, K>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const PackT*>(pack), static_cast<const uint8_t*>(mapq),
          static_cast<const uint32_t*>(flag_words), qt, L, D, n_alleles, step,
          team_log2, group_rows, margin, use_gate, gq_floor,
          static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

template <typename PackT, bool kTumor>
cudaError_t launch_k(int n_alleles, const void* pack, const void* mapq,
                     const void* flag_words, const QualTable& qt, int64_t L,
                     int D, float margin, bool use_gate, float gq_floor,
                     void* out, cudaStream_t stream) {
  // Two register budgets: alleles beyond n_alleles are summed and never
  // scored (their flag bits are masked off).
  if (n_alleles <= 8)
    return launch<PackT, kTumor, 8>(pack, mapq, flag_words, qt, L, D,
                                    n_alleles, margin, use_gate, gq_floor, out,
                                    stream);
  return launch<PackT, kTumor, 15>(pack, mapq, flag_words, qt, L, D, n_alleles,
                                   margin, use_gate, gq_floor, out, stream);
}

}  // namespace

extern "C" {

// pack_bytes: 1 (uint8 qual-dictionary form; qvals points at n_qvals <= 16
// phred values in HOST memory, copied into the launch parameters) or 2
// (uint16 form; qvals is ignored). mapq: null for the germline form.
// min_phred > 0 turns the GQ gate on (germline form only). out [L] uint8 is
// written for every row. pack and mapq must be aligned to the bytes of one
// step of a row (see step_of), at most 16.
int guac_ll_screen(const void* pack, int pack_bytes, const void* mapq,
                   const void* qvals, int n_qvals, const void* flag_words,
                   int64_t L, int64_t D, int K, float margin, float min_phred,
                   void* out, void* stream) {
  if (K < 1 || K > 15 || D < 1 || D > (1 << 30) ||
      (pack_bytes != 1 && pack_bytes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  QualTable qt = {};
  if (pack_bytes == 1) {
    if (n_qvals < 0 || n_qvals > 16 || (n_qvals > 0 && qvals == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    qt.n = n_qvals;
    for (int i = 0; i < n_qvals; ++i)
      qt.q[i] = static_cast<const uint8_t*>(qvals)[i];
  }
  if (L <= 0) return static_cast<int>(cudaGetLastError());  // empty grid
  const bool tumor = mapq != nullptr;
  // A step is read with one or two vector loads: the planes must be
  // aligned to a step's bytes, or to 16 where a step is longer.
  const int step = step_of(static_cast<int>(D));
  const int pack_align = step * pack_bytes < 16 ? step * pack_bytes : 16;
  if (reinterpret_cast<uintptr_t>(pack) % pack_align != 0 ||
      (tumor && reinterpret_cast<uintptr_t>(mapq) % (step < 16 ? step : 16) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool use_gate = !tumor && min_phred > 0.0f;
  // min_phred - 2 in double, then narrowed: as the other forms compute it.
  const float gq_floor =
      static_cast<float>(static_cast<double>(min_phred) - 2.0);
  auto s = static_cast<cudaStream_t>(stream);
  const int d = static_cast<int>(D);
  cudaError_t rc;
  if (pack_bytes == 1) {
    rc = tumor ? launch_k<uint8_t, true>(K, pack, mapq, flag_words, qt, L, d,
                                         margin, use_gate, gq_floor, out, s)
               : launch_k<uint8_t, false>(K, pack, mapq, flag_words, qt, L, d,
                                          margin, use_gate, gq_floor, out, s);
  } else {
    rc = tumor ? launch_k<uint16_t, true>(K, pack, mapq, flag_words, qt, L, d,
                                          margin, use_gate, gq_floor, out, s)
               : launch_k<uint16_t, false>(K, pack, mapq, flag_words, qt, L, d,
                                           margin, use_gate, gq_floor, out, s);
  }
  return static_cast<int>(rc);
}

}  // extern "C"
