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
// terms sit in shared memory and are indexed directly. D spans 8..16384, so
// the mapping of threads to rows follows D: a team of G = D/4 lanes (2..32,
// a power of two) owns a row, each lane reads 4 elements per step (4 B of
// uint8 or 8 B of uint16: a warp's loads cover whole contiguous rows) and
// keeps the 2K sums in registers, reduced with __shfl_xor_sync inside the
// team; rows of D >= 2048 take a whole block, whose 8 warp sums meet in
// shared memory and are added in a fixed order. The team's first lane scores
// the pairs (fully unrolled over K, so the sums stay in registers). A row
// without a standard variant allele can never be a candidate, so its
// elements are not read at all.
//
// The uint8 and the uint16 form of one tile give the SAME flags: both visit
// the elements in the same lanes and order, and both take their per-qual
// terms from the same non-inlined device functions (the uint8 form through
// its table, the uint16 form per element), with explicitly rounded
// arithmetic so that the compiler fuses nothing differently in the two.
//
// Bound: memory. Each element of a row that has a standard variant allele is
// read once (1 or 2 B, plus 1 B of MAPQ in the tumor form), plus 4 B of flag
// word and 1 B of output per row. The uint16 and tumor forms pay powf/logf
// per element and may be bound by those instead; the uint8 germline form
// (the one native tiles ship) does two shared-memory reads per element.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDeepRow = 2048;             // rows this wide take a whole block
constexpr int kMaxBlocks = 132 * 32;       // 32 blocks per SM of an H100 SXM

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

template <typename PackT, bool kTumor, int K>
__device__ __forceinline__ void add_element(unsigned v, unsigned mq,
                                            const float* tab_x,
                                            const float* tab_y, float (&c)[K],
                                            float (&g)[K], int& any_valid) {
  constexpr unsigned kEmpty = sizeof(PackT) == 1 ? 0xFFu : 0xFFFFu;
  if (v == kEmpty) return;
  any_valid = 1;
  const int aid = static_cast<int>(v & 0xFu);
  if (aid >= K) return;  // counts as valid, belongs to no allele
  float2 xy;
  if constexpr (sizeof(PackT) == 1) {
    const unsigned qi = v >> 4;
    if constexpr (kTumor) {
      xy = tumor_terms(tab_x[qi], phred_error(static_cast<float>(mq)));
    } else {
      xy = make_float2(tab_x[qi], tab_y[qi]);
    }
  } else {
    const float q = static_cast<float>(v >> 4);
    if constexpr (kTumor) {
      xy = tumor_terms(phred_error(q), phred_error(static_cast<float>(mq)));
    } else {
      xy = germline_terms(q);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (aid == k) {
      c[k] += xy.x;
      g[k] += xy.y;
    }
  }
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
                     int64_t L, int D, int n_alleles, int team, bool block_row,
                     bool vec4, float margin, bool use_gate, float gq_floor,
                     uint8_t* __restrict__ out) {
  __shared__ float tab_x[16];
  __shared__ float tab_y[16];
  __shared__ float partial[kWarps][2 * K + 1];
  const int t = threadIdx.x;
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
    __syncthreads();
  }
  const unsigned kmask = (1u << n_alleles) - 1u;
  const int rows_per_block = block_row ? 1 : kThreads / team;
  const int member = block_row ? t : t % team;   // this thread's place in its team
  const int stride = block_row ? kThreads : team;
  // Every thread of a block runs the same number of iterations, so the
  // shuffles and (in block_row mode, where the row is uniform across the
  // block) the barriers are reached by all.
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * rows_per_block;
       base < L; base += static_cast<int64_t>(gridDim.x) * rows_per_block) {
    const int64_t row = block_row ? base : base + t / team;
    const bool active = row < L;
    const unsigned fw = active ? flag_words[row] : 0u;
    const unsigned iv = fw & kmask;
    const unsigned sa = (fw >> 16) & kmask;
    const bool work = active && (iv & sa) != 0;
    if (!__any_sync(kFullMask, work)) {
      if (active && member == 0) out[row] = 0;
      continue;
    }
    float c[K], g[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c[k] = 0.0f;
      g[k] = 0.0f;
    }
    int any_valid = 0;
    if (work) {
      const PackT* prow = pack + row * D;
      const uint8_t* mrow = kTumor ? mapq + row * D : nullptr;
      if (vec4) {
        for (int e = member * 4; e < D; e += stride * 4) {
          unsigned v[4];
          if constexpr (sizeof(PackT) == 1) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(prow + e);
            v[0] = w & 0xFFu;
            v[1] = (w >> 8) & 0xFFu;
            v[2] = (w >> 16) & 0xFFu;
            v[3] = w >> 24;
          } else {
            const uint2 w = *reinterpret_cast<const uint2*>(prow + e);
            v[0] = w.x & 0xFFFFu;
            v[1] = w.x >> 16;
            v[2] = w.y & 0xFFFFu;
            v[3] = w.y >> 16;
          }
          unsigned m = 0;
          if constexpr (kTumor)
            m = *reinterpret_cast<const uint32_t*>(mrow + e);
#pragma unroll
          for (int s = 0; s < 4; ++s)
            add_element<PackT, kTumor, K>(v[s], (m >> (8 * s)) & 0xFFu, tab_x,
                                          tab_y, c, g, any_valid);
        }
      } else {
        for (int e = member; e < D; e += stride)
          add_element<PackT, kTumor, K>(prow[e], kTumor ? mrow[e] : 0u, tab_x,
                                        tab_y, c, g, any_valid);
      }
    }
    const int width = block_row ? 32 : team;
    for (int off = width >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        c[k] += __shfl_xor_sync(kFullMask, c[k], off);
        g[k] += __shfl_xor_sync(kFullMask, g[k], off);
      }
      any_valid |= __shfl_xor_sync(kFullMask, any_valid, off);
    }
    if (block_row) {
      // `work` is uniform across the block here, and true.
      const int wid = t >> 5;
      if ((t & 31) == 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          partial[wid][k] = c[k];
          partial[wid][K + k] = g[k];
        }
        partial[wid][2 * K] = static_cast<float>(any_valid);
      }
      __syncthreads();
      if (t == 0) {
        for (int w = 1; w < kWarps; ++w) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            c[k] += partial[w][k];
            g[k] += partial[w][K + k];
          }
          any_valid |= partial[w][2 * K] != 0.0f;
        }
      }
    }
    if (active && member == 0) {
      bool cand = false;
      if (work && any_valid)
        cand = decide<K>(c, g, iv, sa, margin, use_gate, gq_floor);
      out[row] = cand ? 1 : 0;
    }
    if (block_row) __syncthreads();  // `partial` is rewritten by the next row
  }
}

template <typename PackT, bool kTumor, int K>
cudaError_t launch(const void* pack, const void* mapq, const void* flag_words,
                   const QualTable& qt, int64_t L, int D, int n_alleles,
                   float margin, bool use_gate, float gq_floor, void* out,
                   cudaStream_t stream) {
  const bool block_row = D >= kDeepRow;
  int team = 2;
  while (team < 32 && team * 8 <= D) team *= 2;  // D/4 lanes, 2..32
  const uintptr_t p = reinterpret_cast<uintptr_t>(pack);
  const uintptr_t m = reinterpret_cast<uintptr_t>(mapq);
  const bool vec4 = D % 4 == 0 && p % (4 * sizeof(PackT)) == 0 &&
                    (!kTumor || m % 4 == 0);
  const int64_t rows_per_block = block_row ? 1 : kThreads / team;
  int64_t blocks = (L + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ll_screen_kernel<PackT, kTumor, K>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const PackT*>(pack), static_cast<const uint8_t*>(mapq),
          static_cast<const uint32_t*>(flag_words), qt, L, D, n_alleles, team,
          block_row, vec4, margin, use_gate, gq_floor,
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
// written for every row.
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
