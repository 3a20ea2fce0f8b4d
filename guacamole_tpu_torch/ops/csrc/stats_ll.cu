// Fused dense-tile statistics and genotype log-likelihoods for Hopper
// (sm_90a).
//
// Built by guacamole_tpu_torch/ops/build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes. The entry point launches on
// the stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch. Built WITHOUT --use_fast_math: powf and logf are the precise forms.
//
// Replaces guacamole_tpu/ops/pallas_kernels.py::_stats_ll_kernel (launched
// by fused_tile_stats_ll, reached through tile_stats_ll). Plain version:
// guacamole_tpu_torch/ops/kernels.py::stats_ll_math.
//
// Inputs, in the tile's own types (guacamole_tpu_torch/pack/tiles.py, staged
// by guacamole_tpu_torch/ops/dispatch.py::dense_wire_from_numpy):
//   allele_id [L, D] int16   allele index, any value outside 0..K-1 (the
//                            packer writes -1) belongs to no allele
//   qual      [L, D] int16   base quality (phred); not read without `ll`
//   mapq      [L, D] int16   read mapping quality; read only with
//                            include_alignment
//   strand    [L, D] uint8   1 = forward strand (a torch.bool tensor)
//   valid     [L, D] uint8   1 = the slot holds an element
//   is_variant [L, K] uint8  1 = allele k is a variant at this locus
// Outputs:
//   counts, forward_counts [L, K] int32; depth [L] int32; candidates [L]
//   uint8 0/1; ll [L, P] f32 with P = K(K+1)/2 pairs (i <= j, i outer), or
//   no ll at all when the pointer is null (the screens read counts and flags
//   only, and then qual and mapq are not read either).
//
// Per row: counts of valid elements per allele and of those on the forward
// strand; depth = number of valid elements; the candidate flag: without a
// threshold, some variant allele has an element; with threshold t, an allele
// passes when count > 0 and count * 100 >= depth * (t + 1), and the row is a
// candidate when a variant allele passes or two reference alleles do (in
// int64: the same decision as the TPU kernel's f32 compare, which is exact
// below 2^24). The log-likelihood of genotype (i, j) is
//   sum_d log(p_i(d) + p_j(d)) - depth * log 2,
// p_a(d) = pc(d) if element d carries allele a, else 1 - pc(d), with
// pc = 1 - 10^(-qual/10), times 1 - 10^(-mapq/10) with include_alignment.
//
// Design. The TPU kernel unrolls K and P over whole [256, D] blocks in VMEM
// and takes P logs per element. Per element, log(p_i + p_j) takes only three
// values: log(2 pc) for the pair (a, a) of its own allele a, log(pc + (1 -
// pc)) for a pair with exactly one a, log(2 (1 - pc)) for a pair without a.
// So the kernel sums those three terms per allele (A_k, M_k, N_k: three logs
// an element instead of P; the middle term is not exactly 0 in f32 and is
// kept), and a pair's likelihood is
//   (i, i): A_i + sum_{k != i} N_k + N_none
//   (i, j): M_i + M_j + sum_{k != i, j} N_k + N_none
// with N_none over valid elements that belong to no allele. The N_k are
// added pair by pair, not subtracted from their total: a deep reference
// allele would cancel most of that total's digits.
//
// D spans the packer's depth buckets 8..16384 and beyond, so the mapping of
// threads to rows follows D as in ll_screen.cu: a team of 1..32 lanes (D/8,
// a power of two) owns a row, each lane reads 4 elements per plane and step
// (8 B of int16, 4 B of flags) and keeps 5 sums per allele in registers,
// reduced with __shfl_xor_sync inside the team; rows of D >= 2048 take a
// whole block, whose 8 warp sums meet in shared memory and are added in a
// fixed order. The float sums of a row then lie in shared memory, where the
// team's lanes index them to write the P pair likelihoods side by side (P is
// a run-time loop: 136 pairs at K = 16). Two register budgets, 8 and 16
// alleles; K > 16 walks the row once per 16 alleles. The success
// probabilities of quals 0..127 and MAPQs 0..255 are tabulated per block by
// the same function that serves values outside the tables.
//
// Bound: memory. With likelihoods each slot is 6 B (8 B with
// include_alignment) read once, and each row writes 8K + 5 + 4P bytes; the
// arithmetic (three logf and five adds an element) is an order of magnitude
// below that at the f32 rate.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDeepRow = 2048;        // rows this wide take a whole block
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM of an H100 SXM
constexpr int kQualTable = 128;
constexpr int kMapqTable = 256;
constexpr float kLog2 = 0.6931471805599453f;

// 1 - 10^(-q/10), as the TPU kernel writes it (q * -0.1). Non-inlined: the
// tables and the per-element path go through the very same code.
__device__ __noinline__ float phred_success(float q) {
  return __fsub_rn(1.0f, powf(10.0f, __fmul_rn(q, -0.1f)));
}

struct Terms {
  float hom, mid, none;
};

__device__ __forceinline__ Terms element_terms(int q, int mq, bool alignment,
                                               const float* tab_q,
                                               const float* tab_m) {
  float pc = (q >= 0 && q < kQualTable) ? tab_q[q]
                                        : phred_success(static_cast<float>(q));
  if (alignment) {
    const float pm = (mq >= 0 && mq < kMapqTable)
                         ? tab_m[mq]
                         : phred_success(static_cast<float>(mq));
    pc = __fmul_rn(pc, pm);
  }
  const float om = __fsub_rn(1.0f, pc);
  Terms t;
  t.hom = logf(__fadd_rn(pc, pc));
  t.mid = logf(__fadd_rn(pc, om));
  t.none = logf(__fadd_rn(om, om));
  return t;
}

template <int KMAX>
struct Sums {
  int cnt[KMAX];
  int fwd[KMAX];
  float a[KMAX];  // log(2 pc) over the allele's elements
  float m[KMAX];  // log(pc + (1 - pc))
  float n[KMAX];  // log(2 (1 - pc))
  int depth;
  float n_none;   // log(2 (1 - pc)) over valid elements of no allele
};

template <int KMAX, bool kLL>
__device__ __forceinline__ void add_element(Sums<KMAX>& s, int aid, int q,
                                            int mq, int fwd, int K, int base,
                                            bool alignment, const float* tab_q,
                                            const float* tab_m) {
  if (base == 0) s.depth += 1;
  const bool no_allele = aid < 0 || aid >= K;
  const int local = aid - base;
  if (!kLL) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (local == k && !no_allele) {
        s.cnt[k] += 1;
        s.fwd[k] += fwd;
      }
    }
    return;
  }
  if (!no_allele && (local < 0 || local >= KMAX)) return;  // another pass
  if (no_allele && base != 0) return;
  const Terms t = element_terms(q, mq, alignment, tab_q, tab_m);
  if (no_allele) {
    s.n_none += t.none;
    return;
  }
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (local == k) {
      s.cnt[k] += 1;
      s.fwd[k] += fwd;
      s.a[k] += t.hom;
      s.m[k] += t.mid;
      s.n[k] += t.none;
    }
  }
}

// Shared memory per row: A[K], M[K], N[K], then N_none.
__device__ __forceinline__ int row_floats(int K) { return 3 * K + 1; }

template <int KMAX, bool kLL>
__global__ void __launch_bounds__(kThreads)
    stats_ll_kernel(const int16_t* __restrict__ allele_id,
                    const int16_t* __restrict__ qual,
                    const int16_t* __restrict__ mapq,
                    const uint8_t* __restrict__ strand,
                    const uint8_t* __restrict__ valid,
                    const uint8_t* __restrict__ is_variant, int64_t L, int D,
                    int K, int team, bool block_row, bool vec4, bool alignment,
                    int threshold, int32_t* __restrict__ counts,
                    int32_t* __restrict__ fwd_counts,
                    int32_t* __restrict__ depth_out,
                    uint8_t* __restrict__ cand_out, float* __restrict__ ll) {
  __shared__ float tab_q[kQualTable];
  __shared__ float tab_m[kMapqTable];
  __shared__ float part_f[kWarps][3 * KMAX + 1];
  __shared__ int part_i[kWarps][2 * KMAX + 1];
  extern __shared__ float row_sums[];  // [rows_per_block][3K + 1]
  const int t = threadIdx.x;
  if (kLL) {
    if (t < kQualTable) tab_q[t] = phred_success(static_cast<float>(t));
    tab_m[t] = phred_success(static_cast<float>(t));  // kThreads == kMapqTable
    __syncthreads();
  }
  const int rows_per_block = block_row ? 1 : kThreads / team;
  const int member = block_row ? t : t % team;
  const int stride = block_row ? kThreads : team;
  const int local_row = block_row ? 0 : t / team;
  float* mine = row_sums + local_row * row_floats(K);
  const int P = K * (K + 1) / 2;
  // Every thread of a block runs the same number of iterations, so the
  // shuffles and barriers below are reached by all.
  for (int64_t base_row = static_cast<int64_t>(blockIdx.x) * rows_per_block;
       base_row < L;
       base_row += static_cast<int64_t>(gridDim.x) * rows_per_block) {
    const int64_t row = block_row ? base_row : base_row + local_row;
    const bool active = row < L;
    int depth = 0;
    int pass_variant = 0, pass_ref = 0;  // the rule's tallies, on member 0
    for (int base = 0; base < K; base += KMAX) {
      Sums<KMAX> s;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        s.cnt[k] = 0;
        s.fwd[k] = 0;
        s.a[k] = 0.0f;
        s.m[k] = 0.0f;
        s.n[k] = 0.0f;
      }
      s.depth = 0;
      s.n_none = 0.0f;
      if (active) {
        const int64_t o = row * D;
        if (vec4) {
          for (int e = member * 4; e < D; e += stride * 4) {
            const uint32_t v =
                *reinterpret_cast<const uint32_t*>(valid + o + e);
            if (v == 0) continue;
            const uint32_t f =
                *reinterpret_cast<const uint32_t*>(strand + o + e);
            const uint2 a = *reinterpret_cast<const uint2*>(allele_id + o + e);
            uint2 q = make_uint2(0u, 0u), m = make_uint2(0u, 0u);
            if (kLL) {
              q = *reinterpret_cast<const uint2*>(qual + o + e);
              if (alignment) m = *reinterpret_cast<const uint2*>(mapq + o + e);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (((v >> (8 * i)) & 0xFFu) == 0) continue;
              const unsigned sh = 16 * (i & 1);
              const unsigned aw = (i < 2) ? a.x : a.y;
              const unsigned qw = (i < 2) ? q.x : q.y;
              const unsigned mw = (i < 2) ? m.x : m.y;
              add_element<KMAX, kLL>(
                  s, static_cast<int16_t>((aw >> sh) & 0xFFFFu),
                  static_cast<int16_t>((qw >> sh) & 0xFFFFu),
                  static_cast<int16_t>((mw >> sh) & 0xFFFFu),
                  ((f >> (8 * i)) & 0xFFu) != 0 ? 1 : 0, K, base, alignment,
                  tab_q, tab_m);
            }
          }
        } else {
          for (int e = member; e < D; e += stride) {
            if (valid[o + e] == 0) continue;
            add_element<KMAX, kLL>(
                s, allele_id[o + e], kLL ? qual[o + e] : 0,
                (kLL && alignment) ? mapq[o + e] : 0,
                strand[o + e] != 0 ? 1 : 0, K, base, alignment, tab_q, tab_m);
          }
        }
      }
      const int width = block_row ? 32 : team;
      for (int off = width >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          s.cnt[k] += __shfl_xor_sync(kFullMask, s.cnt[k], off);
          s.fwd[k] += __shfl_xor_sync(kFullMask, s.fwd[k], off);
          if (kLL) {
            s.a[k] += __shfl_xor_sync(kFullMask, s.a[k], off);
            s.m[k] += __shfl_xor_sync(kFullMask, s.m[k], off);
            s.n[k] += __shfl_xor_sync(kFullMask, s.n[k], off);
          }
        }
        s.depth += __shfl_xor_sync(kFullMask, s.depth, off);
        if (kLL) s.n_none += __shfl_xor_sync(kFullMask, s.n_none, off);
      }
      if (block_row) {
        const int wid = t >> 5;
        if ((t & 31) == 0) {
#pragma unroll
          for (int k = 0; k < KMAX; ++k) {
            part_i[wid][k] = s.cnt[k];
            part_i[wid][KMAX + k] = s.fwd[k];
            part_f[wid][k] = s.a[k];
            part_f[wid][KMAX + k] = s.m[k];
            part_f[wid][2 * KMAX + k] = s.n[k];
          }
          part_i[wid][2 * KMAX] = s.depth;
          part_f[wid][3 * KMAX] = s.n_none;
        }
        __syncthreads();
        if (t == 0) {
          for (int w = 1; w < kWarps; ++w) {
#pragma unroll
            for (int k = 0; k < KMAX; ++k) {
              s.cnt[k] += part_i[w][k];
              s.fwd[k] += part_i[w][KMAX + k];
              s.a[k] += part_f[w][k];
              s.m[k] += part_f[w][KMAX + k];
              s.n[k] += part_f[w][2 * KMAX + k];
            }
            s.depth += part_i[w][2 * KMAX];
            s.n_none += part_f[w][3 * KMAX];
          }
        }
        __syncthreads();  // part_* is rewritten by the next pass
      }
      if (base == 0) depth = s.depth;  // member 0 holds the row's total
      if (active && member == 0) {
        if (base == 0) {
          depth_out[row] = depth;
          if (kLL) mine[3 * K] = s.n_none;
        }
        const int64_t need =
            static_cast<int64_t>(depth) * (static_cast<int64_t>(threshold) + 1);
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const int g = base + k;
          if (g < K) {
            counts[row * K + g] = s.cnt[k];
            fwd_counts[row * K + g] = s.fwd[k];
            const bool variant = is_variant[row * K + g] != 0;
            const bool passing =
                s.cnt[k] > 0 &&
                (threshold < 0 ||
                 static_cast<int64_t>(s.cnt[k]) * 100 >= need);
            if (passing) {
              if (variant) {
                pass_variant += 1;
              } else {
                pass_ref += 1;
              }
            }
            if (kLL) {
              mine[g] = s.a[k];
              mine[K + g] = s.m[k];
              mine[2 * K + g] = s.n[k];
            }
          }
        }
      }
    }
    if (active && member == 0) {
      const bool cand = threshold < 0 ? pass_variant > 0
                                      : (pass_variant > 0 || pass_ref >= 2);
      cand_out[row] = cand ? 1 : 0;
    }
    if (kLL) {
      // The row's sums are in shared memory: every lane of its team writes
      // some of the P pairs, side by side.
      if (block_row) {
        __syncthreads();
      } else {
        __syncwarp();
      }
      // In block_row mode only thread 0 knows the depth.
      if (block_row) {
        if (t == 0) part_i[0][0] = depth;
        __syncthreads();
        depth = part_i[0][0];
      }
      if (active) {
        const float tail =
            __fmul_rn(static_cast<float>(depth), -kLog2);
        int i = 0, j = 0;
        // Walk to pair number `member`, then on in steps of `stride`.
        int ahead = member;
        int p = member;
        while (p < P) {
          while (ahead > 0) {
            const int left = K - j;  // pairs left in row i, this one included
            if (ahead < left) {
              j += ahead;
              ahead = 0;
            } else {
              ahead -= left;
              i += 1;
              j = i;
            }
          }
          float others = mine[3 * K];
          for (int k = 0; k < K; ++k) {
            if (k != i && k != j) others += mine[2 * K + k];
          }
          const float own = (i == j) ? mine[i] : mine[K + i] + mine[K + j];
          ll[row * P + p] = own + others + tail;
          p += stride;
          ahead = stride;
        }
      }
      // `mine` is rewritten by the next row.
      if (block_row) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
}

template <int KMAX, bool kLL>
cudaError_t launch(const void* allele_id, const void* qual, const void* mapq,
                   const void* strand, const void* valid,
                   const void* is_variant, int64_t L, int D, int K,
                   bool alignment, int threshold, void* counts,
                   void* fwd_counts, void* depth, void* cand, void* ll,
                   cudaStream_t stream) {
  const bool block_row = D >= kDeepRow;
  // D/8 lanes, 1..32; more than 16 alleles keep a row's sums of 3K + 1
  // floats in shared memory, so fewer rows share a block.
  int team = 1;
  while (team < 32 && team * 16 <= D) team *= 2;
  if (K > 16) team = 32;
  constexpr size_t kRowSumsLimit = 40 * 1024;
  auto row_sums_bytes = [K](int lanes) {
    return static_cast<size_t>(kThreads / lanes) * (3 * K + 1) * sizeof(float);
  };
  while (kLL && !block_row && team < 32 && row_sums_bytes(team) > kRowSumsLimit)
    team *= 2;
  auto aligned = [](const void* p, uintptr_t a) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  const bool vec4 = D % 4 == 0 && aligned(allele_id, 8) && aligned(qual, 8) &&
                    aligned(mapq, 8) && aligned(strand, 4) && aligned(valid, 4);
  const int64_t rows_per_block = block_row ? 1 : kThreads / team;
  int64_t blocks = (L + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t dynamic =
      kLL ? static_cast<size_t>(rows_per_block) * (3 * K + 1) * sizeof(float)
          : 0;
  if (dynamic > kRowSumsLimit) return cudaErrorInvalidValue;
  stats_ll_kernel<KMAX, kLL>
      <<<static_cast<unsigned>(blocks), kThreads, dynamic, stream>>>(
          static_cast<const int16_t*>(allele_id),
          static_cast<const int16_t*>(qual), static_cast<const int16_t*>(mapq),
          static_cast<const uint8_t*>(strand),
          static_cast<const uint8_t*>(valid),
          static_cast<const uint8_t*>(is_variant), L, D, K, team, block_row,
          vec4, alignment, threshold, static_cast<int32_t*>(counts),
          static_cast<int32_t*>(fwd_counts), static_cast<int32_t*>(depth),
          static_cast<uint8_t*>(cand), static_cast<float*>(ll));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// threshold < 0: no threshold (any variant allele with an element). ll may be
// null: no likelihoods, and then qual and mapq may be null too. mapq may be
// null without include_alignment. K is 1..256.
int guac_stats_ll(const void* allele_id, const void* qual, const void* mapq,
                  const void* strand, const void* valid,
                  const void* is_variant, int64_t L, int64_t D, int K,
                  int include_alignment, int threshold, void* counts,
                  void* fwd_counts, void* depth, void* cand, void* ll,
                  void* stream) {
  const bool want_ll = ll != nullptr;
  const bool alignment = include_alignment != 0;
  if (K < 1 || K > 256 || D < 1 || D > (1 << 30) || threshold > 1000000 ||
      (want_ll && qual == nullptr) ||
      (want_ll && alignment && mapq == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (L <= 0) return static_cast<int>(cudaGetLastError());  // empty grid
  auto s = static_cast<cudaStream_t>(stream);
  const int d = static_cast<int>(D);
  const int thr = threshold < 0 ? -1 : threshold;
  cudaError_t rc;
  if (K <= 8) {
    rc = want_ll ? launch<8, true>(allele_id, qual, mapq, strand, valid,
                                   is_variant, L, d, K, alignment, thr, counts,
                                   fwd_counts, depth, cand, ll, s)
                 : launch<8, false>(allele_id, qual, mapq, strand, valid,
                                    is_variant, L, d, K, alignment, thr, counts,
                                    fwd_counts, depth, cand, ll, s);
  } else {
    rc = want_ll ? launch<16, true>(allele_id, qual, mapq, strand, valid,
                                    is_variant, L, d, K, alignment, thr,
                                    counts, fwd_counts, depth, cand, ll, s)
                 : launch<16, false>(allele_id, qual, mapq, strand, valid,
                                     is_variant, L, d, K, alignment, thr,
                                     counts, fwd_counts, depth, cand, ll, s);
  }
  return static_cast<int>(rc);
}

}  // extern "C"
