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
// threads to rows follows D as in ll_screen.cu.
//  - Below D = 256 a row takes ONE thread: no reduction across lanes, and
//    a whole 16-byte load belongs to one row. Deeper rows take a team of
//    2..32 lanes (every lane at least 128 elements of the row; a warp a row
//    from D = 4096), the steps of a row dealt to the lanes in turn, so that
//    one load of the team covers consecutive bytes. Warps do not wait for
//    one another: a warp takes rounds of 32 / team consecutive rows.
//  - A tile of few rows is one thread's chain of steps, with most of the
//    card idle. Its rows take larger teams, down to one vector step a lane,
//    as long as the tile then gives an SM no more than 16 warps (on a device
//    of 132 SMs: up to 33,792 rows two lanes each, up to 2,112 a warp each).
//  - A step is 8 elements: one 16-byte load of each int16 plane, one 8-byte
//    load of each byte plane, all planes at once. A lane starts the loads of
//    4 steps (64 bytes of allele ids, 128 to 256 bytes of its row) before it
//    adds the first element. A tile whose D is no multiple of 8, or whose
//    planes do not start at a multiple of 16 bytes (a view into a larger
//    tensor), is read element by element.
//  - Sums are indexed, not compared. A thread's sums lie in its own column
//    of two [K][threads] arrays in shared memory (consecutive threads in
//    consecutive banks, so no conflicts): {count, forward count} of an
//    allele as one 8-byte word and, with likelihoods, its three float sums
//    as one 16-byte word. An element costs one read-modify-write of each,
//    whatever K is. K is a run-time value up to 256: many alleles only mean
//    fewer threads a block (a block stays under 48 KB of shared memory
//    while it has more than 32 threads), and a row is walked once. A team's
//    columns lie side by side; its lanes add them up allele by allele, each
//    lane its own alleles, into the first lane's column.
//  - No logf in the element loop of the form without alignment: the three
//    terms of quals 0..127 are tabulated per block by the functions that
//    serve the values outside the table, so a tabulated term has the bits of
//    a computed one. With alignment pc_q * pc_m keeps its three logs (the
//    success probabilities of quals 0..127 and MAPQs 0..255 are tabulated).
//  - The row's first lane applies the rule and writes the row's K counts and
//    forward counts as 16-byte stores (K a multiple of 4). The P pairs are
//    written in output order, with running sums of the N_k before i, between
//    i and j, and (kept in the spare float of allele j) after j: a pair
//    costs a few additions, not K, and nothing is subtracted. A team's lanes
//    deal out the first alleles i among them; each adds up the N_k before
//    its i in the order one lane would.
//  - The likelihoods are the largest output, and a thread that stores its
//    own row's P floats writes 16 bytes here and 16 bytes 4P bytes on: the
//    card takes such stores at a fraction of its rate. So the lanes put
//    their rows' likelihoods into a staging buffer of the warp (rows an odd
//    number of floats apart, so they start in different banks), and the warp
//    writes its rows' [rows, P] range, which is contiguous in the output,
//    with 16-byte stores, neighbouring lanes neighbouring addresses. (From
//    about K = 60 a warp's likelihoods do not fit beside its sums and go
//    straight to the output.)
//  - Blocks are many and short (128 threads in the counting form; one round
//    of rows a warp until the grid has 64 warps for every SM of the device),
//    so the card's block scheduler evens out the work.
//
// Bound: memory. Every slot's valid byte is read; a valid element's other
// planes are 3 B without likelihoods, 5 B with them and 7 B with
// include_alignment; a row writes 8K + 5 bytes, and 4P more with likelihoods.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr int kCountThreads = 128;   // the counting form's block at the most
constexpr int kLaneElements = 128;   // a lane of a team takes at least these
constexpr int kSmallTileWarps = 16;  // a tile that gives an SM fewer warps is small
constexpr int kGroup = 8;            // elements of one vector step
constexpr int kBatch = 4;            // steps a lane loads before it adds
constexpr int kBlockBudget = 48 * 1024;  // shared memory of a block of > 32 threads
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kWarpsPerSm = 64;          // the grid's warps for every SM, at most
constexpr int kQualTable = 128;
constexpr int kMapqTable = 256;
constexpr int kTableFloats = kQualTable + kMapqTable;  // either form's tables
constexpr float kLog2 = 0.6931471805599453f;

// 1 - 10^(-q/10), as the TPU kernel writes it (q * -0.1). Non-inlined: the
// tables and the per-element path go through the very same code.
__device__ __noinline__ float phred_success(float q) {
  return __fsub_rn(1.0f, powf(10.0f, __fmul_rn(q, -0.1f)));
}

struct Terms {
  float hom, mid, none;
};

// The three values log(p_i + p_j) takes for an element of success
// probability pc. Non-inlined, as phred_success is and for the same reason.
__device__ __noinline__ Terms log_terms(float pc) {
  const float om = __fsub_rn(1.0f, pc);
  Terms t;
  t.hom = logf(__fadd_rn(pc, pc));
  t.mid = logf(__fadd_rn(pc, om));
  t.none = logf(__fadd_rn(om, om));
  return t;
}

// A thread's sums are its column of two [K][threads] arrays in shared
// memory: {count, forward count} of allele k as one 8-byte word and, in the
// likelihood forms, {A_k, M_k, N_k, a spare} as one 16-byte word. An element
// is one read-modify-write of each, whatever K is.
struct Column {
  int2* ints;      // this thread's column, allele 0
  float4* floats;  // likewise
  int stride;      // threads of the block
  int K;
};

template <bool kLL, bool kAlign>
__device__ __forceinline__ void add_element(const Column& c, int aid, int q,
                                            int mq, int fwd, const float* tab,
                                            int& depth, float& n_none) {
  depth += 1;
  const bool has_allele = static_cast<unsigned>(aid) < static_cast<unsigned>(c.K);
  if (has_allele) {
    int2 n = c.ints[aid * c.stride];
    n.x += 1;
    n.y += fwd;
    c.ints[aid * c.stride] = n;
  }
  if constexpr (kLL) {
    Terms t;
    const bool q_tabulated = static_cast<unsigned>(q) < kQualTable;
    if constexpr (kAlign) {
      const float pc =
          q_tabulated ? tab[q] : phred_success(static_cast<float>(q));
      const float pm = static_cast<unsigned>(mq) < kMapqTable
                           ? tab[kQualTable + mq]
                           : phred_success(static_cast<float>(mq));
      t = log_terms(__fmul_rn(pc, pm));
    } else if (q_tabulated) {
      t.hom = tab[q];
      t.mid = tab[kQualTable + q];
      t.none = tab[2 * kQualTable + q];
    } else {
      t = log_terms(phred_success(static_cast<float>(q)));
    }
    if (has_allele) {
      float4 f = c.floats[aid * c.stride];
      f.x += t.hom;
      f.y += t.mid;
      f.z += t.none;
      c.floats[aid * c.stride] = f;
    } else {
      n_none += t.none;
    }
  }
}

// Eight elements of a row, one 16-byte load of every int16 plane and one
// 8-byte load of both byte planes.
struct Group {
  uint4 a, q, m;
  uint2 v, f;
};

template <bool kLL, bool kAlign>
__device__ __forceinline__ void load_group(
    Group& g, const int16_t* __restrict__ allele_id,
    const int16_t* __restrict__ qual, const int16_t* __restrict__ mapq,
    const uint8_t* __restrict__ strand, const uint8_t* __restrict__ valid,
    int64_t at) {
  g.v = *reinterpret_cast<const uint2*>(valid + at);
  g.f = *reinterpret_cast<const uint2*>(strand + at);
  g.a = *reinterpret_cast<const uint4*>(allele_id + at);
  if constexpr (kLL) g.q = *reinterpret_cast<const uint4*>(qual + at);
  if constexpr (kLL && kAlign) g.m = *reinterpret_cast<const uint4*>(mapq + at);
}

template <bool kLL, bool kAlign>
__device__ __forceinline__ void add_group(const Column& c, const Group& g,
                                          const float* tab, int& depth,
                                          float& n_none) {
  if ((g.v.x | g.v.y) == 0) return;
  const uint32_t aw[4] = {g.a.x, g.a.y, g.a.z, g.a.w};
  const uint32_t qw[4] = {g.q.x, g.q.y, g.q.z, g.q.w};
  const uint32_t mw[4] = {g.m.x, g.m.y, g.m.z, g.m.w};
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const unsigned sh8 = 8 * (i & 3);
    if ((((i < 4 ? g.v.x : g.v.y) >> sh8) & 0xFFu) == 0) continue;
    const unsigned sh16 = 16 * (i & 1);
    const int fwd = (((i < 4 ? g.f.x : g.f.y) >> sh8) & 0xFFu) != 0 ? 1 : 0;
    int q = 0, mq = 0;
    if constexpr (kLL)
      q = static_cast<int16_t>((qw[i >> 1] >> sh16) & 0xFFFFu);
    if constexpr (kLL && kAlign)
      mq = static_cast<int16_t>((mw[i >> 1] >> sh16) & 0xFFFFu);
    add_element<kLL, kAlign>(
        c, static_cast<int16_t>((aw[i >> 1] >> sh16) & 0xFFFFu), q, mq, fwd,
        tab, depth, n_none);
  }
}

// An allele with n elements passes the threshold: n * 100 // depth >
// threshold, without the division; any element passes without a threshold.
__device__ __forceinline__ bool passes(int n, int threshold, int64_t need) {
  return n > 0 && (threshold < 0 || static_cast<int64_t>(n) * 100 >= need);
}

// Where element e of a warp's [rows][P] likelihoods lies in its staging
// buffer, whose rows are `pitch` floats apart.
__device__ __forceinline__ int staged_at(int e, int P, int pitch) {
  const int r = e / P;
  return r * pitch + (e - r * P);
}

// kOneThread: every row has one thread (the launcher's promise that
// team_log2 is 0), so the team's code folds away at compile time.
template <bool kLL, bool kAlign, bool kVec, bool kOneThread>
__global__ void __launch_bounds__(kMaxThreads)
    stats_ll_kernel(const int16_t* __restrict__ allele_id,
                    const int16_t* __restrict__ qual,
                    const int16_t* __restrict__ mapq,
                    const uint8_t* __restrict__ strand,
                    const uint8_t* __restrict__ valid,
                    const uint8_t* __restrict__ is_variant, int64_t L, int D,
                    int K, int team_log2_given, bool wide_out, bool staged,
                    int threshold, int32_t* __restrict__ counts,
                    int32_t* __restrict__ fwd_counts,
                    int32_t* __restrict__ depth_out,
                    uint8_t* __restrict__ cand_out, float* __restrict__ ll) {
  extern __shared__ __align__(16) float shared[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const float* tab = shared;
  if constexpr (kLL) {
    // Quals 0..127 (and MAPQs 0..255) through the functions that serve the
    // values outside the tables: a tabulated term has a computed one's bits.
    if constexpr (kAlign) {
      for (int i = t; i < kTableFloats; i += T)
        shared[i] = phred_success(
            static_cast<float>(i < kQualTable ? i : i - kQualTable));
    } else {
      for (int i = t; i < kQualTable; i += T) {
        const Terms terms = log_terms(phred_success(static_cast<float>(i)));
        shared[i] = terms.hom;
        shared[kQualTable + i] = terms.mid;
        shared[2 * kQualTable + i] = terms.none;
      }
    }
    __syncthreads();
  }
  // The block's shared memory: the tables, the float sums [K][T] x 16 B, the
  // integer sums [K][T] x 8 B, a staging buffer of likelihoods per warp.
  float4* float_sums = reinterpret_cast<float4*>(shared + (kLL ? kTableFloats : 0));
  int2* int_sums = reinterpret_cast<int2*>(float_sums + (kLL ? K * T : 0));
  Column c;
  c.ints = int_sums + t;
  c.floats = float_sums + t;
  c.stride = T;
  c.K = K;
  const int lane = t & 31;
  const int team_log2 = kOneThread ? 0 : team_log2_given;
  const int team = 1 << team_log2;       // lanes that share a row
  const int member = lane & (team - 1);  // this lane's place in its team
  const int rows_per_warp = 32 >> team_log2;
  const int warps = T >> 5;
  const int P = K * (K + 1) / 2;
  const int pitch = P | 1;  // odd: the lanes' staged rows start in 32 banks
  float* stage = reinterpret_cast<float*>(int_sums + K * T) +
                 (t >> 5) * rows_per_warp * pitch;
  const int64_t n_rounds = (L + rows_per_warp - 1) / rows_per_warp;
  const int local_row = lane >> team_log2;

  auto clear_sums = [&]() {
    for (int k = 0; k < K; ++k) {
      c.ints[k * T] = make_int2(0, 0);
      if constexpr (kLL) c.floats[k * T] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };

  // What follows a round's last element: the team's sums meet, the row's
  // first lane applies the rule and writes the row, the warp writes its
  // rows' likelihoods. All lanes of the warp come here together.
  auto finish_round = [&](int64_t round, int depth, float n_none) {
    const int64_t row0 = round * rows_per_warp;
    const int64_t row = row0 + local_row;
    const bool active = row < L;
    int pass_variant = 0, pass_ref = 0;  // the rule's tallies
    if (team > 1) {
      // The team's columns lie side by side. Lane m adds up the sums of
      // alleles m, m + team, ... over them, each starting at its own column
      // so that the lanes read different banks, and leaves the total in the
      // first lane's column. No lane touches a sum that another adds up.
      __syncwarp();
      for (int off = team >> 1; off > 0; off >>= 1) {
        depth += __shfl_xor_sync(kFullMask, depth, off);
        if constexpr (kLL) n_none += __shfl_xor_sync(kFullMask, n_none, off);
      }
      const int64_t need =
          static_cast<int64_t>(depth) * (static_cast<int64_t>(threshold) + 1);
      for (int k = member; k < K; k += team) {
        int2* ni = c.ints - member + k * T;
        int2 n = make_int2(0, 0);
        for (int i = 0; i < team; ++i) {
          const int2 x = ni[(member + i) & (team - 1)];
          n.x += x.x;
          n.y += x.y;
        }
        ni[0] = n;
        // The lane that has an allele's total applies the rule to it.
        if (active && passes(n.x, threshold, need)) {
          if (is_variant[row * K + k] != 0) {
            pass_variant += 1;
          } else {
            pass_ref += 1;
          }
        }
        if constexpr (kLL) {
          float4* fi = c.floats - member + k * T;
          float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int i = 0; i < team; ++i) {
            const float4 x = fi[(member + i) & (team - 1)];
            f.x += x.x;
            f.y += x.y;
            f.z += x.z;
          }
          fi[0] = f;
        }
      }
      for (int off = team >> 1; off > 0; off >>= 1) {
        pass_variant += __shfl_xor_sync(kFullMask, pass_variant, off);
        pass_ref += __shfl_xor_sync(kFullMask, pass_ref, off);
      }
      __syncwarp();
    }
    if (active && member == 0) {
      // The row's sums are this lane's column.
      depth_out[row] = depth;
      if (team == 1) {
        const int64_t need = static_cast<int64_t>(depth) *
                             (static_cast<int64_t>(threshold) + 1);
        for (int k = 0; k < K; ++k) {
          if (passes(c.ints[k * T].x, threshold, need)) {
            if (is_variant[row * K + k] != 0) {
              pass_variant += 1;
            } else {
              pass_ref += 1;
            }
          }
        }
      }
      cand_out[row] = (threshold < 0 ? pass_variant > 0
                                     : (pass_variant > 0 || pass_ref >= 2))
                          ? 1
                          : 0;
      // A row's K counts are contiguous: 16-byte stores where K allows.
      int32_t* crow = counts + row * K;
      int32_t* frow = fwd_counts + row * K;
      if (wide_out) {
        for (int k = 0; k < K; k += 4) {
          const int2 n0 = c.ints[k * T], n1 = c.ints[(k + 1) * T];
          const int2 n2 = c.ints[(k + 2) * T], n3 = c.ints[(k + 3) * T];
          *reinterpret_cast<int4*>(crow + k) = make_int4(n0.x, n1.x, n2.x, n3.x);
          *reinterpret_cast<int4*>(frow + k) = make_int4(n0.y, n1.y, n2.y, n3.y);
        }
      } else {
        for (int k = 0; k < K; ++k) {
          const int2 n = c.ints[k * T];
          crow[k] = n.x;
          frow[k] = n.y;
        }
      }
      if constexpr (kLL) {
        // The spare float of allele j takes N_{j+1} + ... + N_{K-1}.
        float run = 0.0f;
        for (int j = K - 1; j >= 0; --j) {
          float4 f = c.floats[j * T];
          f.w = run;
          run += f.z;
          c.floats[j * T] = f;
        }
      }
    }
    if constexpr (kLL) {
      if (team > 1) __syncwarp();  // the row's lanes read its first lane's sums
      if (active) {
        // The row's lanes deal out the first alleles i of the pairs (i, j);
        // a lane adds up the N_k before its i in the order one lane would.
        const float4* sums = c.floats - member;
        const float tail = __fmul_rn(static_cast<float>(depth), -kLog2);
        // Into the warp's staging buffer, or, where many alleles leave no
        // room for one, straight to the output.
        float* dst = staged ? stage + local_row * pitch : ll + row * P;
        float before = n_none;  // N_none + N_0 + ... + N_{i-1}
        int k = 0;
        for (int i = member; i < K; i += team) {
          for (; k < i; ++k) before += sums[k * T].z;
          int p = i * K - i * (i - 1) / 2;  // where the pairs (i, .) start
          const float4 fi = sums[i * T];
          float between = 0.0f;  // N_{i+1} + ... + N_{j-1}
          float4 fj = fi;
          for (int j = i; j < K; ++j, ++p) {
            // The next allele's sums are asked for before this pair is
            // stored, so the loop does not wait for shared memory.
            const float4 next = j + 1 < K ? sums[(j + 1) * T] : fj;
            // The N_k of the other alleles are added, never subtracted from
            // their total: a deep reference allele would cancel its digits.
            const float others = (before + between) + fj.w;
            const float own = (i == j) ? fi.x : fi.y + fj.y;
            dst[p] = own + others + tail;
            if (j > i) between += fj.z;
            fj = next;
          }
          before += fi.z;
          k = i + 1;
        }
      }
      // The pairs are written, and the first lane's column is read, before
      // the warp copies them out and the lanes clear their columns.
      __syncwarp();
      if (staged) {
        // The likelihoods of the warp's rows are one contiguous range of
        // the output: 16-byte stores, neighbouring lanes neighbouring
        // addresses, single floats up to the first aligned address and
        // after the last.
        const int64_t rows_left = L - row0;
        const int n = static_cast<int>(rows_left < rows_per_warp
                                           ? rows_left
                                           : rows_per_warp) * P;
        float* out = ll + row0 * P;
        int head = static_cast<int>(
            (4 - ((reinterpret_cast<uintptr_t>(out) >> 2) & 3u)) & 3u);
        if (head > n) head = n;
        if (lane < head) out[lane] = stage[staged_at(lane, P, pitch)];
        const int n4 = (n - head) >> 2;
        for (int q = lane; q < n4; q += 32) {
          const int e = head + 4 * q;
          int r = e / P;
          int pp = e - r * P;
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = stage[r * pitch + pp];
            if (++pp == P) {
              pp = 0;
              ++r;
            }
          }
          *reinterpret_cast<float4*>(out + e) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
        for (int e = head + 4 * n4 + lane; e < n; e += 32)
          out[e] = stage[staged_at(e, P, pitch)];
        __syncwarp();  // the buffer is rewritten in the next round
      }
    }
    clear_sums();
  };

  // Warps do not wait for one another, and every bound below is the same
  // for all lanes of a warp, so all reach the shuffles and __syncwarp()s.
  const int64_t first_round = static_cast<int64_t>(blockIdx.x) * warps + (t >> 5);
  const int64_t round_stride = static_cast<int64_t>(gridDim.x) * warps;
  clear_sums();
  int depth = 0;
  float n_none = 0.0f;  // log 2(1 - pc) over valid elements of no allele
  for (int64_t round = first_round; round < n_rounds; round += round_stride) {
    const int64_t row = round * rows_per_warp + local_row;
    if (row < L) {
      const int64_t o = row * D;
      if constexpr (kVec) {
        const int n_groups = D / kGroup;
        for (int g0 = member; g0 < n_groups; g0 += team * kBatch) {
          Group g[kBatch];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            g[b].v = make_uint2(0u, 0u);
            if (g0 + b * team < n_groups)
              load_group<kLL, kAlign>(g[b], allele_id, qual, mapq, strand,
                                      valid, o + (g0 + b * team) * kGroup);
          }
#pragma unroll
          for (int b = 0; b < kBatch; ++b)
            add_group<kLL, kAlign>(c, g[b], tab, depth, n_none);
        }
      } else {
        for (int e = member; e < D; e += team) {
          if (valid[o + e] == 0) continue;
          add_element<kLL, kAlign>(
              c, allele_id[o + e], kLL ? qual[o + e] : 0,
              (kLL && kAlign) ? mapq[o + e] : 0, strand[o + e] != 0 ? 1 : 0,
              tab, depth, n_none);
        }
      }
    }
    finish_round(round, depth, n_none);
    depth = 0;
    n_none = 0.0f;
  }
}

bool aligned(const void* p, uintptr_t a) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % a == 0;
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

template <bool kLL, bool kAlign, bool kVec>
cudaError_t launch(const void* allele_id, const void* qual, const void* mapq,
                   const void* strand, const void* valid,
                   const void* is_variant, int64_t L, int D, int K,
                   int threshold, void* counts, void* fwd_counts, void* depth,
                   void* cand, void* ll, cudaStream_t stream) {
  // The largest team of 1..32 lanes that leaves every lane kLaneElements
  // of its row: one thread a row below 2 * kLaneElements.
  int team_log2 = 0;
  while (team_log2 < 5 && (kLaneElements << (team_log2 + 1)) <= D) ++team_log2;
  // A tile of few rows leaves most of the card idle, and its time is one
  // thread's chain of steps: its rows take as many lanes as leave each a
  // vector step, while that gives an SM no more than kSmallTileWarps warps.
  int sms = 0;
  const cudaError_t asked = sm_count(&sms);
  if (asked != cudaSuccess) return asked;
  const int64_t small_threads =
      static_cast<int64_t>(sms) * kSmallTileWarps * 32;
  while (team_log2 < 5 && (kGroup << (team_log2 + 1)) <= D &&
         (L << (team_log2 + 1)) <= small_threads)
    ++team_log2;
  const int rows_per_warp = 32 >> team_log2;
  // What a block holds: the tables, a column of 8 B (24 B with likelihoods)
  // an allele for every thread, and a warp's staged likelihoods. Many
  // alleles take fewer threads a block; where even one warp's likelihoods
  // find no room they go straight to the output.
  const int column_bytes = (kLL ? 24 : 8) * K;
  const int stage_bytes = kLL ? rows_per_warp * ((K * (K + 1) / 2) | 1) * 4 : 0;
  auto block_bytes = [&](int threads, bool staged) {
    return (kLL ? kTableFloats * 4 : 0) + threads * column_bytes +
           (staged ? threads / 32 * stage_bytes : 0);
  };
  const bool staged = kLL && block_bytes(32, true) <= kMaxSharedBytes;
  int threads = kLL ? kMaxThreads : kCountThreads;
  while (threads > 32 && block_bytes(threads, staged) > kBlockBudget)
    threads >>= 1;
  const int shared_bytes = block_bytes(threads, staged);
  if (shared_bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  auto* kernel = stats_ll_kernel<kLL, kAlign, kVec, false>;
  if constexpr (kVec)
    if (team_log2 == 0) kernel = stats_ll_kernel<kLL, kAlign, true, true>;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (rc != cudaSuccess) return rc;
  }
  // The grid has at most kWarpsPerSm warps for every SM; where the tile has
  // more rounds of rows than that, a warp walks on from round to round with
  // the next round's loads in flight.
  const int64_t n_rounds = (L + rows_per_warp - 1) / rows_per_warp;
  const int warps = threads / 32;
  int64_t blocks = (n_rounds + warps - 1) / warps;
  const int64_t most =
      (static_cast<int64_t>(sms) * kWarpsPerSm + warps - 1) / warps;
  if (blocks > most) blocks = most;
  const bool wide_out = K % 4 == 0 && aligned(counts, 16) &&
                        aligned(fwd_counts, 16);
  kernel<<<static_cast<unsigned>(blocks), threads, shared_bytes, stream>>>(
      static_cast<const int16_t*>(allele_id),
      static_cast<const int16_t*>(qual), static_cast<const int16_t*>(mapq),
      static_cast<const uint8_t*>(strand), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(is_variant), L, D, K, team_log2, wide_out,
      staged, threshold, static_cast<int32_t*>(counts),
      static_cast<int32_t*>(fwd_counts), static_cast<int32_t*>(depth),
      static_cast<uint8_t*>(cand), static_cast<float*>(ll));
  return cudaGetLastError();
}

template <bool kLL, bool kAlign>
cudaError_t launch_route(const void* allele_id, const void* qual,
                         const void* mapq, const void* strand,
                         const void* valid, const void* is_variant, int64_t L,
                         int D, int K, int threshold, void* counts,
                         void* fwd_counts, void* depth, void* cand, void* ll,
                         cudaStream_t stream) {
  // The vector steps need whole groups and aligned planes (a tile that
  // torch allocated has them whenever D is a multiple of 8).
  const bool vec = D % kGroup == 0 && aligned(allele_id, 16) &&
                   aligned(qual, 16) && aligned(mapq, 16) &&
                   aligned(strand, 8) && aligned(valid, 8);
  return vec ? launch<kLL, kAlign, true>(allele_id, qual, mapq, strand, valid,
                                         is_variant, L, D, K, threshold,
                                         counts, fwd_counts, depth, cand, ll,
                                         stream)
             : launch<kLL, kAlign, false>(allele_id, qual, mapq, strand, valid,
                                          is_variant, L, D, K, threshold,
                                          counts, fwd_counts, depth, cand, ll,
                                          stream);
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
  if (!want_ll) {
    rc = launch_route<false, false>(allele_id, nullptr, nullptr, strand, valid,
                                    is_variant, L, d, K, thr, counts,
                                    fwd_counts, depth, cand, nullptr, s);
  } else if (alignment) {
    rc = launch_route<true, true>(allele_id, qual, mapq, strand, valid,
                                  is_variant, L, d, K, thr, counts, fwd_counts,
                                  depth, cand, ll, s);
  } else {
    rc = launch_route<true, false>(allele_id, qual, nullptr, strand, valid,
                                   is_variant, L, d, K, thr, counts,
                                   fwd_counts, depth, cand, ll, s);
  }
  return static_cast<int>(rc);
}

}  // extern "C"
