// Flash attention for Hopper (sm_90a): forward and backward, hand-written CUDA.
//
// Layout: q, k, v, o, do, dq, dk, dv are contiguous (bh, S, D) in T (float or
// bfloat16); lse and delta are contiguous (bh, S) float. D is 64 or 128; any
// S >= 1 works (the ragged last tile is masked).
//
// Arithmetic mirrors the TPU kernels it replaces, rounding included: q is
// pre-scaled by sm_scale and rounded to T; p is rounded to T before the PV
// and P^T dO products; ds is rounded to T before the dS K and dS^T Q
// products. Every product accumulates in f32.
//
// Two sets of the same three kernels (forward; backward dk/dv; backward dq):
// - bfloat16, the training path: products on the tensor cores with
//   mma.sync.m16n8k16 (the section "bf16 on the tensor cores" below);
// - float32: products as scalar FMAs on the CUDA cores, since the tensor
//   cores would take f32 operands as TF32. Tiles are staged in shared memory
//   as f32; 256 threads per CTA, four per tile row. Thread t owns row t/4 of
//   its tile and, of the other tile, the columns t%4 + 4j. A row's softmax
//   statistics live in registers, replicated over its four lanes and reduced
//   with shuffles; the probabilities a thread needs from its row-mates arrive
//   by shuffle. Tiles keep a row stride of D + 1 floats, so every access
//   pattern is free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // threads per CTA: four per tile row
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Stage rows [row0, row0 + 64) of a (S, D) f32 matrix into a shared tile with
// row stride D + 1; rows past S read as zero. With scaled, each value is
// multiplied by scale (the kernels' pre-scaled q).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int S, float scale, bool scaled) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D, g = row0 + r;
    float x = g < S ? src[(size_t)g * D + c] : 0.f;
    if (scaled) x *= scale;
    dst[r * (D + 1) + c] = x;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// ---------------------------------------------------------------------------
// Forward. Replaces ray_tpu/ops/flash_attention.py::_fwd_kernel (via _fwd).
// One CTA per (bh, 64-row q tile); loops over 64-row K/V tiles with the online
// softmax, stopping after the diagonal tile when causal. Writes o and
// lse = m + log(max(l, 1e-30)) in f32.
// Bound on this card: at the GPT-2 shape (bh 192, S 1024, D 64, causal) the
// work is 25.8 GFLOP against 101 MB of traffic: ~30 us at 989 TFLOP/s and
// 3.35 TB/s. This f32 design runs the products as FMAs on the CUDA cores,
// one shared-memory load per FMA, so it is bound by shared-memory bandwidth
// far above that (67 TFLOP/s is the card's f32 peak off the tensor cores).
template <int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, float* __restrict__ lse, int S, float sm_scale, int causal) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;

  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const size_t base = (size_t)bh * S * D;
  const int r = threadIdx.x >> 2, g = threadIdx.x & 3, row = q0 + r;

  load_tile<D>(Qs, q + base, q0, S, sm_scale, true);
  const int nk = (S + BK - 1) / BK;
  const int hi = causal ? min((q0 + BQ + BK - 1) / BK, nk) : nk;

  float m = NEG_INF, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, k + base, k0, S, 1.f, false);
    load_tile<D>(Vs, v + base, k0, S, 1.f, false);
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int c = 0; c < BK / 4; ++c) s[c] = 0.f;
    const float* qrow = Qs + r * LD;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) s[c] += qd * Ks[(g + 4 * c) * LD + d];
    }

    float tmax = NEG_INF;
#pragma unroll
    for (int c = 0; c < BK / 4; ++c) {
      const int col = k0 + g + 4 * c;
      if (col >= S || (causal && col > row)) s[c] = NEG_INF;
      tmax = fmaxf(tmax, s[c]);
    }
    const float m_new = fmaxf(m, quad_max(tmax));
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 4; ++c) {
      s[c] = expf(s[c] - m_new);
      psum += s[c];
    }
    const float alpha = expf(m - m_new);
    l = l * alpha + quad_sum(psum);
    m = m_new;

#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] *= alpha;
#pragma unroll
    for (int c = 0; c < BK / 4; ++c) {
      const float pc = s[c];
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float p = __shfl_sync(FULL, pc, src, 4);
        const float* vrow = Vs + (src + 4 * c) * LD;
#pragma unroll
        for (int i = 0; i < D / 4; ++i) acc[i] += p * vrow[g + 4 * i];
      }
    }
  }

  l = fmaxf(l, 1e-30f);
  if (row < S) {
    float* orow = o + base + (size_t)row * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) orow[g + 4 * i] = acc[i] / l;
    if (g == 0) lse[(size_t)bh * S + row] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// Backward. Replaces ray_tpu/ops/flash_attention.py::_bwd_fused_kernel (via
// _bwd). The TPU kernel walks K tiles in order on one core and keeps dq in a
// VMEM scratch across them; CTAs here run in no order and share no scratch.
// So the backward is two kernels, with no atomics and a deterministic result:
//   dkdv: one CTA per (bh, K tile), looping over q tiles from the causal
//         lower bound: p = exp(s - lse), dv += p^T dO, dp = dO V^T,
//         ds = p (dp - delta) sm_scale, dk += ds^T q;
//   dq:   one CTA per (bh, q tile), looping over K tiles up to the diagonal,
//         recomputing p and ds, dq += ds K.
// delta = rowsum(dO * o) comes in from outside, as on the TPU.
// Bound on this card: 5 products, 64.4 GFLOP at the GPT-2 shape, ~65 us on
// the tensor cores (178 MB of traffic is ~53 us). This design recomputes s, p
// and dp in both kernels (7 products where 5 would do); the f32 version runs
// them on the CUDA cores, bound by shared-memory loads.
template <int D>
__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                int S, float sm_scale, int causal) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;   // scaled q
  float* Qr = Qs + BQ * LD;   // q as given
  float* dOs = Qr + BQ * LD;
  float* lse_s = dOs + BQ * LD;
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x, k0 = blockIdx.y * BK;
  const size_t base = (size_t)bh * S * D;
  const int c = threadIdx.x >> 2, g = threadIdx.x & 3, col = k0 + c;

  load_tile<D>(Ks, k + base, k0, S, 1.f, false);
  load_tile<D>(Vs, v + base, k0, S, 1.f, false);

  float dk_acc[D / 4], dv_acc[D / 4];
#pragma unroll
  for (int e = 0; e < D / 4; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  const int lo = causal ? k0 / BQ : 0;
  for (int i = lo; i < nq; ++i) {
    const int q0 = i * BQ;
    __syncthreads();
    load_tile<D>(Qs, q + base, q0, S, sm_scale, true);
    load_tile<D>(Qr, q + base, q0, S, 1.f, false);
    load_tile<D>(dOs, dout + base, q0, S, 1.f, false);
    if (threadIdx.x < BQ) {
      const int rr = q0 + threadIdx.x;
      lse_s[threadIdx.x] = rr < S ? lse[(size_t)bh * S + rr] : 0.f;
      delta_s[threadIdx.x] = rr < S ? delta[(size_t)bh * S + rr] : 0.f;
    }
    __syncthreads();

    float p[BQ / 4], ds[BQ / 4];
#pragma unroll
    for (int j = 0; j < BQ / 4; ++j) p[j] = ds[j] = 0.f;  // ds holds dp here
    const float* krow = Ks + c * LD;
    const float* vrow = Vs + c * LD;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d], vd = vrow[d];
#pragma unroll
      for (int j = 0; j < BQ / 4; ++j) {
        p[j] += Qs[(g + 4 * j) * LD + d] * kd;
        ds[j] += dOs[(g + 4 * j) * LD + d] * vd;
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 4; ++j) {
      const int rl = g + 4 * j, rr = q0 + rl;
      const bool ok = rr < S && !(causal && rr < col);
      const float pj = ok ? expf(p[j] - lse_s[rl]) : 0.f;
      ds[j] = pj * (ds[j] - delta_s[rl]) * sm_scale;
      p[j] = pj;
    }
#pragma unroll
    for (int j = 0; j < BQ / 4; ++j) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float pp = __shfl_sync(FULL, p[j], src, 4);
        const float dd = __shfl_sync(FULL, ds[j], src, 4);
        const float* dorow = dOs + (src + 4 * j) * LD;
        const float* qrow = Qr + (src + 4 * j) * LD;
#pragma unroll
        for (int e = 0; e < D / 4; ++e) {
          dv_acc[e] += pp * dorow[g + 4 * e];
          dk_acc[e] += dd * qrow[g + 4 * e];
        }
      }
    }
  }

  if (col < S) {
    float* dkrow = dk + base + (size_t)col * D;
    float* dvrow = dv + base + (size_t)col * D;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) {
      dkrow[g + 4 * e] = dk_acc[e];
      dvrow[g + 4 * e] = dv_acc[e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq, int S, float sm_scale,
              int causal) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;  // scaled q
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;

  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const size_t base = (size_t)bh * S * D;
  const int r = threadIdx.x >> 2, g = threadIdx.x & 3, row = q0 + r;

  load_tile<D>(Qs, q + base, q0, S, sm_scale, true);
  load_tile<D>(dOs, dout + base, q0, S, 1.f, false);
  const float my_lse = row < S ? lse[(size_t)bh * S + row] : 0.f;
  const float my_delta = row < S ? delta[(size_t)bh * S + row] : 0.f;

  float dq_acc[D / 4];
#pragma unroll
  for (int e = 0; e < D / 4; ++e) dq_acc[e] = 0.f;

  const int nk = (S + BK - 1) / BK;
  const int hi = causal ? min((q0 + BQ + BK - 1) / BK, nk) : nk;
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<D>(Ks, k + base, k0, S, 1.f, false);
    load_tile<D>(Vs, v + base, k0, S, 1.f, false);
    __syncthreads();

    float s[BK / 4], ds[BK / 4];
#pragma unroll
    for (int cc = 0; cc < BK / 4; ++cc) s[cc] = ds[cc] = 0.f;  // ds holds dp here
    const float* qrow = Qs + r * LD;
    const float* dorow = dOs + r * LD;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d], dod = dorow[d];
#pragma unroll
      for (int cc = 0; cc < BK / 4; ++cc) {
        s[cc] += qd * Ks[(g + 4 * cc) * LD + d];
        ds[cc] += dod * Vs[(g + 4 * cc) * LD + d];
      }
    }
#pragma unroll
    for (int cc = 0; cc < BK / 4; ++cc) {
      const int col = k0 + g + 4 * cc;
      const bool ok = row < S && col < S && !(causal && col > row);
      const float p = ok ? expf(s[cc] - my_lse) : 0.f;
      ds[cc] = p * (ds[cc] - my_delta) * sm_scale;
    }
#pragma unroll
    for (int cc = 0; cc < BK / 4; ++cc) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float dd = __shfl_sync(FULL, ds[cc], src, 4);
        const float* krow = Ks + (src + 4 * cc) * LD;
#pragma unroll
        for (int e = 0; e < D / 4; ++e) dq_acc[e] += dd * krow[g + 4 * e];
      }
    }
  }

  if (row < S) {
    float* dqrow = dq + base + (size_t)row * D;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) dqrow[g + 4 * e] = dq_acc[e];
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the same three kernels with every product as
// mma.sync.m16n8k16 (bf16 operands, f32 accumulate). fwd_mma_kernel replaces
// ray_tpu/ops/flash_attention.py::_fwd_kernel; bwd_dkdv_mma_kernel and
// bwd_dq_mma_kernel together replace _bwd_fused_kernel. 128 threads per CTA,
// one warp per 16 rows of the CTA's 64-row tile. Tiles sit in shared memory
// as bf16 with a row stride of D + 8 (16 bytes of padding), so the fragment
// loads below touch 32 distinct banks. The S accumulator's register layout is
// the A-operand layout of the next product, so p and ds go from one mma to
// the next in registers, rounded to bf16 exactly where the TPU kernels round.
// Bound on this card: the same as above; what this design leaves on the table
// is wgmma (mma.sync reaches a fraction of the bf16 peak), TMA or cp.async
// loads overlapped with the products (every tile load here stalls the CTA),
// and the backward's second recompute of s, p and dp.

using bf16 = __nv_bfloat16;
constexpr int NTM = 128;  // threads per CTA of the tensor-core kernels

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half: the lower column
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b for one 16x8x16 tile.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand: rows r0..r0+15, columns 16kk..16kk+15 of a row-major tile.
template <int LDH>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = tile + (r0 + g) * LDH + kk * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LDH);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LDH + 8);
}

// B operand (k x n = 16 x 8) from a tile stored [n][k]: rows n0..n0+7 of it.
template <int LDH>
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1, const bf16* tile, int n0,
                                          int kk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = tile + (n0 + g) * LDH + kk * 16 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B operand (k x n = 16 x 8) from a tile stored [k][n]: rows k0..k0+15, columns
// n0..n0+7, transposed on the way in by ldmatrix.
template <int LDH>
__device__ __forceinline__ void load_b_kn(uint32_t& b0, uint32_t& b1, const bf16* tile, int k0,
                                          int n0) {
  const bf16* p = tile + (k0 + (threadIdx.x & 15)) * LDH + n0;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// The A operand of the next product from the f32 accumulators of n-tiles
// 2kk and 2kk+1, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Stage rows [row0, row0 + 64) of a (S, D) bf16 matrix into a shared tile with
// row stride D + 8, 16 bytes per load; rows past S read as zero. With scaled,
// each value is multiplied by scale and rounded to bf16.
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src, int row0,
                                               int S, float scale, bool scaled) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < BQ * VPR; idx += NTM) {
    const int r = idx / VPR, c = (idx % VPR) * 8, g = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (g < S) val = *reinterpret_cast<const uint4*>(src + (size_t)g * D + c);
    if (scaled) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        h[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTM)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ o, float* __restrict__ lse, int S, float sm_scale, int causal) {
  constexpr int LDH = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LDH;
  bf16* Vs = Ks + BK * LDH;

  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const size_t base = (size_t)bh * S * D;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's rows in the tile
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  load_tile_bf16<D>(Qs, q + base, q0, S, sm_scale, true);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<LDH>(qa[kk], Qs, r0, kk);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int nk = (S + BK - 1) / BK;
  const int hi = causal ? min((q0 + BQ + BK - 1) / BK, nk) : nk;
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile_bf16<D>(Ks, k + base, k0, S, 1.f, false);
    load_tile_bf16<D>(Vs, v + base, k0, S, 1.f, false);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        load_b_nk<LDH>(b0, b1, Ks, nt * 8, kk);
        mma(s[nt], qa[kk], b0, b1);
      }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        if (col >= S || (causal && col > rows[e >> 1])) s[nt][e] = NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m[h], quad_max(mx[h]));
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m_new[e >> 1]);
        psum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      alpha[h] = expf(m[h] - m_new[h]);
      l[h] = l[h] * alpha[h] + quad_sum(psum[h]);
      m[h] = m_new[h];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b_kn<LDH>(b0, b1, Vs, kk * 16, dt * 8);
        mma(acc[dt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= S) continue;
    const float lh = fmaxf(l[h], 1e-30f);
    bf16* orow = o + base + (size_t)rows[h] * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * h] / lh, acc[dt][2 * h + 1] / lh);
    if (t == 0) lse[(size_t)bh * S + rows[h]] = m[h] + logf(lh);
  }
}

template <int D>
__global__ void __launch_bounds__(NTM)
bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float sm_scale,
                    int causal) {
  constexpr int LDH = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LDH;
  bf16* Qs = Vs + BK * LDH;  // scaled and rounded q
  bf16* Qr = Qs + BQ * LDH;  // q as given
  bf16* dOs = Qr + BQ * LDH;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * LDH);
  float* delta_s = lse_s + BQ;

  const int bh = blockIdx.x, k0 = blockIdx.y * BK;
  const size_t base = (size_t)bh * S * D;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // this warp's key rows in the tile
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  load_tile_bf16<D>(Ks, k + base, k0, S, 1.f, false);
  load_tile_bf16<D>(Vs, v + base, k0, S, 1.f, false);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  const int lo = causal ? k0 / BQ : 0;
  for (int i = lo; i < nq; ++i) {
    const int q0 = i * BQ;
    __syncthreads();
    load_tile_bf16<D>(Qs, q + base, q0, S, sm_scale, true);
    load_tile_bf16<D>(Qr, q + base, q0, S, 1.f, false);
    load_tile_bf16<D>(dOs, dout + base, q0, S, 1.f, false);
    if (threadIdx.x < BQ) {
      const int rr = q0 + threadIdx.x;
      lse_s[threadIdx.x] = rr < S ? lse[(size_t)bh * S + rr] : 0.f;
      delta_s[threadIdx.x] = rr < S ? delta[(size_t)bh * S + rr] : 0.f;
    }
    __syncthreads();

    // s^T = K Qs^T and dp^T = V dO^T, 16 keys x 64 queries per warp.
    float p[BQ / 8][4], ds[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = ds[nt][e] = 0.f;  // ds holds dp^T here
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], b0, b1;
        load_a<LDH>(a, Ks, r0, kk);
        load_b_nk<LDH>(b0, b1, Qs, nt * 8, kk);
        mma(p[nt], a, b0, b1);
        load_a<LDH>(a, Vs, r0, kk);
        load_b_nk<LDH>(b0, b1, dOs, nt * 8, kk);
        mma(ds[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1), qq = q0 + ql;
        const bool ok = qq < S && !(causal && qq < keys[e >> 1]);
        const float pe = ok ? expf(p[nt][e] - lse_s[ql]) : 0.f;
        ds[nt][e] = pe * (ds[nt][e] - delta_s[ql]) * sm_scale;  // rounded by acc_to_a
        p[nt][e] = pe;
      }
    }
    // dv += p^T dO, dk += ds^T q: the 16 x 64 accumulators as A operands.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      acc_to_a(pa, p[2 * kk], p[2 * kk + 1]);
      acc_to_a(dsa, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b_kn<LDH>(b0, b1, dOs, kk * 16, dt * 8);
        mma(dv_acc[dt], pa, b0, b1);
        load_b_kn<LDH>(b0, b1, Qr, kk * 16, dt * 8);
        mma(dk_acc[dt], dsa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= S) continue;
    bf16* dkrow = dk + base + (size_t)keys[h] * D;
    bf16* dvrow = dv + base + (size_t)keys[h] * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dkrow + dt * 8 + 2 * t) =
          pack_bf16(dk_acc[dt][2 * h], dk_acc[dt][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvrow + dt * 8 + 2 * t) =
          pack_bf16(dv_acc[dt][2 * h], dv_acc[dt][2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTM)
bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int S, float sm_scale, int causal) {
  constexpr int LDH = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // scaled and rounded q
  bf16* dOs = Qs + BQ * LDH;
  bf16* Ks = dOs + BQ * LDH;
  bf16* Vs = Ks + BK * LDH;

  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const size_t base = (size_t)bh * S * D;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  load_tile_bf16<D>(Qs, q + base, q0, S, sm_scale, true);
  load_tile_bf16<D>(dOs, dout + base, q0, S, 1.f, false);
  float my_lse[2], my_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    my_lse[h] = rows[h] < S ? lse[(size_t)bh * S + rows[h]] : 0.f;
    my_delta[h] = rows[h] < S ? delta[(size_t)bh * S + rows[h]] : 0.f;
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) dq_acc[dt][0] = dq_acc[dt][1] = dq_acc[dt][2] = dq_acc[dt][3] = 0.f;

  const int nk = (S + BK - 1) / BK;
  const int hi = causal ? min((q0 + BQ + BK - 1) / BK, nk) : nk;
  for (int j = 0; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile_bf16<D>(Ks, k + base, k0, S, 1.f, false);
    load_tile_bf16<D>(Vs, v + base, k0, S, 1.f, false);
    __syncthreads();

    // s = Qs K^T and dp = dO V^T, 16 queries x 64 keys per warp.
    float s[BK / 8][4], ds[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = ds[nt][e] = 0.f;  // ds holds dp here
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], b0, b1;
        load_a<LDH>(a, Qs, r0, kk);
        load_b_nk<LDH>(b0, b1, Ks, nt * 8, kk);
        mma(s[nt], a, b0, b1);
        load_a<LDH>(a, dOs, r0, kk);
        load_b_nk<LDH>(b0, b1, Vs, nt * 8, kk);
        mma(ds[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = rows[h] < S && col < S && !(causal && col > rows[h]);
        const float pe = ok ? expf(s[nt][e] - my_lse[h]) : 0.f;
        ds[nt][e] = pe * (ds[nt][e] - my_delta[h]) * sm_scale;  // rounded by acc_to_a
      }
    }
    // dq += ds K.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t dsa[4];
      acc_to_a(dsa, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b_kn<LDH>(b0, b1, Ks, kk * 16, dt * 8);
        mma(dq_acc[dt], dsa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= S) continue;
    bf16* dqrow = dq + base + (size_t)rows[h] * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dqrow + dt * 8 + 2 * t) =
          pack_bf16(dq_acc[dt][2 * h], dq_acc[dt][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// Host side: launch on the caller's stream, report the launch status.

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int S, int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 2 * BK) * (D + 1) * sizeof(float);
  cudaError_t err = set_smem(fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + BQ - 1) / BQ);
  fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, void* dk, void* dv, int bh,
                       int S, int causal, float sm_scale, cudaStream_t stream) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);

  const size_t smem_kv = (size_t)(2 * BK + 3 * BQ) * (D + 1) * sizeof(float) + 2 * BQ * sizeof(float);
  cudaError_t err = set_smem(bwd_dkdv_kernel<D>, smem_kv);
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<D><<<dim3(bh, (S + BK - 1) / BK), NT, smem_kv, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<float*>(dk), static_cast<float*>(dv), S, sm_scale,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = (size_t)(2 * BQ + 2 * BK) * (D + 1) * sizeof(float);
  err = set_smem(bwd_dq_kernel<D>, smem_q);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<D><<<dim3(bh, (S + BQ - 1) / BQ), NT, smem_q, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<float*>(dq), S, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                           int bh, int S, int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 2 * BK) * (D + 8) * sizeof(bf16);
  cudaError_t err = set_smem(fwd_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  fwd_mma_kernel<D><<<dim3(bh, (S + BQ - 1) / BQ), NTM, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), S, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, void* dk, void* dv,
                           int bh, int S, int causal, float sm_scale, cudaStream_t stream) {
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);

  const size_t smem_kv = (size_t)(2 * BK + 3 * BQ) * (D + 8) * sizeof(bf16) + 2 * BQ * sizeof(float);
  cudaError_t err = set_smem(bwd_dkdv_mma_kernel<D>, smem_kv);
  if (err != cudaSuccess) return err;
  bwd_dkdv_mma_kernel<D><<<dim3(bh, (S + BK - 1) / BK), NTM, smem_kv, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S,
      sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = (size_t)(2 * BQ + 2 * BK) * (D + 8) * sizeof(bf16);
  err = set_smem(bwd_dq_mma_kernel<D>, smem_q);
  if (err != cudaSuccess) return err;
  bwd_dq_mma_kernel<D><<<dim3(bh, (S + BQ - 1) / BQ), NTM, smem_q, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<bf16*>(dq), S, sm_scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). D: 64 or 128.
// Returns a cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                         int S, int D, int dtype, int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_fwd<64>(q, k, v, o, lse, bh, S, causal, sm_scale, st);
  if (dtype == 0 && D == 128) return launch_fwd<128>(q, k, v, o, lse, bh, S, causal, sm_scale, st);
  if (dtype == 1 && D == 64) return launch_fwd_mma<64>(q, k, v, o, lse, bh, S, causal, sm_scale, st);
  if (dtype == 1 && D == 128) return launch_fwd_mma<128>(q, k, v, o, lse, bh, S, causal, sm_scale, st);
  return cudaErrorInvalidValue;
}

extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, void* dk, void* dv, int bh,
                         int S, int D, int dtype, int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, S, causal, sm_scale, st);
  if (dtype == 0 && D == 128)
    return launch_bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, S, causal, sm_scale, st);
  if (dtype == 1 && D == 64)
    return launch_bwd_mma<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, S, causal, sm_scale, st);
  if (dtype == 1 && D == 128)
    return launch_bwd_mma<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, S, causal, sm_scale, st);
  return cudaErrorInvalidValue;
}
