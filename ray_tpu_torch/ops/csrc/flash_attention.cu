// Flash attention for Hopper (sm_90a): forward and backward, hand-written CUDA.
//
// Layout: q, k, v, o, do, dq, dk, dv are contiguous (bh, S, D) in T (float or
// bfloat16); lse and delta are contiguous (bh, S) float. D is 64 or 128; any
// S >= 1 works (the ragged last tile is masked).
//
// Arithmetic mirrors the TPU kernels it replaces, rounding included: q is
// pre-scaled by sm_scale and rounded to T; p is rounded to T before the PV
// and P^T dO products; ds is rounded to T before the dS K and dS^T Q
// products. Every product accumulates in f32; lse = m + ln(max(l, 1e-30)).
//
// Two sets of kernels:
// - bfloat16, the training path (the section "bf16 on Hopper" below): a
//   forward and a single-recompute backward whose every product is a wgmma
//   fed by TMA through an mbarrier ring, and a small kernel that rounds the
//   backward's f32 dq sum to bf16;
// - float32: products as scalar FMAs on the CUDA cores, since the tensor
//   cores would take f32 operands as TF32. Tiles are staged in shared memory
//   as f32; 256 threads per CTA, four per tile row. Thread t owns row t/4 of
//   its tile and, of the other tile, the columns t%4 + 4j. A row's softmax
//   statistics live in registers, replicated over its four lanes and reduced
//   with shuffles; the probabilities a thread needs from its row-mates arrive
//   by shuffle. Tiles keep a row stride of D + 1 floats, so every access
//   pattern is free of bank conflicts.

#include <cuda.h>  // CUtensorMap and its enums; the encoder itself comes through the runtime
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
// So the f32 backward is two kernels, with no atomics and a deterministic
// result:
//   dkdv: one CTA per (bh, K tile), looping over q tiles from the causal
//         lower bound: p = exp(s - lse), dv += p^T dO, dp = dO V^T,
//         ds = p (dp - delta) sm_scale, dk += ds^T q;
//   dq:   one CTA per (bh, q tile), looping over K tiles up to the diagonal,
//         recomputing p and ds, dq += ds K.
// delta = rowsum(dO * o) comes in from outside, as on the TPU.
// Bound on this card: 5 products, 64.4 GFLOP at the GPT-2 shape, ~65 us on
// the tensor cores (178 MB of traffic is ~53 us). This design recomputes s, p
// and dp in both kernels (7 products where 5 would do) and runs them on the
// CUDA cores, bound by shared-memory loads.
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

// ===========================================================================
// bf16 on Hopper: every product a wgmma, every tile brought in by TMA.
//
// The shared layer, used by both kernels:
// - Tiles move as 64-column boxes of a 3-D tensor map over (D, S, bh), with
//   the 128-byte swizzle. A box row is 64 bf16 = 128 bytes, so a box of r
//   rows is r * 128 bytes, 1024-byte aligned, in the layout a 128B-swizzle
//   wgmma descriptor reads. Rows past S of a head read as zero (the map's
//   out-of-bounds fill), never the next head's. D = 128 is two boxes.
// - The maps are encoded on the host at each call (the pointers change) and
//   passed as __grid_constant__ parameters. The encoder comes through
//   cudaGetDriverEntryPoint, so the build links no libcuda.
// - Both kernels are persistent: one CTA per SM walks a list of work items,
//   so one item's loads overlap the previous item's last products and stores.
// - A CTA is two consumer warpgroups and a producer warpgroup. One lane of
//   the producer issues the copies into a ring of mbarrier stages ("full":
//   the bytes have arrived; "empty": every consumer warp is done with the
//   stage), so the next tile's copy is in flight while the current tile's
//   products run. Registers are the tight resource: the SM gives each of
//   its four quarters 16,384, shared by the warps placed there, so a CTA of
//   9 to 12 warps starts with 168 per thread. The producer warpgroup drops
//   to 24 (setmaxnreg) so that the consumers can rise to 240: the backward's
//   dk, dv, S, dP and P/dS fragments then fit without spilling, and both
//   kernels ran faster that way than with a single producer warp at 168.
// - Each consumer warpgroup owns 64 rows of the CTA's tile and issues
//   wgmma.mma_async: SS (both operands from shared memory) or RS (A from
//   registers). A K-major operand (the reduction dimension contiguous: q, k,
//   v, dO as the A or B of a product over D) steps 32 bytes per k16. An
//   MN-major one (V, dO, q, K and dS as operands of a product over rows)
//   sets the transpose bit and steps 16 rows, 2048 bytes, per k16.
// - Threads that write shared memory which wgmma then reads (the scaled q,
//   the dS tile) fence the async proxy (fence.proxy.async) and meet at a
//   barrier before the read.
// - The f32 accumulator of a wgmma holds, per warp, rows g and g + 8 and
//   columns 2t, 2t + 1 of each 8-column chunk: the layout of mma.sync's. So
//   row statistics reduce over a quad of lanes, and packing the accumulator
//   to bf16 gives the A fragment of an RS product: the rounding point of p
//   and ds.

using bf16 = __nv_bfloat16;

constexpr int NCONS = 256;        // consumer threads: two warpgroups
constexpr int NTW = NCONS + 128;  // and a producer warpgroup that hands its registers on
constexpr int BOX = 64;          // columns per TMA box
constexpr int ROWB = 128;        // bytes per box row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half: the lower column
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, rounded up to the 1024 bytes the swizzle repeats on.
__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  return smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory; completion counts on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Add a box of f32 from shared memory into a 3-D tensor map's memory (rows
// past the tensor's end are dropped); tracked by the issuing thread's bulk group.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                               int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Wait until this thread's bulk groups have read their shared memory (the
// buffer may be rewritten) or, with all, have completed.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Generic-proxy writes to shared memory become visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma shared-memory descriptor for the 128-byte swizzle (layout type 1,
// bits 62-63): start address, leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major: 128-byte rows, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return desc128(addr, 16, 1024); }

// MN-major: 8-row groups along the reduction 1024 bytes apart, 64-column
// chunks along M or N `chunk` bytes apart (the next box).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t chunk) {
  return desc128(addr, chunk, 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (denormal results flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Move registers between warpgroups: the producer gives up what the
// consumers take (24 + 2 x 240 per SM quarter fits the 512 a 12-warp CTA
// has there).
__device__ __forceinline__ void regs_producer() { asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n"); }
__device__ __forceinline__ void regs_consumer() { asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n"); }

// Pin accumulator registers in asm-volatile order, so the compiler moves no
// read of them above a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_R32                                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "       \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R64                                                                   \
  WG_R32 ", "                                                                    \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (+)= A B for one k16 step, m64 x N, A and B from shared memory. TA, TB:
// 1 for an MN-major operand. acc = 0 starts the sum afresh.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  } else {
    static_assert(N == 128, "wgmma_ss: N is 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
}

// d (+)= A B for one k16 step, m64 x N, A from registers (four bf16 pairs per
// thread, the mma.sync A-fragment layout) and B from shared memory.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  } else {
    static_assert(N == 128, "wgmma_rs: N is 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
  }
}

// dst = bf16(src * scale) over 64 rows of NB boxes (box_stride bytes apart),
// by the 128 threads of one warpgroup, 16 bytes at a time. The swizzle
// permutes 16-byte chunks within a row, so an elementwise pass keeps it.
template <int NB>
__device__ __forceinline__ void scale_rows(uint8_t* dst, const uint8_t* src, int box_stride,
                                           float scale, int tid) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = nb * box_stride + (tid + 128 * i) * 16;
      uint4 v = *reinterpret_cast<const uint4*>(src + off);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        h[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      *reinterpret_cast<uint4*>(dst + off) = v;
    }
  }
}

// One tile's online-softmax step on an S accumulator of BN columns: masks
// columns past S (and past the row under causal) when mask is set, updates
// the row max m and sum l, turns sc into exp(s - m) and sets alpha =
// exp(m_old - m_new), the factor that rescales O. Element i of sc sits in
// row rows[(i >> 1) & 1], column k0 + 8 (i / 4) + 2t + (i & 1).
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool mask, int k0, int t,
                                             const int (&rows)[2], int S, int causal) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = k0 + (i / 4) * 8 + 2 * t + (i & 1);
      if (col >= S || (causal && col > rows[(i >> 1) & 1])) sc[i] = NEG_INF;
    }
  }
  float mx[2] = {m[0], m[1]}, neg[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = quad_max(mx[h]);
    alpha[h] = ex2((m[h] - m_new) * LOG2E);
    neg[h] = -m_new * LOG2E;
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    sc[i] = ex2(fmaf(sc[i], LOG2E, neg[(i >> 1) & 1]));
    psum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(psum[h]);
}

// ---------------------------------------------------------------------------
// Forward, bf16. Replaces ray_tpu/ops/flash_attention.py::_fwd_kernel (via
// _fwd). Persistent: one CTA per SM walks a list of (bh, 128-row q tile)
// work items, head by head and, under causal, each head's q tiles from the
// last (the most keys) to the first, dealt to the CTAs in a snake so their
// loads even out. A round of the deal covers some 16 whole heads, so their
// K and V stay in L2 while all their q tiles read them. A CTA is two
// consumer warpgroups of 64 q rows, each with its own online softmax, and a
// producer warpgroup. q is double-buffered, so the next item's q and first
// K/V tiles arrive while the current item finishes.
// Bound on this card at the GPT-2 shape (bh 192, S 1024, D 64, causal):
// 25.8 GFLOP (26 us at 989 TFLOP/s) and 101.5 MB (30 us at 3.35 TB/s), so it
// sits near the ridge; the 113 M exponentials (16 per clock per SM on the
// special-function units: ~29 us) are a third limit of the same size, and
// the K/V re-reads of 128-row q tiles (226 MB from L2) a fourth. The design
// keeps the tensor cores and the SFUs busy together: q arrives once by TMA
// and is scaled in place; 128-key K/V tiles (64 for D = 128) stream through
// a four-stage ring; S = Qs K^T is an SS wgmma and O += P V an RS wgmma with
// P packed from the S accumulator; tile j's S is issued with tile j - 1's
// P V, so one's softmax overlaps the other's product. Only the diagonal and
// ragged tiles are masked.
// D = 128 takes 64-key tiles: four stages of 128-key K and V tiles would need
// 256 KB of shared memory, more than a block may have.

template <int D>
struct FwdTile {
  static constexpr int NB = D / BOX;             // boxes per row
  static constexpr int BM = 128;                 // q rows per work item
  static constexpr int BN = D == 64 ? 128 : 64;  // keys per K/V tile
  static constexpr int STAGES = 4;
  static constexpr int Q_BYTES = NB * BM * ROWB;
  static constexpr int KV_BYTES = NB * BN * ROWB;  // one K or V tile
  static constexpr int OFF_KV = 2 * Q_BYTES;       // two q buffers; stage s: K at + 2 s KV_BYTES, V after it
  static constexpr int OFF_BAR = OFF_KV + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (4 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NTW, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                       float* __restrict__ lse, int bh, int S, float sm_scale, int causal) {
  using T = FwdTile<D>;
  uint8_t* smem = smem_base();
  const uint32_t sb = smem_u32(smem);
  const uint32_t bars = sb + T::OFF_BAR;
  auto q_full = [&](int i) { return bars + 8 * i; };
  auto q_empty = [&](int i) { return bars + 8 * (2 + i); };
  auto bar_full = [&](int s) { return bars + 8 * (4 + s); };
  auto bar_empty = [&](int s) { return bars + 8 * (4 + T::STAGES + s); };
  auto k_tile = [&](int s) { return sb + T::OFF_KV + 2 * s * T::KV_BYTES; };
  auto v_tile = [&](int s) { return sb + T::OFF_KV + (2 * s + 1) * T::KV_BYTES; };

  const int nq = (S + T::BM - 1) / T::BM, nk = (S + T::BN - 1) / T::BN, items = nq * bh;
  const int G = gridDim.x, x = blockIdx.x;
  auto item = [&](int n) { return n * G + ((n & 1) ? G - 1 - x : x); };  // this CTA's n-th item
  auto head = [&](int it) { return it / nq; };
  auto q_start = [&](int it) {  // item it: head it / nq, its q tiles from the last under causal
    const int c = it % nq;
    return (causal ? nq - 1 - c : c) * T::BM;
  };
  auto n_tiles = [&](int q0) { return causal ? min((q0 + T::BM + T::BN - 1) / T::BN, nk) : nk; };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), NCONS / 32);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCONS / 32) {  // the producer warpgroup: one lane issues every copy
    regs_producer();
    if (warp == NCONS / 32 && lane == 0) {
      int tile = 0;  // K/V tiles issued so far, over all items: the ring position
      for (int n = 0, it = item(0); it < items; it = item(++n)) {
        const int b = head(it), q0 = q_start(it), qb = n & 1;
        if (n >= 2) mbar_wait(q_empty(qb), (n / 2 - 1) & 1);
        mbar_arrive_expect_tx(q_full(qb), T::Q_BYTES);
        for (int nb = 0; nb < T::NB; ++nb)
          tma_load(sb + qb * T::Q_BYTES + nb * T::BM * ROWB, &tm_q, q_full(qb), nb * BOX, q0, b);
        for (int j = 0, nt = n_tiles(q0); j < nt; ++j, ++tile) {
          const int s = tile % T::STAGES;
          if (tile >= T::STAGES) mbar_wait(bar_empty(s), (tile / T::STAGES - 1) & 1);
          mbar_arrive_expect_tx(bar_full(s), 2 * T::KV_BYTES);
          for (int nb = 0; nb < T::NB; ++nb) {
            tma_load(k_tile(s) + nb * T::BN * ROWB, &tm_k, bar_full(s), nb * BOX, j * T::BN, b);
            tma_load(v_tile(s) + nb * T::BN * ROWB, &tm_v, bar_full(s), nb * BOX, j * T::BN, b);
          }
        }
      }
    }
    return;
  }

  regs_consumer();
  const int w = warp / 4, wi = warp % 4, g = lane / 4, t = lane % 4;
  int tile = 0;  // K/V tiles consumed so far, over all items
  for (int n = 0, it = item(0); it < items; it = item(++n)) {
    const int b = head(it), q0 = q_start(it), nt = n_tiles(q0), qb = n & 1;
    const int a = q0 + 64 * w;  // this warpgroup's first q row
    const int rows[2] = {a + 16 * wi + g, a + 16 * wi + g + 8};
    const uint32_t q_rows = qb * T::Q_BYTES + 64 * w * ROWB;  // this warpgroup's rows in box 0

    mbar_wait(q_full(qb), (n / 2) & 1);
    scale_rows<T::NB>(smem + q_rows, smem + q_rows, T::BM * ROWB, sm_scale, threadIdx.x % 128);
    fence_async_smem();
    bar_sync(1 + w, 128);

    // Online softmax per row: m, the running max of s; l, the running sum
    // of exp(s - m); acc holds O relative to m.
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    float acc[D / 2], sc[T::BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    uint32_t pa[T::BN / 16][4];  // the previous tile's P, rounded to bf16: A fragments of P V

    auto wait_kv = [&](int j) {
      mbar_wait(bar_full((tile + j) % T::STAGES), ((tile + j) / T::STAGES) & 1);
    };
    auto issue_s = [&](int j) {  // sc = Qs K_j^T
      const uint32_t kt = k_tile((tile + j) % T::STAGES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T::BN, 0, 0>(sc, desc_k(sb + q_rows + (kk / 4) * T::BM * ROWB + (kk % 4) * 32),
                              desc_k(kt + (kk / 4) * T::BN * ROWB + (kk % 4) * 32), kk);
      wg_commit();
    };
    auto issue_pv = [&](int j) {  // acc += P_j V_j
      const uint32_t vt = v_tile((tile + j) % T::STAGES);
#pragma unroll
      for (int ks = 0; ks < T::BN / 16; ++ks)
        wgmma_rs<D, 1>(acc, pa[ks], desc_mn(vt + ks * 16 * ROWB, T::BN * ROWB), 1);
      wg_commit();
    };
    auto release_kv = [&](int j) {
      if (lane == 0) mbar_arrive(bar_empty((tile + j) % T::STAGES));
    };
    auto softmax = [&](int j) {  // sc = exp(s - m); m, l and alpha updated
      const int k0 = j * T::BN;
      softmax_tile<T::BN>(sc, m, l, alpha, (causal && k0 + T::BN - 1 > a) || k0 + T::BN > S, k0,
                          t, rows, S, causal);
    };
    auto pack_p = [&] {
#pragma unroll
      for (int ks = 0; ks < T::BN / 16; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
    };

    wait_kv(0);
    wg_fence();
    issue_s(0);
    wg_wait<0>();
    fence_regs(sc);
    softmax(0);
    pack_p();
    // Tile j's S is issued together with tile j - 1's P V, and tile j's
    // softmax runs while that product is in flight; acc and pa are left
    // alone until it is done. A stage is released once its V has been read.
    for (int j = 1; j < nt; ++j) {
      wait_kv(j);
        wg_fence();
      issue_s(j);
      issue_pv(j - 1);
        wg_wait<1>();
      fence_regs(sc);
      softmax(j);
      wg_wait<0>();
      fence_regs(acc);
      release_kv(j - 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p();
    }
    wg_fence();
    issue_pv(nt - 1);
    wg_wait<0>();
    fence_regs(acc);
    release_kv(nt - 1);
    if (lane == 0) mbar_arrive(q_empty(qb));
    tile += nt;

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= S) continue;
      const float lh = fmaxf(l[h], 1e-30f), inv = 1.f / lh;
      bf16* orow = o + ((size_t)b * S + rows[h]) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      if (t == 0) lse[(size_t)b * S + rows[h]] = m[h] + logf(lh);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, bf16. Replaces ray_tpu/ops/flash_attention.py::_bwd_fused_kernel
// (via _bwd), with its single recompute: five products per (q tile, K tile).
// Persistent: one CTA per SM walks a list of (bh, 128-row K tile) work items,
// head by head, the K tiles with the most q tiles first under causal, dealt
// in a snake as in the forward. A CTA is two consumer warpgroups of 64 keys
// and a producer warpgroup (one warp of it works; all of it gives its
// registers to the consumers). An item's K and V are loaded once
// (double-buffered at D = 64, so the next item's arrive early); the CTA walks
// the 64-row q tiles from the causal lower bound, each bringing q, dO, lse
// and delta through a ring. Per q tile, each warpgroup:
//   1. dP^T = V dO^T, then S^T = K Qs^T (SS; Qs is its own scaled, rounded
//      copy of q, written beside q in shared memory while dP^T runs);
//   2. P^T = exp(S^T - lse), masked; dS^T = P^T (dP^T - delta) sm_scale;
//   3. dV += P^T dO and dK += dS^T Q (RS: P^T and dS^T packed to bf16 from
//      the accumulators; dO and q as given, MN-major);
//   4. stores its dS^T rows (bf16) to a shared tile, 128 keys x 64 q;
//   5. on alternate q tiles, once both halves are in, dQ_part = dS K (SS, dS
//      and K MN-major) over all 128 keys, staged in shared memory and added
//      to an f32 dq sum in device memory by a TMA bulk reduce
//      (cp.reduce.async.bulk.tensor .add), issued by one thread.
// The TPU kernel sums dq in order in VMEM across its sequential K axis; here
// the CTAs of one head add into the same rows in no fixed order, so dq's f32
// sum (and, rarely, its bf16 rounding) varies from run to run. dk and dv are
// summed in registers in a fixed order and are bit-reproducible. A second
// kernel rounds the dq sum to bf16 once, as the TPU kernel rounds its
// scratch once.
// Bound on this card at the GPT-2 shape: 5 products, 64.4 GFLOP (65 us at
// 989 TFLOP/s) and 178 MB (53 us), so bound by the tensor cores. The design
// does each product once on wgmma, streams q and dO by TMA behind the
// products, and keeps dk, dv and the p/ds tiles on chip; what reaches device
// memory besides the inputs is one f32 dq add per (q tile, K tile), 226 MB
// of adds into L2 at that shape.

template <int D>
struct BwdTile {
  static constexpr int NB = D / BOX;
  static constexpr int BKEY = 128;  // keys per work item, 64 per consumer warpgroup
  static constexpr int BROW = 64;   // q rows per step
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int KV_BUFS = D == 64 ? 2 : 1;  // D = 128 has no room for a second
  static constexpr int KV_BYTES = NB * BKEY * ROWB;
  static constexpr int QT_BYTES = NB * BROW * ROWB;
  static constexpr int DS_BYTES = BKEY * ROWB;  // dS^T: 128 keys x 64 q
  static constexpr int OFF_RING = KV_BUFS * 2 * KV_BYTES;  // buffer i: K at 2 i KV_BYTES, V after it
  static constexpr int OFF_QS = OFF_RING + STAGES * 2 * QT_BYTES;  // stage s: q at + 2 s QT_BYTES, dO after
  static constexpr int OFF_DS = OFF_QS + 2 * QT_BYTES;     // warpgroup w's Qs at OFF_QS + w QT_BYTES
  static constexpr int OFF_STATS = OFF_DS + 2 * DS_BYTES;  // two dS^T tiles, alternating by step
  static constexpr int OFF_DQ = OFF_STATS + STAGES * 2 * BROW * 4;  // stage s: lse * log2(e), delta
  static constexpr int DQ_BYTES = BROW * BOX * 4;  // a warpgroup's f32 dQ part, 64 columns at a time
  static constexpr int OFF_BAR = OFF_DQ + 2 * DQ_BYTES;  // as two 32-column boxes, 128B-swizzled
  static constexpr int SMEM = OFF_BAR + 8 * (2 * KV_BUFS + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NTW, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int bh, int S, float sm_scale, int causal) {
  using T = BwdTile<D>;
  uint8_t* smem = smem_base();
  const uint32_t sb = smem_u32(smem);
  const uint32_t bars = sb + T::OFF_BAR;
  auto kv_full = [&](int i) { return bars + 8 * i; };
  auto kv_empty = [&](int i) { return bars + 8 * (T::KV_BUFS + i); };
  auto bar_full = [&](int s) { return bars + 8 * (2 * T::KV_BUFS + s); };
  auto bar_empty = [&](int s) { return bars + 8 * (2 * T::KV_BUFS + T::STAGES + s); };
  auto k_buf = [&](int i) { return 2 * i * T::KV_BYTES; };  // byte offsets
  auto v_buf = [&](int i) { return (2 * i + 1) * T::KV_BYTES; };
  auto q_tile = [&](int s) { return T::OFF_RING + 2 * s * T::QT_BYTES; };
  auto do_tile = [&](int s) { return T::OFF_RING + (2 * s + 1) * T::QT_BYTES; };
  auto stats = [&](int s) { return reinterpret_cast<float*>(smem + T::OFF_STATS) + 2 * T::BROW * s; };

  const int nq = (S + T::BROW - 1) / T::BROW, nk = (S + T::BKEY - 1) / T::BKEY, items = nk * bh;
  const int G = gridDim.x, x = blockIdx.x;
  auto item = [&](int n) { return n * G + ((n & 1) ? G - 1 - x : x); };  // this CTA's n-th item
  // Item it: head it / nk, K tile it % nk; its first q tile under causal.
  auto first_q = [&](int it) { return causal ? (it % nk) * T::BKEY / T::BROW : 0; };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < T::KV_BUFS; ++i) {
      mbar_init(kv_full(i), 1);
      mbar_init(kv_empty(i), NCONS / 32);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(bar_full(s), 32);  // the working producer warp's lanes
      mbar_init(bar_empty(s), NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCONS / 32) {  // the producer warpgroup: in its first warp, lane 0 issues the
    regs_producer();         // copies and every lane loads the row stats
    if (warp > NCONS / 32) return;
    int step = 0;  // q tiles issued so far, over all items: the ring position
    for (int n = 0, it = item(0); it < items; it = item(++n)) {
      const int b = it / nk, k0 = (it % nk) * T::BKEY, kb = n % T::KV_BUFS;
      if (lane == 0) {
        if (n >= T::KV_BUFS) mbar_wait(kv_empty(kb), (n / T::KV_BUFS - 1) & 1);
        mbar_arrive_expect_tx(kv_full(kb), 2 * T::KV_BYTES);
        for (int nb = 0; nb < T::NB; ++nb) {
          tma_load(sb + k_buf(kb) + nb * T::BKEY * ROWB, &tm_k, kv_full(kb), nb * BOX, k0, b);
          tma_load(sb + v_buf(kb) + nb * T::BKEY * ROWB, &tm_v, kv_full(kb), nb * BOX, k0, b);
        }
      }
      for (int i = first_q(it); i < nq; ++i, ++step) {
        const int s = step % T::STAGES, q0 = i * T::BROW;
        if (step >= T::STAGES) mbar_wait(bar_empty(s), (step / T::STAGES - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(bar_full(s), 2 * T::QT_BYTES);
          for (int nb = 0; nb < T::NB; ++nb) {
            tma_load(sb + q_tile(s) + nb * T::BROW * ROWB, &tm_q, bar_full(s), nb * BOX, q0, b);
            tma_load(sb + do_tile(s) + nb * T::BROW * ROWB, &tm_do, bar_full(s), nb * BOX, q0, b);
          }
        }
        float* st = stats(s);
        for (int r = lane; r < T::BROW; r += 32) {
          const bool in = q0 + r < S;
          st[r] = in ? lse[(size_t)b * S + q0 + r] * LOG2E : 0.f;
          st[T::BROW + r] = in ? delta[(size_t)b * S + q0 + r] : 0.f;
        }
        mbar_arrive(bar_full(s));
      }
    }
    return;
  }

  regs_consumer();
  const int w = warp / 4, wi = warp % 4, g = lane / 4, t = lane % 4;
  const uint32_t k_rows = 64 * w * ROWB;  // this warpgroup's rows in each K and V box
  const int qs = T::OFF_QS + w * T::QT_BYTES;
  const int kl = 64 * w + 16 * wi + g;  // the thread's first key row in the dS^T tile; kl & 7 == g
  const bool issuer = threadIdx.x % 128 == 0;  // issues this warpgroup's dq adds
  uint8_t* dq_stage = smem + T::OFF_DQ + w * T::DQ_BYTES;
  int step = 0;  // q tiles consumed so far, over all items
  for (int n = 0, it = item(0); it < items; it = item(++n)) {
    const int b = it / nk, k0 = (it % nk) * T::BKEY, kb = n % T::KV_BUFS;
    const int kw = k0 + 64 * w;  // this warpgroup's first key
    const int keys[2] = {kw + 16 * wi + g, kw + 16 * wi + g + 8};
    const uint32_t kbuf = sb + k_buf(kb), vbuf = sb + v_buf(kb);

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full(kb), (n / T::KV_BUFS) & 1);

    for (int i = first_q(it); i < nq; ++i, ++step) {
      const int s = step % T::STAGES, q0 = i * T::BROW, par = step & 1;
      mbar_wait(bar_full(s), (step / T::STAGES) & 1);

      // 1. dP^T, then S^T once Qs is written: 64 keys x 64 q each. dP^T
      // needs no Qs, so it runs while the warpgroup scales q.
      float sp[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64, 0, 0>(dp, desc_k(vbuf + (kk / 4) * T::BKEY * ROWB + k_rows + (kk % 4) * 32),
                           desc_k(sb + do_tile(s) + (kk / 4) * T::BROW * ROWB + (kk % 4) * 32), kk);
      wg_commit();
      scale_rows<T::NB>(smem + qs, smem + q_tile(s), T::BROW * ROWB, sm_scale, threadIdx.x % 128);
      fence_async_smem();
      bar_sync(1 + w, 128);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64, 0, 0>(sp, desc_k(kbuf + (kk / 4) * T::BKEY * ROWB + k_rows + (kk % 4) * 32),
                           desc_k(sb + qs + (kk / 4) * T::BROW * ROWB + (kk % 4) * 32), kk);
      wg_commit();
      wg_wait<0>();
      fence_regs(sp);
      fence_regs(dp);

      // 2. Element i: key keys[(i >> 1) & 1], q column 8 (i / 4) + 2t + (i & 1).
      const float* st = stats(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lse2 = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sp[4 * j + e] = ex2(fmaf(sp[4 * j + e], LOG2E, -((e & 1) ? lse2.y : lse2.x)));
      }
      if ((causal && q0 < kw + 64) || q0 + T::BROW > S || kw + 64 > S) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qq = q0 + (e / 4) * 8 + 2 * t + (e & 1), key = keys[(e >> 1) & 1];
          if (qq >= S || key >= S || (causal && qq < key)) sp[e] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(st + T::BROW + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = sp[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * sm_scale;
      }
      uint32_t pa[4][4], dsa[4][4];  // P^T and dS^T rounded to bf16: A fragments
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[ks][r] = pack_bf16(sp[8 * ks + 2 * r], sp[8 * ks + 2 * r + 1]);
          dsa[ks][r] = pack_bf16(dp[8 * ks + 2 * r], dp[8 * ks + 2 * r + 1]);
        }

      // 4 (stored first, read last). dS^T rows to the shared tile in the
      // 128-byte swizzle: row r, 16-byte chunk c at r * 128 + ((c ^ (r & 7)) << 4).
      uint8_t* ds_tile = smem + T::OFF_DS + par * T::DS_BYTES;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<uint32_t*>(ds_tile + (kl + 8 * (r & 1)) * ROWB +
                                       (((2 * ks + (r >> 1)) ^ g) << 4) + 4 * t) = dsa[ks][r];
      fence_async_smem();

      // 3. dV += P^T dO, dK += dS^T Q.
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_rs<D, 1>(dv_acc, pa[ks], desc_mn(sb + do_tile(s) + ks * 16 * ROWB, T::BROW * ROWB), 1);
        wgmma_rs<D, 1>(dk_acc, dsa[ks], desc_mn(sb + q_tile(s) + ks * 16 * ROWB, T::BROW * ROWB), 1);
      }
      wg_commit();

      // 5. Warpgroup par takes this q tile's dQ once the other has stored its
      // half. The barrier ids alternate with the step, so an arrival for one
      // step never meets a wait for the next.
      // The part goes to shared memory as two 32-column f32 boxes in the
      // 128-byte swizzle, and one thread adds them into dq_accum by TMA.
      if (par == w) {
        bar_sync(3 + par, NCONS);
#pragma unroll
        for (int nb = 0; nb < T::NB; ++nb) {
          float dq[32];
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < T::BKEY / 16; ++ks)
            wgmma_ss<64, 1, 1>(dq, desc_mn(sb + T::OFF_DS + par * T::DS_BYTES + ks * 16 * ROWB, T::DS_BYTES),
                               desc_mn(kbuf + nb * T::BKEY * ROWB + ks * 16 * ROWB, T::BKEY * ROWB), ks);
          wg_commit();
          wg_wait<0>();
          fence_regs(dq);
          if (issuer) bulk_wait_read();  // the previous add has read the staging buffer
          bar_sync(1 + w, 128);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * wi + g + 8 * h;  // r & 7 == g
              *reinterpret_cast<float2*>(dq_stage + (j / 4) * (T::DQ_BYTES / 2) + r * ROWB +
                                         (((2 * (j % 4) + (t >> 1)) ^ g) << 4) + 8 * (t & 1)) =
                  make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
            }
          fence_async_smem();
          bar_sync(1 + w, 128);
          if (issuer) {
            for (int bx = 0; bx < 2; ++bx)
              tma_reduce_add(&tm_dq, smem_u32(dq_stage) + bx * (T::DQ_BYTES / 2), nb * BOX + 32 * bx, q0, b);
            bulk_commit();
          }
        }
      } else {
        bar_arrive(3 + par, NCONS);
        wg_wait<0>();
      }
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      if (lane == 0) mbar_arrive(bar_empty(s));
    }
    if (lane == 0) mbar_arrive(kv_empty(kb));

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (keys[h] >= S) continue;
      bf16* dkrow = dk + ((size_t)b * S + keys[h]) * D;
      bf16* dvrow = dv + ((size_t)b * S + keys[h]) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkrow + 8 * j + 2 * t) = pack_bf16(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dvrow + 8 * j + 2 * t) = pack_bf16(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
      }
    }
  }
  if (issuer) bulk_wait_all();
}

// dq = bf16(dq_accum), four values per thread per step.
__global__ void flash_bwd_dq_convert_kernel(const float4* __restrict__ acc, uint2* __restrict__ dq,
                                            size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = acc[i];
    dq[i] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// ---------------------------------------------------------------------------
// Host side: launch on the caller's stream, report the launch status.

// A failure that is not a cudaError_t: a CUresult from the tensor-map
// encoder, offset by this much so the caller can tell the two apart.
constexpr int CU_RESULT_BASE = 100000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// A (bh, S, D) tensor of bf16 (or f32) as boxes of `cols` columns (128 bytes)
// by `rows` rows, 128-byte swizzled.
int encode_bhsd(CUtensorMap* map, const void* ptr, int bh, int S, int D, int rows,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, int cols = BOX) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return CU_RESULT_BASE + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t elem_bytes = ROWB / cols;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {D * elem_bytes, (cuuint64_t)S * D * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : CU_RESULT_BASE + static_cast<int>(r);
}

// The current device's SM count: the grid of a persistent kernel.
int sm_count(int* n) {
  int dev = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int S,
               int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 2 * BK) * (D + 1) * sizeof(float);
  int err = set_smem(fwd_kernel<D>, smem);
  if (err) return err;
  const dim3 grid(bh, (S + BQ - 1) / BQ);
  fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int bh, int S, int causal,
               float sm_scale, cudaStream_t stream) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);

  const size_t smem_kv = (size_t)(2 * BK + 3 * BQ) * (D + 1) * sizeof(float) + 2 * BQ * sizeof(float);
  int err = set_smem(bwd_dkdv_kernel<D>, smem_kv);
  if (err) return err;
  bwd_dkdv_kernel<D><<<dim3(bh, (S + BK - 1) / BK), NT, smem_kv, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<float*>(dk), static_cast<float*>(dv), S, sm_scale,
      causal);
  err = cudaGetLastError();
  if (err) return err;

  const size_t smem_q = (size_t)(2 * BQ + 2 * BK) * (D + 1) * sizeof(float);
  err = set_smem(bwd_dq_kernel<D>, smem_q);
  if (err) return err;
  bwd_dq_kernel<D><<<dim3(bh, (S + BQ - 1) / BQ), NT, smem_q, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<float*>(dq), S, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                     int S, int causal, float sm_scale, cudaStream_t stream) {
  using T = FwdTile<D>;
  CUtensorMap tq, tk, tv;
  int err = encode_bhsd(&tq, q, bh, S, D, T::BM);
  if (!err) err = encode_bhsd(&tk, k, bh, S, D, T::BN);
  if (!err) err = encode_bhsd(&tv, v, bh, S, D, T::BN);
  if (!err) err = set_smem(flash_fwd_wgmma_kernel<D>, T::SMEM);
  int sms = 0;
  if (!err) err = sm_count(&sms);
  if (err) return err;
  const int items = (S + T::BM - 1) / T::BM * bh;
  flash_fwd_wgmma_kernel<D><<<items < sms ? items : sms, NTW, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), bh, S, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, void* dk, void* dv,
                     void* dq_accum, int bh, int S, int causal, float sm_scale,
                     cudaStream_t stream) {
  using T = BwdTile<D>;
  CUtensorMap tq, tk, tv, tdo, tdq;
  int err = encode_bhsd(&tq, q, bh, S, D, T::BROW);
  if (!err) err = encode_bhsd(&tk, k, bh, S, D, T::BKEY);
  if (!err) err = encode_bhsd(&tv, v, bh, S, D, T::BKEY);
  if (!err) err = encode_bhsd(&tdo, dout, bh, S, D, T::BROW);
  if (!err)  // the target of the dq adds: f32, 32-column boxes
    err = encode_bhsd(&tdq, dq_accum, bh, S, D, T::BROW, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 32);
  if (!err) err = set_smem(flash_bwd_wgmma_kernel<D>, T::SMEM);
  int sms = 0;
  if (!err) err = sm_count(&sms);
  if (err) return err;
  const int items = (S + T::BKEY - 1) / T::BKEY * bh;
  flash_bwd_wgmma_kernel<D><<<items < sms ? items : sms, NTW, T::SMEM, stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), bh, S, sm_scale, causal);
  err = cudaGetLastError();
  if (err) return err;
  const size_t n4 = (size_t)bh * S * D / 4;
  const size_t blocks = (n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16;
  flash_bwd_dq_convert_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float4*>(dq_accum), static_cast<uint2*>(dq), n4);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma). D: 64 or 128.
// Returns 0 on success, a cudaError_t, or CU_RESULT_BASE + a CUresult from
// encoding a tensor map. The bf16 kernels read their inputs by TMA: every
// pointer is 16-byte aligned.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                         int S, int D, int dtype, int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_fwd<64>(q, k, v, o, lse, bh, S, causal, sm_scale, st);
  if (dtype == 0 && D == 128) return launch_fwd<128>(q, k, v, o, lse, bh, S, causal, sm_scale, st);
  if (dtype == 1 && D == 64) return launch_fwd_wgmma<64>(q, k, v, o, lse, bh, S, causal, sm_scale, st);
  if (dtype == 1 && D == 128) return launch_fwd_wgmma<128>(q, k, v, o, lse, bh, S, causal, sm_scale, st);
  return cudaErrorInvalidValue;
}

// dq_accum: (bh, S, D) f32, zeroed by the caller; the bf16 backward sums dq
// there before rounding it into dq. The f32 backward does not read it.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, void* dk, void* dv,
                         void* dq_accum, int bh, int S, int D, int dtype, int causal,
                         float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, S, causal, sm_scale, st);
  if (dtype == 0 && D == 128)
    return launch_bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, S, causal, sm_scale, st);
  if (dtype == 1 && D == 64)
    return launch_bwd_wgmma<64>(q, k, v, dout, lse, delta, dq, dk, dv, dq_accum, bh, S, causal,
                                sm_scale, st);
  if (dtype == 1 && D == 128)
    return launch_bwd_wgmma<128>(q, k, v, dout, lse, delta, dq, dk, dv, dq_accum, bh, S, causal,
                                 sm_scale, st);
  return cudaErrorInvalidValue;
}
