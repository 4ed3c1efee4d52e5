// The building blocks of the tensor-core kernels for Hopper (sm_90a), shared
// by the 3D pair (lista3d_mma.cuh), the 2D one (lista2d_mma.cuh) and the
// weight gradient (lista3d_bwd.cu): their arguments, the staged input tile,
// the TMA engine's bulk copies on an mbarrier (RowStager stages a tile's
// rows, each at its global offset from the 16-byte grid), the 3xTF32
// operand split and the mma.sync TF32 product; the launches' host side (the
// SM count, the shared-memory limit); and the synthesis adjoint's epilogue
// arguments with sum_parts, the fixed-order sum of its per-block dtau
// partials; the phase map's tap box; the bf16 training histories' loads
// and stores. lista3d_mma.cuh says why the kernels are built this way.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "csr_prox.cuh"  // soft

namespace tf32x3 {

constexpr int kTW = 64;  // tile columns
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block can use

__device__ inline int floordiv(int x, int y) {
  return x >= 0 ? x / y : -((-x + y - 1) / y);
}

// Taps [lo, hi) of one dim whose phase-ph weights can be nonzero: the
// original kernel index s * (q + q0) + ph + p must lie in [0, P).
__device__ inline void tap_box(int s, int ph, int P, int p, int q0, int Q, int& lo, int& hi) {
  lo = max(0, floordiv(-ph - p + s - 1, s) - q0);
  hi = min(Q, floordiv(P - 1 - ph - p, s) - q0 + 1);
}

// The 2D kernels take D = Qd = 1, od = 0 and (P, pad)[0] = (1, 0).
struct MmaArgs {
  const float* in;    // (N, I, D, H, W)
  const float* wt;    // (I, Qd, Qh, Qw, O)
  float* out;         // (N, O, D, H, W)
  const float* z;     // analysis: old codes or NULL
  const float* tau;   // analysis: (N, O)
  const float* mask;  // synthesis: (N, O, D, H, W) or NULL
  const float* y;     // synthesis: (N, O, D, H, W) or NULL
  int N, I, O, D, H, W;
  int Qd, Qh, Qw;
  int od, oh, ow;
  int s;              // analysis: stride of the phase map (0: every tap)
  int P[3], pad[3];
};

// The smallest p >= x with p % 32 == 8: a channel or weight-row stride
// that spreads a fragment's 4 k-rows over 4 distinct groups of 8 banks.
__host__ __device__ inline int stride8(int x) { return x + ((40 - x % 32) % 32); }

// A float pointer's offset from the 16-byte grid, in floats (0..3).
__host__ __device__ inline unsigned mis4(const void* p) {
  return (unsigned)(reinterpret_cast<uintptr_t>(p) >> 2) & 3u;
}

// The same for elements of type T: the offset from the 16-byte grid in
// elements (0..3 for float, 0..7 for bf16); kGrid<T> elements make 16 bytes.
template <typename T>
constexpr int kGrid = 16 / (int)sizeof(T);
template <typename T>
__host__ __device__ inline unsigned mis(const void* p) {
  return (unsigned)(reinterpret_cast<uintptr_t>(p) / sizeof(T)) & (unsigned)(kGrid<T> - 1);
}

// The staged input tile, one slab a channel: TH + Qh - 1 rows of 64 + Qw - 1
// columns for each of the Qd depth taps. A staged row starts on the 16-byte
// grid and holds its columns `sh` floats in (0..3: the global offset of
// its first column from the grid, so that a bulk copy lands aligned), hence
// a pitch of the columns + 3, rounded to 4. The three-argument form lays
// the tile out in elements of which v make 16 bytes (v = 8: a bf16
// history's tile; offsets 0..v-1, pitch the columns + v - 1 rounded to v);
// tile_of<T> picks the form for element type T.
struct Tile {
  int rows, cols, pitch, slab;
  __host__ __device__ Tile(const MmaArgs& a, int TH)
      : rows(TH + a.Qh - 1), cols(kTW + a.Qw - 1),
        pitch((kTW + a.Qw - 1 + 3 + 3) & ~3),
        slab(stride8(a.Qd * (TH + a.Qh - 1) * ((kTW + a.Qw - 1 + 3 + 3) & ~3))) {}
  __host__ __device__ Tile(const MmaArgs& a, int TH, int v)
      : rows(TH + a.Qh - 1), cols(kTW + a.Qw - 1),
        pitch((kTW + a.Qw - 1 + (v - 1) + (v - 1)) & ~(v - 1)),
        slab(stride8(a.Qd * (TH + a.Qh - 1) *
                     ((kTW + a.Qw - 1 + (v - 1) + (v - 1)) & ~(v - 1)))) {}
};

template <typename T>
__host__ __device__ inline Tile tile_of(const MmaArgs& a, int TH) {
  if constexpr (sizeof(T) == 4)
    return Tile(a, TH);
  else
    return Tile(a, TH, kGrid<T>);
}

// ---- asynchronous copies: the TMA engine's bulk copies, completed on an
// mbarrier

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ inline void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_addr(bar)) : "memory");
}
__device__ inline void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
// Shared memory that the generic proxy read or wrote may next be written by
// a bulk copy (the async proxy).
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ inline void zero(float* dst, int n) {  // dst 16-byte aligned, n % 4 == 0
  for (int i = 0; i < n; i += 4) *reinterpret_cast<float4*>(dst + i) = make_float4(0.f, 0.f, 0.f, 0.f);
}
// n elements of type T (n % kGrid<T> == 0) at a 16-byte aligned dst
template <typename T>
__device__ inline void zero_n(T* dst, int n) {
  if constexpr (sizeof(T) == 4)
    zero(reinterpret_cast<float*>(dst), n);
  else
    zero(reinterpret_cast<float*>(dst), n / 2);
}
// The element zero: 0.f, or a bf16's zero bit pattern.
template <typename T>
__device__ inline T zero_of() {
  if constexpr (sizeof(T) == 4)
    return 0.f;
  else
    return __ushort_as_bfloat16((unsigned short)0);
}
// elements src[0, n) -> dst[0, n), dst and src at the same offset from the
// 16-byte grid, by one bulk copy counted on bar, widened to the grid on
// both sides: up to kGrid<T> - 1 elements (3 floats) before src and after
// src + n land in dst's padding, or on columns the caller zeroes once the
// copy has landed. With `post` false (src + n lies within kGrid<T> - 1
// elements of the source's end), the elements past the last grid line go by
// plain loads instead.
template <typename T>
__device__ inline void bulk_copy(T* dst, const T* src, int n, uint64_t* bar) {
  mbar_expect_tx(bar, (int)sizeof(T) * n);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"((int)sizeof(T) * n), "r"(smem_addr(bar)) : "memory");
}
template <typename T>
__device__ inline void copy_span(T* dst, const T* src, int n, uint64_t* bar, bool post) {
  constexpr int v = kGrid<T>;
  const int k = (int)mis<T>(src);
  dst -= k, src -= k, n += k;
  const int tail = post ? 0 : n & (v - 1);
  n = post ? (n + v - 1) & ~(v - 1) : n - tail;
  if (n > 0) bulk_copy(dst, src, n, bar);
  for (int j = n; j < n + tail; ++j) dst[j] = src[j];
}

// 3xTF32 operand split: hi = x truncated to 11 significant bits, lo = x -
// hi exactly (the tensor core reads lo's top 11 bits).
__device__ inline void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// The round-to-nearest split (kRN in the templates below): hi = x rounded
// to 11 significant bits (half a TF32 ulp added to the bit pattern, then
// truncated: ties away from zero), lo = x - hi exactly. lo takes either
// sign and |lo| is half the truncated split's bound, so the dropped lo*lo
// and the tensor core's reading of lo's top 11 bits err by a quarter as
// much and without the truncated split's pull toward zero, for one more
// integer add. The 2D pair uses it: their outputs feed the CSR proxes,
// whose jumps turn a sum's bias into flipped codes.
__device__ inline void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

template <bool kRN>
__device__ inline void split2(float x, uint32_t& hi, uint32_t& lo) {
  if (kRN)
    split_rn(x, hi, lo);
  else
    split(x, hi, lo);
}

__device__ inline void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of one m16 tile at one tap: rows (positions) g and g + 8,
// columns (channels) t and t + 4; p points at (channel t, position g), and
// channel t + 4 sits 4 slabs on (4 channels apart are a multiple of 4
// floats apart in the input, so their staged rows share offsets).
template <bool kRN = false>
__device__ inline void load_a(const float* p, int slab, uint32_t* hi, uint32_t* lo) {
  split2<kRN>(p[0], hi[0], lo[0]);
  split2<kRN>(p[8], hi[1], lo[1]);
  split2<kRN>(p[4 * slab], hi[2], lo[2]);
  split2<kRN>(p[4 * slab + 8], hi[3], lo[3]);
}

// Stages input channels [c0, c0 + CH) of sample n's depth-d tile (rows from
// h0, columns from w0, with the tap halo) into s_in, zeros outside the
// volume and past channel I: a thread a staged row, its in-volume columns
// by copy_span, on bar. The 2D kernels run it at D = Qd = 1. T is the
// input's element type: float, or bf16 for a training history that the
// weight gradient reads (a.in then points at bf16 values, the tile `tl` is
// laid out in bf16 elements, Tile(.., 8), and rows keep their offsets from
// the 16-byte grid in bf16 elements, 0..7).
template <int THREADS, int CH = 8, typename T = float>
struct RowStager {
  static constexpr unsigned kM = kGrid<T> - 1;  // offsets from the grid: & kM
  const MmaArgs& a;
  const Tile& tl;
  int n, d, h0, wbase;  // wbase: the global column of staged column 0
  int lo, hi;           // the staged columns [lo, hi) in the volume's [0, W)
  size_t total;         // floats of the input
  __device__ RowStager(const MmaArgs& a_, const Tile& tl_, int n_, int d_, int h0_, int w0)
      : a(a_), tl(tl_), n(n_), d(d_), h0(h0_), wbase(w0 + a_.ow),
        lo(min(max(-(w0 + a_.ow), 0), tl_.cols)),
        hi(max(min(a_.W - (w0 + a_.ow), tl_.cols), lo)),
        total((size_t)a_.N * a_.I * a_.D * a_.H * a_.W) {}

  __device__ const T* in() const { return reinterpret_cast<const T*>(a.in); }

  // The offset of staged row (channel c0 + ci, depth tap q, row r) from the
  // 16-byte grid, mod kGrid<T>; a linear function of q and r, so that a
  // lane can compute its rows' offsets from sh0 (q = r = 0) of its channel.
  __device__ unsigned sh0(int c0, int ci) const {
    return mis<T>(a.in) + (unsigned)wbase +
           ((((unsigned)n * a.I + c0 + ci) * a.D + d + a.od) * a.H + h0 + a.oh) * a.W;
  }
  __device__ unsigned sh(unsigned base, int q, int r) const {
    return (base + ((unsigned)q * a.H + r) * a.W) & kM;
  }

  // staged row `line` of channels [c0, c0 + CH): its place in s_in, and
  // whether it lies in the volume
  __device__ T* row(T* s_in, int line, int c0, size_t& f) const {
    const int per_ch = a.Qd * tl.rows;
    const int ci = line / per_ch, q = line % per_ch / tl.rows, r = line % tl.rows;
    const int i = c0 + ci, dd = d + q + a.od, hh = h0 + r + a.oh;
    T* p = s_in + ci * tl.slab + (line % per_ch) * tl.pitch;
    if (i >= a.I || dd < 0 || dd >= a.D || hh < 0 || hh >= a.H || hi == lo) return nullptr;
    // the flat index of staged column 0 (wraps below 0 at the first row;
    // only [lo, hi) is read)
    f = ((((size_t)n * a.I + i) * a.D + dd) * a.H + hh) * a.W + wbase;
    return p;
  }

  // the copies, on bar: a row out of the volume is zeroed, one in it gets
  // zeros out of the volume and one bulk copy of its columns [lo, hi),
  // `(mis<T>(a.in) + f) % kGrid<T>` elements into the row, widened to the
  // grid (onto those zeros only where rows are off the grid: fix() restores
  // them)
  __device__ void stage(T* s_in, int c0, uint64_t* bar) const {
    for (int line = threadIdx.x; line < CH * a.Qd * tl.rows; line += THREADS) {
      size_t f;
      T* p = row(s_in, line, c0, f);
      if (!p) {
        zero_n(s_in + (line / (a.Qd * tl.rows)) * tl.slab +
                   (line % (a.Qd * tl.rows)) * tl.pitch, tl.pitch);
        continue;
      }
      T* col0 = p + ((mis<T>(a.in) + (unsigned)f) & kM);
      for (int x = 0; x < lo; ++x) col0[x] = zero_of<T>();
      for (int x = hi; x < tl.cols; ++x) col0[x] = zero_of<T>();
      copy_span(col0 + lo, in() + (f + lo), hi - lo, bar, f + hi + kM <= total);
    }
  }

  // rows on the 16-byte grid (W % kGrid<T> == 0, an aligned input): the
  // same placement, by the lean loop the synthesis wants (its staging
  // threads run it before their products, and every warp waits for the
  // slowest at the next barrier): each row from the grid-aligned column
  // below wbase, its in-volume span aligned at both ends, zeros around it as
  // 16-byte stores
  __device__ void stage_aligned(T* s_in, int c0, uint64_t* bar) const {
    const int per_ch = a.Qd * tl.rows, wb4 = wbase & ~(int)kM;
    for (int line = threadIdx.x; line < CH * per_ch; line += THREADS) {
      const int ci = line / per_ch, q = line % per_ch / tl.rows, r = line % tl.rows;
      const int i = c0 + ci, dd = d + q + a.od, hh = h0 + r + a.oh;
      T* p = s_in + ci * tl.slab + (line % per_ch) * tl.pitch;
      const bool ok = i < a.I && dd >= 0 && dd < a.D && hh >= 0 && hh < a.H;
      const int l = ok ? min(max(-wb4, 0), tl.pitch) : tl.pitch;
      const int h = ok ? max(min(a.W - wb4, tl.pitch), l) : tl.pitch;
      zero_n(p, l);
      zero_n(p + h, tl.pitch - h);
      if (h > l)
        bulk_copy(p + l, in() + ((((size_t)n * a.I + i) * a.D + dd) * a.H + hh) * a.W + wb4 + l,
                  h - l, bar);
    }
  }

  // rows off the 16-byte grid (a width that is not a multiple of 4, or an
  // unaligned input), once the copies have landed and before the barrier
  // that publishes them: zeros again on the columns out of the volume,
  // where the widened copies wrote neighbouring floats (only a block at a
  // volume edge has such columns)
  __device__ void fix(T* s_in, int c0) const {
    if (lo == 0 && hi == tl.cols) return;
    for (int line = threadIdx.x; line < CH * a.Qd * tl.rows; line += THREADS) {
      size_t f;
      T* p = row(s_in, line, c0, f);
      if (!p) continue;
      T* col0 = p + ((mis<T>(a.in) + (unsigned)f) & kM);
      for (int x = 0; x < lo; ++x) col0[x] = zero_of<T>();
      for (int x = hi; x < tl.cols; ++x) col0[x] = zero_of<T>();
    }
  }
};

// ---- the synthesis weights: a channel's T x O floats as one span in its
// slot of a weight buffer, starting at the channel's offset from the 16-byte
// grid (the same for every stage: 8 channels are a multiple of 4 floats
// apart), with room for the copy widened to the grid (up to 6 floats past
// the span). The fragment reads outputs past O too, which only reach
// unstored columns.
__host__ __device__ inline int syn_wstride(int T, int O) { return stride8(T * O + 8); }

// one pipeline buffer: the input tile and the weight slice of 8 channels
__host__ __device__ inline int syn_buf_floats(const Tile& tl, int T, int O) {
  return 8 * tl.slab + 8 * syn_wstride(T, O);
}

// channel i's T x O floats: their distance from the 16-byte grid
__device__ inline unsigned span_sh(const MmaArgs& a, int i, int T) {
  return (mis4(a.wt) + (unsigned)i * T * a.O) & 3u;
}

// the spans of channels [c0, c0 + 8) into slots wstride apart from s_w, a
// thread (tid) a channel, on bar; zeros past channel I
template <int THREADS>
__device__ inline void stage_spans(float* s_w, const MmaArgs& a, int T, int wstride, int c0,
                                   int tid, uint64_t* bar) {
  for (int ci = tid; ci < 8; ci += THREADS) {
    float* slot = s_w + ci * wstride;
    const size_t src = (size_t)(c0 + ci) * T * a.O, len = (size_t)T * a.O;
    if (c0 + ci >= a.I)
      zero(slot, wstride);
    else  // widened to the grid within the slot
      copy_span(slot + span_sh(a, c0 + ci, T), a.wt + src, (int)len, bar,
                src + len + 3 <= (size_t)a.I * T * a.O);
  }
}

// The epilogues' 16-byte accesses: rows of a multiple of 4 floats, and every
// tensor they touch 16-byte aligned.
inline bool vec_epilogue(const MmaArgs& a) {
  return a.W % 4 == 0 && mis4(a.out) == 0 && (!a.z || mis4(a.z) == 0) &&
         (!a.mask || mis4(a.mask) == 0) && (!a.y || mis4(a.y) == 0);
}

// ---- the bf16 training histories (kernels/lista3d.py::hist_dtype): the
// forward's writers store a round-to-nearest-even bf16 copy of their fp32
// output beside it, the synthesis adjoints read the codes, and the weight
// gradient one operand, as bf16. A vector epilogue's group of 4 positions
// is 8 bytes of bf16.

// 8-byte aligned: a vector epilogue's group of 4 bf16 values
inline bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7u) == 0; }

// vec_epilogue with a bf16 history h beside the fp32 tensors (the
// forward's copy, or the adjoint's codes in place of a.z): its groups 8-byte
// aligned
inline bool vec_epilogue_bf16(MmaArgs a, const void* h) {
  if (h == a.z) a.z = nullptr;
  return vec_epilogue(a) && aligned8(h);
}

// 4 floats rounded to nearest even, as 8 bytes at p (8-byte aligned)
__device__ inline void store_bf16x4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y));
  const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v.z), __float2bfloat16_rn(v.w));
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// 4 bf16 values at p (8-byte aligned) as floats (exact)
__device__ inline float4 load_bf16x4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// an element as a float (a bf16 value exactly)
__device__ inline float to_f(float x) { return x; }
__device__ inline float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---- the launches' host side

// The current device's SM count (cached per device).
inline cudaError_t sm_count(int& sms) {
  static int counts[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  sms = counts[dev];
  return cudaSuccess;
}

// Raises kern's dynamic shared memory limit on the current device to smem,
// once a size: `limit` is the caller's record (a static, one per kernel) of
// what it set on each device, so that a call of a size met before makes no
// cudaFuncSetAttribute call.
inline cudaError_t raise_smem_limit(const void* kern, int smem, int (&limit)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem <= limit[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) limit[dev] = smem;
  return err;
}

// ---- the synthesis adjoint of the reverse pass, as the analyses' second
// epilogue: with u the correlation of the cotangent g (MmaArgs::in) with
// B's unflipped bank at the codes z (MmaArgs::z),
//   dz = [base +] alpha * u;  out = dv = 1{z != 0} dz;
//   part[blk][n, o] = -sum of sign(z) dz over block blk's positions, in a
//   fixed order, which sum_parts then sums over the blocks in a fixed order.
struct AdjointArgs {
  const float* base;  // (N, O, D, H, W) or NULL (zeros)
  float* part;        // (blocks, N, O)
  float alpha;
};

// -sign(z) * dz, the element's term of dtau
__device__ inline float dtau_term(float z, float dz) {
  return z > 0.f ? -dz : (z < 0.f ? dz : 0.f);
}

namespace {

// out[r] = sum_{b < nb} part[b * rows + r] in a fixed order: a block takes
// 32 consecutive r (coalesced loads) x 32 groups of partials, group j sums
// b = j, j + 32, ... ascending, and the 32 group sums are added in order
// j = 0..31. There are few r (N x codes) and many partials (the native
// step's 6,720 blocks), so the groups spread each r's sum over 32 threads.
__global__ void __launch_bounds__(1024) sum_parts(const float* part, float* out, int rows,
                                                  int nb) {
  __shared__ float group[32][33];
  const int ri = threadIdx.x % 32, j = threadIdx.x / 32;
  const int r = blockIdx.x * 32 + ri;
  float s = 0.f;
  if (r < rows)
    for (int b = j; b < nb; b += 32) s += part[(size_t)b * rows + r];
  group[j][ri] = s;
  __syncthreads();
  if (j == 0 && r < rows) {
    float t = 0.f;
    for (int k = 0; k < 32; ++k) t += group[k][ri];
    out[r] = t;
  }
}

int launch_sum_parts(const float* part, float* out, int rows, int nb, cudaStream_t stream) {
  sum_parts<<<(rows + 31) / 32, 1024, 0, stream>>>(part, out, rows, nb);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace tf32x3
