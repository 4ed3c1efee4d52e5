// The weight gradient of the reverse pass (lista3d_wgrad, video and images)
// on the tensor cores of Hopper (sm_90a), in 3xTF32.
//
// Replaces, with the synthesis adjoints (lista3d_syn_adjoint in lista3d.cu;
// lista2d_syn_adjoint and the CSR ones, lista2d_syn_adjoint_csr and _csrf2,
// in lista2d.cu: the forward analyses' mainloops with adjoint epilogues) and
// the analysis adjoint (the forward synthesis), the TPU kernels
// cdlnet_tpu/kernels/lista3d_bwd_resident.py::_kernel_bwd_resident (the
// whole-K reverse, K2), its per-iteration pair lista3d_bwd.py::
// _kernel_syn_bwd/_kernel_ana_bwd (K4), the banded and ring reverses (K10,
// K12) and the 2D reverses lista2d.py::_kernel_bwd (K6, with its CSR prox
// modes) and lista2d_tiled_bwd.py::_kernel_tiled_bwd (K8). The reverse loop
// (kernels/lista3d_bwd.py) runs one iteration at a time from the stored code
// and residual histories in the stride-phase domain.
//
//   lista3d_wgrad: the weight gradient of one correlation,
//       dw[i, q, o] = alpha * sum_{n,p} x[n, i, p + q + off] y[n, o, p],
//       in the banks' own (I, Qd, Qh, Qw, O) layout; dA (x = r, y = dv) and
//       dB (x = g, y = z: the swapped form, whose adjoint bank is dB) alike;
//       at D = Qd = 1 for images. A table of phase rows (i, q) says which
//       rows it computes: the reverse loop passes the rows that the phase
//       map keeps (the nonzero taps of the prep's valid mask), every other
//       row is written as zeros.
//
// The weight gradient's design. At the flagship video training shape (N =
// 2, M = 169, Cp = 8, an 8x64x64 code grid, 4x4x3 phase taps) a call is a
// GEMM of 169 codes x 245 phase rows (of 384: the rest are structural zeros)
// over 65,536 code positions: 5.4 GFLOP, 0.0329 ms as three TF32 products
// at the dense 495 TFLOP/s, against 46 MB of operands (0.014 ms at 3.35
// TB/s); at the 2D one (10 x 128^2, Cp = 4, 4x4 taps) 169 x 49 over 40,960
// positions, where reading y (27.7 MB) bounds it. The output is small and
// the reduction long, so the positions are split over the blocks:
//
// - The GEMM: M = codes (A from y, whose positions are contiguous), N = the
//   phase rows (B from x), K = code positions, 8 a k8 step along a code
//   row. mma.sync.m16n8k8 TF32 in 3xTF32 with the round-to-nearest split
//   (mma_tf32.cuh's split_rn), each k8 step's three products into a fresh
//   fragment added to the running sums in fp32: the sums run over up to
//   ~6,000 positions a block, so the tensor core's truncating sums never
//   chain.
// - A block owns 192 codes (12 m16 tiles: M = 169 pads 14%, the padding
//   rows staged as zeros) and up to 128 phase rows (16 n8 tiles) with 12
//   warps, one block an SM: 3 along codes (4 m16 tiles each) x 4 along rows
//   (4 n8 tiles each, the block's tiles dealt round-robin) where a block
//   has more than 8 row tiles, else 6 x 2 (2 m16 tiles x 4 n8 tiles each).
//   Every warp runs the same fully unrolled 4-tile product chains,
//   interleaved, with no branch: a tile past the block's rows has zero B
//   fragments, and the codes past 169 are zero rows, which cost the slowest
//   warp nothing. Only the rows of the table enter the n8 tiles (245 of 384
//   at the flagship: 31 n8 tiles, two blocks; 49 of 64 in 2D: 7 n8 tiles);
//   a block's rows span at most 8 input channels (the table's partition,
//   kernels/lista3d_bwd.py).
// - A stage is one code row of 64 positions: y's 192 code rows and x's
//   channel rows with the tap halo (8 channels x Qd x Qh rows of 64 + Qw - 1
//   columns), each row by one bulk copy on the stage's mbarrier (RowStager,
//   keeping each row's offset from the 16-byte grid), through two buffers,
//   so that the next stage's copies fly while this stage's products run.
//   Each B column reads its row at its own tap shift, as the analyses read
//   their taps: no im2col reaches device memory. y's staged rows are 68
//   floats apart (4 mod 32) and x's tap rows 8 mod 32, so the fragment
//   loads are conflict-free on aligned rows.
// - Filling the card: the launch splits the code rows (stages) into the
//   fewest contiguous chunks whose blocks fill the SMs (one rule, from the
//   block count and the SM count); each block writes its partial sums of
//   its rows, and fold_rows sums the splits in ascending order (and writes
//   the zero rows). No float atomics: two runs are bitwise equal.
// - bf16 training histories (kernels/lista3d.py::hist_dtype; kHist): dA's
//   x (the residual r_{k-1}) or dB's y (the codes z_{k-1}) may be a bf16
//   history. Its rows stage by the same bulk copies, as bf16 (RowStager on
//   bf16 elements: the 16-byte grid is 8 of them, so the aligned path asks
//   for W % 8 == 0 and an aligned history, and every other width stages
//   each row at its own offset), and each fragment load converts its value
//   to fp32, exactly. A bf16 value has 8 significant bits, so the 3xTF32
//   split's low part is zero and hi is the value: the products are those of
//   the fp32 kernel on the rounded operand, less the one with the zero low
//   part (two products of the three a tile; a zero product adds nothing).
//
// Plain C interface for ctypes: each entry returns cudaGetLastError() (or
// the first CUDA error met) as an int; 0 means launched.

#include <algorithm>
#include <type_traits>

#include "mma_tf32.cuh"

namespace wgrad {

using namespace tf32x3;

constexpr int kThreads = 384;      // 12 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 4, kNT = 4;    // a warp's m16 code tiles, n8 row tiles (at most)
constexpr int kBO = 192;           // codes a block (12 m16 tiles; zero rows past O)
// phase rows a block, at most: 4 row warps' kNT n8 tiles (kernels/
// lista3d_bwd.py's WGRAD_BLOCK_ROWS, with WGRAD_BLOCK_CHANNELS = kXCH)
static_assert(4 * kNT * 8 == 128, "the wrapper's row blocks");
constexpr int kXCH = 8;            // input channels a block stages
constexpr int kYS = 68;            // floats between staged y rows: 4 mod 32
constexpr int kYSb = 72;           // bf16 y rows: 144 bytes apart, 4 mod 32 words

struct Args {
  MmaArgs x;         // x (N, I, D, H, W) with the taps and offsets
  MmaArgs y;         // y (N, O, D, H, W): O channels, one tap
  const int* table;  // each row's slot or -1 (I * T) | the slots' rows (R) |
                     // each row block's first slot (RB + 1)
  float* part;       // (splits, R, O)
  int R, chunk, stages;
};

// the staged tiles of one buffer: x's kXCH channels, then y's kBO codes
__host__ __device__ inline int x_floats(const MmaArgs& x) { return kXCH * Tile(x, 1).slab; }
__host__ __device__ inline int buf_floats(const MmaArgs& x) { return x_floats(x) + kBO * kYS; }

// D = A * B with C = 0, the three-product chain's first (a zero register
// for C, so that no fragment is zeroed before it)
__device__ inline void mma_tf32_first(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// One stage's products of a warp: its kNT n8 row tiles (their B fragments
// split once a k8 step; zeros for a tile past the block's rows) against its
// MT m16 code tiles (zero rows past code O), each tile's three products
// (lo*hi, hi*lo, hi*hi) into a fresh fragment added to its running sums in
// fp32. The products are volatile asm, issued in the order written, so the
// kNT tiles' chains are interleaved: no product waits on the one just
// before it. No branch: the loads and splits of the next code tile can be
// scheduled under this one's products.
template <int MT, typename TX, typename TY>
__device__ inline void stage_products(float (&acc)[kMT][kNT][4], const TX* const (&xb)[kNT],
                                      const bool (&xok)[kNT], const TY* const (&ya)[kMT][2]) {
#pragma unroll
  for (int k0 = 0; k0 < kTW; k0 += 8) {
    uint32_t bhi[kNT][2], blo[kNT][2];
#pragma unroll
    for (int jj = 0; jj < kNT; ++jj) {
      split_rn(xok[jj] ? to_f(xb[jj][k0]) : 0.f, bhi[jj][0], blo[jj][0]);
      split_rn(xok[jj] ? to_f(xb[jj][k0 + 4]) : 0.f, bhi[jj][1], blo[jj][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t ahi[4], alo[4];
      split_rn(to_f(ya[mt][0][k0]), ahi[0], alo[0]);
      split_rn(to_f(ya[mt][1][k0]), ahi[1], alo[1]);
      split_rn(to_f(ya[mt][0][k0 + 4]), ahi[2], alo[2]);
      split_rn(to_f(ya[mt][1][k0 + 4]), ahi[3], alo[3]);
      float part[kNT][4];
      // a bf16 operand's low part is zero, and so its product: it is skipped
      if constexpr (sizeof(TY) == 4) {
#pragma unroll
        for (int jj = 0; jj < kNT; ++jj) mma_tf32_first(part[jj], alo, bhi[jj]);
        if constexpr (sizeof(TX) == 4) {
#pragma unroll
          for (int jj = 0; jj < kNT; ++jj) mma_tf32(part[jj], ahi, blo[jj]);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < kNT; ++jj) mma_tf32_first(part[jj], ahi, blo[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < kNT; ++jj) mma_tf32(part[jj], ahi, bhi[jj]);
#pragma unroll
      for (int jj = 0; jj < kNT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][jj][e] += part[jj][e];
    }
  }
}

// kHist: which operand is a bf16 history (0 none, 1 x, 2 y); its staged
// tile holds bf16 elements in the fp32 layout's room.
template <bool kRagged, int kHist = 0>
__global__ void __launch_bounds__(kThreads, 1) lista3d_wgrad_mma(const Args w) {
  using TX = std::conditional_t<kHist == 1, __nv_bfloat16, float>;
  using TY = std::conditional_t<kHist == 2, __nv_bfloat16, float>;
  constexpr int kYST = kHist == 2 ? kYSb : kYS;
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t bar[2];  // the two buffers
  float* smem = reinterpret_cast<float*>(smem4);
  const MmaArgs& xa = w.x;
  const Tile tlx = tile_of<TX>(xa, 1);
  Tile tly = tile_of<TY>(w.y, 1);
  tly.slab = kYST;
  const int xfl = x_floats(xa), buf = buf_floats(xa);
  const int T = xa.Qd * xa.Qh * xa.Qw, O = w.y.I;
  const int* slots = w.table + xa.I * T;
  const int* rbs = slots + w.R;
  const int s_b = rbs[blockIdx.x], s_e = rbs[blockIdx.x + 1];
  const int o0 = blockIdx.y * kBO;
  const int split = blockIdx.z;
  const int c_lo = slots[s_b] / T;  // the block's first input channel

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the warps: rw along the block's n8 row tiles (dealt round-robin, kNT
  // each) x 12 / rw along its 12 m16 code tiles (mw each): 4 x 3 (4 m16
  // tiles a warp) for more than 8 row tiles, else 2 x 6 (2 m16 tiles a
  // warp), so that every warp holds kNT row tiles whose product chains
  // interleave; a row tile past the block's rows has zero B fragments
  const int tiles = (s_e - s_b + 7) / 8;
  const int rw = tiles > 8 ? 4 : 2, cw = kWarps / rw, mw = kBO / 16 / cw;
  const int wc = warp % cw, wr = warp / cw;

  // this lane's B columns: tile jj's phase row (its staged tap row's index
  // in RowStager's order and the tap column), or none past the block's rows
  int xline[kNT], xcol[kNT];
  bool xok[kNT];
#pragma unroll
  for (int jj = 0; jj < kNT; ++jj) {
    const int slot = s_b + (wr + rw * jj) * 8 + g;
    xok[jj] = slot < s_e;
    const int row = xok[jj] ? slots[slot] : slots[s_b];
    const int i = row / T, q = row % T;
    xline[jj] = (i - c_lo) * (xa.Qd * xa.Qh) + q / xa.Qw;  // (ci, qd, qh)
    xcol[jj] = q % xa.Qw;
  }
  const int per_ch = xa.Qd * xa.Qh;

  const int tiles_w = (xa.W + kTW - 1) / kTW;
  const int st0 = split * w.chunk, st1 = min(w.stages, st0 + w.chunk);
  // stage sidx: sample n, depth d, code row h, columns from w0
  auto at = [&](int sidx, int& n, int& d, int& h, int& w0) {
    w0 = sidx % tiles_w * kTW;
    const int r = sidx / tiles_w;
    h = r % xa.H, d = r / xa.H % xa.D, n = r / xa.H / xa.D;
  };
  auto stage = [&](int sidx, int b) {
    int n, d, h, w0;
    at(sidx, n, d, h, w0);
    float* bx = smem + b * buf;
    const RowStager<kThreads, kXCH, TX> rx(xa, tlx, n, d, h, w0);
    const RowStager<kThreads, kBO, TY> ry(w.y, tly, n, d, h, w0);
    if (kRagged) {
      rx.stage(reinterpret_cast<TX*>(bx), c_lo, &bar[b]);
      ry.stage(reinterpret_cast<TY*>(bx + xfl), o0, &bar[b]);
    } else {
      rx.stage_aligned(reinterpret_cast<TX*>(bx), c_lo, &bar[b]);
      ry.stage_aligned(reinterpret_cast<TY*>(bx + xfl), o0, &bar[b]);
    }
    mbar_arrive(&bar[b]);
  };

  if (tid == 0) mbar_init(&bar[0], kThreads), mbar_init(&bar[1], kThreads);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();  // the barriers are initialized

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int jj = 0; jj < kNT; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][jj][e] = 0.f;

  // aligned rows (W a multiple of the 16-byte grid, x and y on it): every
  // staged x row sits (w0 + ow) % kGrid = ow % kGrid elements in, every y
  // row at 0
  const unsigned shx0 = (unsigned)xa.ow & (unsigned)(kGrid<TX> - 1);
  fence_proxy_async();
  if (st0 < st1) stage(st0, 0);
  for (int j = 0, sidx = st0; sidx < st1; ++j, ++sidx) {
    const int b = j & 1;
    mbar_wait(&bar[b], (j >> 1) & 1);
    int n, d, h, w0;
    at(sidx, n, d, h, w0);
    const RowStager<kThreads, kXCH, TX> rx(xa, tlx, n, d, h, w0);
    const RowStager<kThreads, kBO, TY> ry(w.y, tly, n, d, h, w0);
    const float* bxf = smem + b * buf;
    const TX* bx = reinterpret_cast<const TX*>(bxf);
    const TY* by = reinterpret_cast<const TY*>(bxf + xfl);
    if (kRagged)
      rx.fix(reinterpret_cast<TX*>(smem + b * buf), c_lo),
          ry.fix(reinterpret_cast<TY*>(smem + b * buf + xfl), o0);
    // the stage has landed for every thread, and every warp is done with
    // buffer b ^ 1, which the next stage's copies fill
    __syncthreads();
    if (sidx + 1 < st1) {
      fence_proxy_async();
      stage(sidx + 1, b ^ 1);
    }
    // this lane's B column starts, and its A rows' (codes g and g + 8 of
    // each m16 tile) offsets from the grid
    const TX* xb[kNT];
#pragma unroll
    for (int jj = 0; jj < kNT; ++jj) {
      const int ci = xline[jj] / per_ch, qq = xline[jj] % per_ch;
      const unsigned sh = kRagged ? rx.sh(rx.sh0(c_lo, ci), qq / xa.Qh, qq % xa.Qh) : shx0;
      xb[jj] = bx + ci * tlx.slab + qq * tlx.pitch + xcol[jj] + sh + t;
    }
    const TY* ya[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ol = min(16 * (mw * wc + mt) + 8 * hf + g, kBO - 1);  // past mw: unread
        ya[mt][hf] = by + ol * kYST + (kRagged ? ry.sh(ry.sh0(o0, ol), 0, 0) : 0u) + t;
      }
    if (mw == 4)
      stage_products<4>(acc, xb, xok, ya);
    else
      stage_products<2>(acc, xb, xok, ya);
  }

  // the block's partial sums: (code g or g + 8, row slot 2t or 2t + 1) of
  // each tile, into part[split][slot][code]
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int jj = 0; jj < kNT; ++jj) {
      if (mt >= mw) continue;
      const int o = o0 + 16 * (mw * wc + mt) + g;
      const int slot = s_b + (wr + rw * jj) * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int oe = o + (e >> 1) * 8, se = slot + (e & 1);
        if (oe < O && se < s_e) w.part[((size_t)split * w.R + se) * O + oe] = acc[mt][jj][e];
      }
    }
}

// dw[row, o] = alpha * the splits' sums of the row's slot, in ascending
// order; 0 for a row with no slot
__global__ void fold_rows(const float* part, const int* slot_of, float* dw, int rows, int O,
                          int R, int splits, float alpha) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)rows * O) return;
  const int slot = slot_of[e / O], o = (int)(e % O);
  float s = 0.f;
  if (slot >= 0)
    for (int b = 0; b < splits; ++b) s += part[((size_t)b * R + slot) * O + o];
  dw[e] = alpha * s;
}

// The launch: (row blocks, code blocks, splits). The splits: the most
// (at most the code rows of the grid) that keep every block resident at
// once, one an SM; their code rows in contiguous chunks.
struct Launch {
  dim3 grid;
  int chunk, stages;
};

inline int launch_of(int RB, int O, int N, int D, int H, int W, Launch& l) {
  if (RB <= 0 || O <= 0 || N <= 0 || D <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long stages = (long long)N * D * H * ((W + kTW - 1) / kTW);
  const int o_blocks = (O + kBO - 1) / kBO;
  if (stages >= (1LL << 31) || o_blocks > 65535) return (int)cudaErrorInvalidConfiguration;
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)RB * o_blocks;
  const long long splits = std::max(1LL, std::min(stages, sms / tiles));
  l.stages = (int)stages;
  l.chunk = (int)((stages + splits - 1) / splits);
  l.grid = dim3((unsigned)RB, (unsigned)o_blocks, (unsigned)((stages + l.chunk - 1) / l.chunk));
  return l.grid.z > 65535 ? (int)cudaErrorInvalidConfiguration : 0;
}

// The tensor-core kernel's launch with kHist.
template <int kHist>
inline int launch_mma(const Args& w, const dim3& grid, int smem, bool ragged,
                      cudaStream_t stream) {
  const void* kern = ragged ? reinterpret_cast<const void*>(lista3d_wgrad_mma<true, kHist>)
                            : reinterpret_cast<const void*>(lista3d_wgrad_mma<false, kHist>);
  static int limit[2][64] = {};
  const cudaError_t err = raise_smem_limit(kern, smem, limit[ragged]);
  if (err != cudaSuccess) return (int)err;
  if (ragged)
    lista3d_wgrad_mma<true, kHist><<<grid, kThreads, smem, stream>>>(w);
  else
    lista3d_wgrad_mma<false, kHist><<<grid, kThreads, smem, stream>>>(w);
  return (int)cudaGetLastError();
}

// The weight gradient of x and y on the table's rows: the tensor-core
// kernel, then fold_rows. hist: 0, or 1 (2) where x (y) is a bf16 history.
inline int launch(const MmaArgs& x, const MmaArgs& y, const int* table, float* work, float* dw,
                  int R, int RB, float alpha, int hist, cudaStream_t stream) {
  const int O = y.I;
  if (x.I <= 0 || x.Qd <= 0 || x.Qh <= 0 || x.Qw <= 0 || R <= 0 || x.Qw > 255 || hist < 0 ||
      hist > 2)
    return (int)cudaErrorInvalidValue;
  if ((long long)x.N * std::max(x.I, O) * x.D * x.H * x.W >= (1LL << 31) ||
      (long long)x.I * x.Qd * x.Qh * x.Qw * O >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Launch l;
  const int q = launch_of(RB, O, x.N, x.D, x.H, x.W, l);
  if (q != 0) return q;
  const Args w{x, y, table, work, R, l.chunk, l.stages};
  const int smem = (int)sizeof(float) * 2 * buf_floats(x);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  // rows on the 16-byte grid: a width of whole 16-byte units (8 bf16
  // values where an operand is a history) and both operands on the grid
  const auto off_grid = [](const void* p, bool bf16) {
    return bf16 ? mis<__nv_bfloat16>(p) != 0 : mis4(p) != 0;
  };
  const bool ragged =
      x.W % (hist ? 8 : 4) != 0 || off_grid(x.in, hist == 1) || off_grid(y.in, hist == 2);
  const int err = hist == 0   ? launch_mma<0>(w, l.grid, smem, ragged, stream)
                  : hist == 1 ? launch_mma<1>(w, l.grid, smem, ragged, stream)
                              : launch_mma<2>(w, l.grid, smem, ragged, stream);
  if (err != 0) return err;
  const int rows = x.I * x.Qd * x.Qh * x.Qw;
  const long long total = (long long)rows * O;
  fold_rows<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(work, table, dw, rows, O, R,
                                                                 (int)l.grid.z, alpha);
  return (int)cudaGetLastError();
}

}  // namespace wgrad

extern "C" {

// The launch of lista3d_wgrad for RB row blocks: out[0..2] its grid (row
// blocks, code blocks, splits); its work buffer holds splits * R * O floats.
// Returns 0, or the CUDA error met.
int lista3d_wgrad_grid(int RB, int O, int N, int D, int H, int W, int* out) {
  wgrad::Launch l;
  const int err = wgrad::launch_of(RB, O, N, D, H, W, l);
  if (err != 0) return err;
  out[0] = (int)l.grid.x, out[1] = (int)l.grid.y, out[2] = (int)l.grid.z;
  return 0;
}

// dw[i, q, o] = alpha * sum_{n,p} x[n, i, p + q + off] y[n, o, p] on the R
// phase rows (i, q) of `table` (device int32: each of the I * T rows' slot,
// or -1 for a row written as zeros; the R slots' rows in ascending order;
// the first slot of each of RB row blocks, then R: a block holds at most
// 128 rows of at most 8 consecutive input channels). x (N, I, D, H, W); y
// (N, O, D, H, W); hist: 0 (both fp32), 1 (x in bf16) or 2 (y in bf16);
// work (splits, R, O); dw (I, Qd, Qh, Qw, O); off = (od, oh, ow).
int lista3d_wgrad(const void* x, const void* y, const int* table, float* work, float* dw,
                  int N, int I, int O, int D, int H, int W, int Qd, int Qh, int Qw, int od,
                  int oh, int ow, int R, int RB, int hist, float alpha, void* stream) {
  tf32x3::MmaArgs xa{}, ya{};
  xa.in = static_cast<const float*>(x), xa.N = N, xa.I = I, xa.D = D, xa.H = H, xa.W = W;
  xa.Qd = Qd, xa.Qh = Qh, xa.Qw = Qw, xa.od = od, xa.oh = oh, xa.ow = ow;
  ya.in = static_cast<const float*>(y), ya.N = N, ya.I = O, ya.D = D, ya.H = H, ya.W = W;
  ya.Qd = ya.Qh = ya.Qw = 1;
  return wgrad::launch(xa, ya, table, work, dw, R, RB, alpha, hist, (cudaStream_t)stream);
}

}  // extern "C"
