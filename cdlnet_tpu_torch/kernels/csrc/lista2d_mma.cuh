// The 2D forward pair on the tensor cores of Hopper (sm_90a): the stride-1
// phase-domain 2D correlation
//
//   out[n,o,h,w] = sum_{i,b,c} wt[i,b,c,o] * in[n,i,h+b+oh,w+c+ow]
//
// (zero outside the image), as an implicit GEMM on mma.sync.m16n8k8 TF32
// products, with seven fused epilogues:
//
//   lista2d_ana_mma<kAnaSt> (analysis): out = ST(z - u, tau[n, o]); z ==
//       NULL reads as zeros, and out may be z (each output element is read
//       and then written by one thread).
//   lista2d_ana_mma<kAnaAdjoint> (the 2D reverse pass's synthesis adjoint,
//       with mma_tf32.cuh's AdjointArgs): dz = [base +] alpha * u, out = dv
//       = 1{z != 0} dz, and per block (a row of 64 positions) and code the
//       dtau partial -sum sign(z) dz in order (sum_parts then sums the
//       blocks in a fixed order).
//   lista2d_ana_mma<kAnaCsr>, <kAnaCsrF2> (the CSR models' analyses, with
//       CsrArgs): v = z - u, out = prox_csr(v, zp; tau, gam1) or
//       prox_csr_f2(v, zp, za; tau, gam1, gam2) (csr_prox.cuh), v to u_out
//       where it is not NULL (the u history the CSR adjoints read). The
//       prox is elementwise, so the CSR modes cost the ST analysis's
//       products and one (csr) or two (csrf2) more code reads, and a code
//       write with u_out. zp and za may even be out: as z, each element is
//       read and then written by one thread.
//   lista2d_ana_mma<kAnaAdjointCsr>, <kAnaAdjointCsrF2> (the CSR models'
//       synthesis adjoints, with AdjointArgs and CsrArgs): dz = [base +]
//       alpha * u, then the adjoint of z = prox_csr(v, zp) or prox_csr_f2(v,
//       zp, za) (csr_prox.cuh) at the stored prox argument v (CsrArgs::u)
//       and code z: out = dv, dzp (and dza) += the neighbour codes'
//       cotangents in place, and per block and code the partials of dtau,
//       dgam1 (and dgam2), which sum_parts sums over the blocks. They cost
//       the ST adjoint's products and 4 (csr) or 7 (csrf2) more code reads
//       and writes. The prox adjoint's masks come from the stored v and z,
//       not from the sums: the sums' rounding moves no code across a
//       branch of the prox.
//   lista2d_syn_mma (synthesis): out = [mask *] u [- y].
//
// The bf16 training histories (kBf16; lista3d_mma.cuh says how): the ST
// analysis and the synthesis also store their output's bf16 copy into
// `hist`, the ST adjoint reads bf16 codes z; the CSR analyses store the
// codes' bf16 copy into `hist` and the prox argument v into a bf16 u_out,
// and the CSR adjoints read bf16 codes z and a bf16 prox argument u. Every
// other operand, the carried codes zp and za too, stays fp32, and the
// epilogues upcast a bf16 value once, where they load it.
//
// The analyses share the mainloop and the code-split launch rule. They
// replace, for lista2d.cu's lista2d_ana_threshold, lista2d_ana_csr,
// lista2d_ana_csrf2, lista2d_syn_residual, lista2d_syn_adjoint and
// lista2d_syn_adjoint_csr(f2), the TPU kernels cdlnet_tpu/kernels/
// lista2d.py::_kernel (K5, the whole-image forward, its prox modes st, csr
// and csrf2) and the banded pair lista2d_tiled.py::_kernel_syn_band /
// _kernel_ana_band (K7, with the same modes), and with the adjoint
// epilogues the dz part of the 2D reverses lista2d.py::_kernel_bwd (K6, its
// prox modes st, csr and csrf2) and lista2d_tiled_bwd.py::_kernel_tiled_bwd
// (K8); the synthesis is also the 2D reverse pass's analysis adjoint (K6,
// K8) and the CSR models' synthesis. The fp32 contract is the 3D pair's
// (lista3d_mma.cuh): each operand split into two TF32 parts, three products
// a term, here by the round-to-nearest split of mma_tf32.cuh (split_rn: the
// truncating one biased the sums toward zero enough to flip the CSR demo's
// codes across its prox's jumps, 2.3e-4 rel L2 against the 1e-4 gate); and
// each tap pair's three products go into a fresh fragment added to the sums
// in fp32. Each output is a fixed sequence of products and fixed-order
// sums: two runs are bitwise equal, and the analyses' epilogues see the
// same sums (with zero neighbour codes and gamma banks a CSR analysis writes
// the ST analysis's codes bit for bit, and a CSR adjoint the ST adjoint's
// dv and dtau).
//
// What bounds them on this card. At the flagship 2D width (M = 169 codes,
// Cp = 4 phases, 4x4 phase taps) a 128^2 image has a 64x64 code grid: one
// call is ~68 MFLOP of nonzero-tap FMAs (0.0004 ms as three TF32 products at
// 495 TFLOP/s) against 5.5 MB of codes read and written by the analysis
// (0.0017 ms at 3.35 TB/s) and 2.8 MB read by the synthesis. What holds a
// small call back is a grid of too few blocks to fill 132 SMs (the 3D
// tiling at D = 1 would launch 32 analysis and 16 synthesis blocks) and
// each block's latency; what holds a big one back, as measured on the
// H100 (PERF.md), is feeding the tensor cores: copies that issue from the
// computing warps and a few warps an SM to hide their latency. Where the
// grid is small the launch splits the other GEMM dimension by one rule per
// kernel, with no knob: the least split whose blocks fill the card.
//
// - Analysis (M = positions, N = codes, K = phases x taps). A block owns a
//   row of 64 positions and BN codes with 4 warps, 2 along positions (two
//   m16 tiles each) x 2 along codes (up to 11 n8 tiles each). BN is a
//   multiple of 16 up to 176: the launch takes the fewest code blocks whose
//   count times the row tiles reaches the SM count (1 x 128^2 at M = 169:
//   6 blocks of 32 codes, 384 blocks; 10 x 128^2, 512^2 and 640x384 keep
//   one of 176). A stage is 4 input channels, and the k8 of a product holds
//   them at two neighbouring column taps (c, c + 1): at Cp = 4 (stride 2,
//   grayscale) no k row is padding, where 8 channels a k8 would be half
//   zeros; at Cp = 3 (JDD) a quarter is, at Cp = 1 three quarters, and an
//   odd tap count pads the last pair's second tap with zeros. The tap box
//   of the 2D phase map (channel i is phase i % s^2, ordered (c, a_h, a_w))
//   bounds each stage's taps; at s = 2 a stage of 4 channels holds all four
//   phases, so no tap is skipped and the 23% of the products that meet
//   structural zeros at P = 7 run. The input rows stage once a stage by
//   bulk copies (mma_tf32.cuh's RowStager), the weights one tap row at a
//   time through two buffers; the epilogue goes through shared memory so
//   that z_old is read and z written in coalesced rows of 16-byte accesses.
// - Synthesis (M = positions, N = Cp outputs, K = codes x taps). At Cp = 4
//   an n8 tile of one tap's outputs would be half padding, so a product
//   takes a tap pair: the taps (r0, c) and (r0 + 1, c) of one column share
//   its A fragment (A-row ya + r0), and its 8 columns are the 4 outputs of
//   each; tap r0 + 1's land one output row up. A block owns TH output rows
//   of 64 positions (7, or 3 where 7-row tiles cannot fill the card) and 4
//   outputs, read through TH + 1 A-rows: 8 warps, each an A-row's 4 m16
//   tiles and a group of the tap pairs (TH = 3: 2 groups; TH = 7: all).
//   It loops over its codes in stages of 8 (the k8 of a product) through a
//   ring of 3 buffers, each filled on its own mbarrier. A stage comes by one
//   TMA tensor copy (a 4D box of z seen as (W, H, M, N), zeros outside the
//   image and past code M) where z's rows are 16-byte strides and z sits on
//   the 16-byte grid, else (ragged widths, history slices off the grid) by
//   RowStager's bulk copies, one a staged row, as the analysis stages.
//   The reduction is long (169 x 16 = 2704) against 4 outputs, so where
//   the grid is small the launch splits the codes over the S blocks of a
//   thread block cluster, S a power of two up to 8 (the portable maximum),
//   the one with the least modelled time: waves at two blocks an SM times
//   a block's stages plus two (1 x 128^2: 3 rows, S = 8, 176 blocks;
//   10 x 128^2: 7 rows, S = 2; 512^2 and 640x384: S = 4). Each block sums
//   its warps' fragments in a fixed order into its shared memory; after a
//   cluster barrier each block sums the S blocks' partials of its share of
//   the outputs in rank order through distributed shared memory, runs the
//   epilogue and stores; a second barrier keeps every block's partials
//   until they have been read. No atomics, no memset, no second launch.
//
// Every shape the wrappers take: any Cp (1, 3, 4, 12) and M, any tap box
// (4x4, 5x5, 7x7), ragged widths, N > 1 with tau per (n, m), and tensors
// off the 16-byte grid (history slices): each staged row keeps its own
// offset, and the epilogues fall back to scalar accesses.
//
// Repeatability. Two calls at one shape are bitwise equal. The analysis's
// sums do not depend on its split either. The synthesis's do: its rows a
// block (which set how the tap pairs are grouped over warps) and its
// cluster size (which stages each partial holds) follow N, H and W, so one
// image's r, and what is computed from it, can differ in the last bits
// between a batch of one and a batch of several (denoise_image against
// denoise_image_batch, or training batches of other sizes), within the
// fp32 gates.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "csr_prox.cuh"
#include "mma_tf32.cuh"

namespace mma2d {

namespace cg = cooperative_groups;
using namespace tf32x3;

// analysis: 4 warps (2 along positions x 2 along codes), one row of 64
// positions, up to 176 codes; 4 input channels a stage
constexpr int kAnaThreads = 128, kAnaNT = 11, kAnaMaxBN = 2 * 8 * kAnaNT, kAnaCH = 4;
constexpr int kAnaEP = kTW + 4;  // epilogue row pitch: 4 mod 16 floats
constexpr int kAnaBlocksPerSM = 4;  // resident blocks an SM, by the launch bounds
// synthesis: 8 warps (groups of taps) over one row of 64 positions (4 m16
// tiles a warp) and 8 outputs; 8 codes a stage, 4 pipeline buffers; up to
// 8 blocks a cluster
constexpr int kSynThreads = 256, kSynMT = kTW / 16, kSynNB = 3, kMaxSplit = 8;
constexpr int kSynBlocksPerSM = 2;  // resident blocks an SM, by the launch bounds
constexpr int kSynRP = kTW + 4;     // a row's pitch in the sums

// ---------------------------------------------------------------- analysis

// A fragment of one m16 tile at a pair of column taps (c, c + 1): rows
// (positions) g and g + 8; column t is channel t at tap c, column t + 4
// channel t at tap c + 1, one staged column on (zeros where the pair has
// one tap). p points at (channel t, position g) at tap c.
__device__ inline void load_a_pair(const float* p, bool two, uint32_t* hi, uint32_t* lo) {
  split_rn(p[0], hi[0], lo[0]);
  split_rn(p[8], hi[1], lo[1]);
  if (two) {
    split_rn(p[1], hi[2], lo[2]);
    split_rn(p[9], hi[3], lo[3]);
  } else {
    hi[2] = lo[2] = hi[3] = lo[3] = 0u;
  }
}

// the 2 x NT tiles of a warp at one tap pair: lo*hi, hi*lo, hi*hi into a
// fresh fragment per tile, added to its sums in fp32; w_c, w_c1 point at
// code nb + g of channel t at taps c and c + 1 (w_c1 unread where the pair
// has one tap: its B rows are zeros); NT n8 tiles (all 11 where the warp's
// codes are all real), else the first nt
template <int NT>
__device__ inline void ana_products(float (&acc)[2][kAnaNT][4], const uint32_t (&ahi)[2][4],
                                    const uint32_t (&alo)[2][4], const float* w_c,
                                    const float* w_c1, bool two, int nt) {
#pragma unroll
  for (int jj = 0; jj < (NT > 0 ? NT : kAnaNT); ++jj) {
    if (NT > 0 || jj < nt) {
      uint32_t bhi[2], blo[2];
      split_rn(w_c[jj * 8], bhi[0], blo[0]);
      if (two)
        split_rn(w_c1[jj * 8], bhi[1], blo[1]);
      else
        bhi[1] = blo[1] = 0u;
      float tap[2][4] = {};
      mma_tf32(tap[0], alo[0], bhi);
      mma_tf32(tap[1], alo[1], bhi);
      mma_tf32(tap[0], ahi[0], blo);
      mma_tf32(tap[1], ahi[1], blo);
      mma_tf32(tap[0], ahi[0], bhi);
      mma_tf32(tap[1], ahi[1], bhi);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][jj][e] += tap[0][e], acc[1][jj][e] += tap[1][e];
    }
  }
}

// component q of a float4 (q a constant once the loops that index by it are
// unrolled, so the float4 stays in registers)
__device__ inline float& elem4(float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// a (channel, tap)'s BN codes in a weight buffer start up to 3 floats in
// (their global offset from the 16-byte grid): BN + 8 floats a tap
__host__ __device__ inline int ana_wstride(int Qw, int BN) { return stride8(Qw * (BN + 8)); }

__host__ inline int ana_smem_floats(const MmaArgs& a, int BN) {
  const Tile tl(a, 1);
  const int main = kAnaCH * tl.slab + 2 * kAnaCH * ana_wstride(a.Qw, BN);
  const int epi = BN * kAnaEP;
  return main > epi ? main : epi;
}

// The analysis's epilogues: the forward's soft threshold, the reverse pass's
// synthesis adjoint (mma_tf32.cuh's AdjointArgs), the CSR proxes (CsrArgs),
// the CSR synthesis adjoints (both).
enum AnaEpilogue : int {
  kAnaSt = 0,
  kAnaAdjoint = 1,
  kAnaCsr = 2,
  kAnaCsrF2 = 3,
  kAnaAdjointCsr = 4,
  kAnaAdjointCsrF2 = 5
};

// The CSR epilogues' operands: the gamma banks (N, O) (gam2: two-sided
// only) and the neighbour codes (N, O, H, W) (za: two-sided only); the
// analyses' u_out (N, O, H, W), which takes the prox argument, or NULL; the
// adjoints' stored prox argument u and the neighbour codes' cotangents dzp
// (dza: two-sided only) (N, O, H, W), added into in place. The adjoints'
// fields come last, so that the other epilogues' parameters keep their
// offsets. In a kBf16 instantiation u_out and u point at bf16 values (the
// kernel reads them through a cast), so that the fp32 instantiations keep
// this layout and their code.
struct CsrArgs {
  const float* gam1;
  const float* gam2;
  const float* zp;
  const float* za;
  float* u_out;
  const float* u;
  float* dzp;
  float* dza;
};

// The analysis with epilogue kEpi (an AnaEpilogue); e is read by the
// adjoints alone, c by the CSR epilogues alone; kBf16 (kAnaSt: the codes'
// bf16 copy into hist; kAnaAdjoint: bf16 codes a.z; kAnaCsr, kAnaCsrF2: the
// codes' bf16 copy into hist and a bf16 u_out; kAnaAdjointCsr,
// kAnaAdjointCsrF2: bf16 codes a.z and prox argument c.u).
template <int kEpi, bool kBf16 = false>
__global__ void __launch_bounds__(kAnaThreads, kAnaBlocksPerSM)
lista2d_ana_mma(const MmaArgs a, int BN, bool vec, const AdjointArgs e, const CsrArgs c,
                __nv_bfloat16* hist) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t bar[2];  // the two weight buffers
  float* smem = reinterpret_cast<float*>(smem4);
  const Tile tl(a, 1);
  const int T = a.Qh * a.Qw;
  const int cs = BN + 8;
  const int wstride = ana_wstride(a.Qw, BN);
  float* s_in = smem;
  float* s_w = smem + kAnaCH * tl.slab;  // two buffers of kAnaCH x wstride

  const int tiles_w = (a.W + kTW - 1) / kTW;
  const int w0 = (blockIdx.x % tiles_w) * kTW, h0 = blockIdx.x / tiles_w;
  const int o0 = blockIdx.y * BN, n = blockIdx.z;
  const int n_o = min(BN, a.O - o0);  // codes of this block

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 2, wn = warp / 2;  // 2 x 2 warps
  const int nb = wn * (BN / 2);            // the warp's first code in the block
  // the warp's n8 tiles that hold a real code (warp-uniform)
  const int nt = max(0, min(BN / 16, (n_o - nb + 7) / 8));
  const RowStager<kAnaThreads, kAnaCH> rows(a, tl, n, 0, h0, w0);
  const bool ragged = (a.W & 3) != 0 || mis4(a.in) != 0;  // rows off the grid
  if (tid == 0) mbar_init(&bar[0], kAnaThreads), mbar_init(&bar[1], kAnaThreads);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  int phases = 0;  // bit b: the parity bar[b] completes next

  float acc[2][kAnaNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kAnaNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // (channel i, tap) -> its first code's offset in the bank, and that
  // offset's distance from the 16-byte grid (unsigned: mod 4 survives the
  // wrap)
  auto w_start = [&](int i, int tap) { return ((size_t)i * T + tap) * a.O + o0; };
  auto w_sh = [&](int i, int tap) {
    return (mis4(a.wt) + ((unsigned)i * T + tap) * a.O + o0) & 3u;
  };
  // the weights of tap row q for channels [c0, c0 + 4) into buffer b: a
  // thread a (channel, tap), its codes by copy_span `w_sh` floats into a
  // slot of BN + 8; zeros past channel I; codes past O reach only unstored
  // columns
  const size_t w_total = (size_t)a.I * T * a.O;
  auto stage_w = [&](int c0, int q, int b) {
    float* dst = s_w + b * kAnaCH * wstride;
    for (int k = tid; k < kAnaCH * a.Qw; k += kAnaThreads) {
      const int i = c0 + k / a.Qw, c = k % a.Qw, tap = q * a.Qw + c;
      float* slot = dst + (k / a.Qw) * wstride + c * cs;
      if (i >= a.I)
        zero(slot, cs);
      else  // widened to the grid within the slot
        copy_span(slot + w_sh(i, tap), a.wt + w_start(i, tap), n_o, &bar[b],
                  w_start(i, tap) + n_o + 3 <= w_total);
    }
  };

  for (int c0 = 0; c0 < a.I; c0 += kAnaCH) {
    // the taps where some channel of the stage has a nonzero weight: the
    // union of their tap boxes under the 2D phase map
    int qh0 = 0, qh1 = a.Qh, qw0 = 0, qw1 = a.Qw;
    if (a.s > 0) {
      qh0 = a.Qh, qh1 = 0, qw0 = a.Qw, qw1 = 0;
      for (int i = c0; i < min(c0 + kAnaCH, a.I); ++i) {
        const int ph = i % (a.s * a.s);
        int lo, hi;
        tap_box(a.s, ph / a.s, a.P[1], a.pad[1], a.oh, a.Qh, lo, hi);
        qh0 = min(qh0, lo), qh1 = max(qh1, hi);
        tap_box(a.s, ph % a.s, a.P[2], a.pad[2], a.ow, a.Qw, lo, hi);
        qw0 = min(qw0, lo), qw1 = max(qw1, hi);
      }
    }
    const int n_rows = qh1 > qh0 && qw1 > qw0 ? qh1 - qh0 : 0;
    if (n_rows == 0) continue;

    // the previous stage's products are done with s_in and both buffers
    __syncthreads();
    fence_proxy_async();
    // the input rows and tap row qh0's weights, on buffer 0's barrier
    rows.stage(s_in, c0, &bar[0]);
    stage_w(c0, qh0, 0);
    mbar_arrive(&bar[0]);
    // the offset of this lane's channel's staged rows from the grid
    const unsigned sh_t = rows.sh0(c0, t);
    for (int j = 0; j < n_rows; ++j) {
      const int b = j & 1;
      mbar_wait(&bar[b], (phases >> b) & 1);
      phases ^= 1 << b;
      if (j == 0 && ragged) rows.fix(s_in, c0);
      // tap row j's weights (and the rows) have landed, and every warp is
      // done with buffer b ^ 1, which row j + 1's copies overwrite
      __syncthreads();
      if (j + 1 < n_rows) {
        fence_proxy_async();
        stage_w(c0, qh0 + j + 1, b ^ 1);
        mbar_arrive(&bar[b ^ 1]);
      }
      const int q = qh0 + j;  // the tap row, and the staged row it reads
      const float* x_t = s_in + t * tl.slab + q * tl.pitch + wm * 32 + g + rows.sh(sh_t, 0, q);
      const float* wr = s_w + b * kAnaCH * wstride + t * wstride + nb + g;
      for (int c = qw0; c < qw1; c += 2) {
        const bool two = c + 1 < qw1;
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) load_a_pair(x_t + mt * 16 + c, two, ahi[mt], alo[mt]);
        const int tap = q * a.Qw + c;
        const float* w_c = wr + c * cs + w_sh(c0 + t, tap);
        const float* w_c1 = wr + (c + 1) * cs + w_sh(c0 + t, tap + 1);
        if (nt == kAnaNT)
          ana_products<kAnaNT>(acc, ahi, alo, w_c, w_c1, two, nt);
        else
          ana_products<0>(acc, ahi, alo, w_c, w_c1, two, nt);
      }
    }
  }
  __syncthreads();  // every warp is done with the staged rows and weights

  // the accumulators -> shared memory (code, position), then the epilogue
  // in coalesced rows
  float* e_s = smem;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int jj = 0; jj < kAnaNT; ++jj) {
      if (jj < nt) {
        const int on = nb + jj * 8 + 2 * t;
        const int p = wm * 32 + mt * 16 + g;
        e_s[on * kAnaEP + p] = acc[mt][jj][0];
        e_s[(on + 1) * kAnaEP + p] = acc[mt][jj][1];
        e_s[on * kAnaEP + p + 8] = acc[mt][jj][2];
        e_s[(on + 1) * kAnaEP + p + 8] = acc[mt][jj][3];
      }
    }
  __syncthreads();
  if constexpr (kEpi == kAnaSt) {
    // groups of 4 positions along the row (W % 4 == 0 and 16-byte aligned
    // tensors, else 1), kB groups a thread per round: all their z_old loads
    // before any store (out may be z_old, so the compiler cannot move a load
    // above a store)
    constexpr int kB = 4;
    const int gw = vec ? 4 : 1;  // positions a group
    const size_t plane = (size_t)a.H * a.W;
    const int groups = n_o * (kTW / gw);
    for (int e0 = 0; e0 < groups; e0 += kB * kAnaThreads) {
      size_t idx[kB];
      float4 v[kB];
      float tau[kB];
  #pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int e = e0 + k * kAnaThreads + tid;
        const int on = e / (kTW / gw), p = e % (kTW / gw) * gw;
        const int ww = w0 + p;
        const bool ok = e < groups && ww < a.W;
        idx[k] = ok ? ((size_t)n * a.O + o0 + on) * plane + (size_t)h0 * a.W + ww : ~(size_t)0;
        tau[k] = ok ? a.tau[n * a.O + o0 + on] : 0.f;
        v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!ok) continue;
        const float* u = e_s + on * kAnaEP + p;
        if (vec) {
          const float4 u4 = *reinterpret_cast<const float4*>(u);
          if (a.z) v[k] = *reinterpret_cast<const float4*>(a.z + idx[k]);
          v[k].x -= u4.x, v[k].y -= u4.y, v[k].z -= u4.z, v[k].w -= u4.w;
        } else {
          v[k].x = (a.z ? a.z[idx[k]] : 0.f) - u[0];
        }
      }
  #pragma unroll
      for (int k = 0; k < kB; ++k) {
        if (idx[k] == ~(size_t)0) continue;
        const float4 st = make_float4(soft(v[k].x, tau[k]), soft(v[k].y, tau[k]),
                                      soft(v[k].z, tau[k]), soft(v[k].w, tau[k]));
        if (vec) {
          *reinterpret_cast<float4*>(a.out + idx[k]) = st;
          if constexpr (kBf16) store_bf16x4(hist + idx[k], st);
        } else {
          a.out[idx[k]] = st.x;
          if constexpr (kBf16) hist[idx[k]] = __float2bfloat16_rn(st.x);
        }
      }
    }
  } else if constexpr (kEpi == kAnaAdjoint) {
    // dz = [base +] alpha * u; dv = 1{z != 0} dz; each element's dtau term
    // -sign(z) dz into e_s in place of its u (each element is one
    // thread's), zeros past the image's width; loads first, as above
    constexpr int kB = 4;
    const int gw = vec ? 4 : 1;  // positions a group
    const size_t plane = (size_t)a.H * a.W;
    const int groups = n_o * (kTW / gw);
    for (int e0 = 0; e0 < groups; e0 += kB * kAnaThreads) {
      size_t idx[kB];
      float4 bz[kB], zz[kB];
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int el = e0 + k * kAnaThreads + tid;
        const int on = el / (kTW / gw), p = el % (kTW / gw) * gw;
        const int ww = w0 + p;
        const bool ok = el < groups && ww < a.W;
        idx[k] = ok ? ((size_t)n * a.O + o0 + on) * plane + (size_t)h0 * a.W + ww : ~(size_t)0;
        bz[k] = zz[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!ok) {
          if (el < groups)
            for (int q = 0; q < gw; ++q) e_s[on * kAnaEP + p + q] = 0.f;
          continue;
        }
        const __nv_bfloat16* zb = reinterpret_cast<const __nv_bfloat16*>(a.z);
        if (vec) {
          if (e.base) bz[k] = *reinterpret_cast<const float4*>(e.base + idx[k]);
          if constexpr (kBf16)
            zz[k] = load_bf16x4(zb + idx[k]);
          else
            zz[k] = *reinterpret_cast<const float4*>(a.z + idx[k]);
        } else {
          bz[k].x = e.base ? e.base[idx[k]] : 0.f;
          if constexpr (kBf16)
            zz[k].x = __bfloat162float(zb[idx[k]]);
          else
            zz[k].x = a.z[idx[k]];
        }
      }
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        if (idx[k] == ~(size_t)0) continue;
        const int el = e0 + k * kAnaThreads + tid;
        float* u = e_s + el / (kTW / gw) * kAnaEP + el % (kTW / gw) * gw;
        if (vec) {
          const float4 u4 = *reinterpret_cast<const float4*>(u);
          const float4 dz = make_float4(bz[k].x + e.alpha * u4.x, bz[k].y + e.alpha * u4.y,
                                        bz[k].z + e.alpha * u4.z, bz[k].w + e.alpha * u4.w);
          *reinterpret_cast<float4*>(a.out + idx[k]) =
              make_float4(zz[k].x != 0.f ? dz.x : 0.f, zz[k].y != 0.f ? dz.y : 0.f,
                          zz[k].z != 0.f ? dz.z : 0.f, zz[k].w != 0.f ? dz.w : 0.f);
          *reinterpret_cast<float4*>(u) =
              make_float4(dtau_term(zz[k].x, dz.x), dtau_term(zz[k].y, dz.y),
                          dtau_term(zz[k].z, dz.z), dtau_term(zz[k].w, dz.w));
        } else {
          const float dz = bz[k].x + e.alpha * u[0];
          a.out[idx[k]] = zz[k].x != 0.f ? dz : 0.f;
          u[0] = dtau_term(zz[k].x, dz);
        }
      }
    }
    __syncthreads();
    // each code's dtau partial: its terms over the block's row, in order
    for (int on = tid; on < n_o; on += kAnaThreads) {
      const float* r = e_s + on * kAnaEP;
      float s = 0.f;
      for (int p = 0; p < kTW; ++p) s += r[p];
      e.part[((size_t)blockIdx.x * a.N + n) * a.O + o0 + on] = s;
    }
  } else if constexpr (kEpi == kAnaCsr || kEpi == kAnaCsrF2) {
    // v = z_old - u, out = the prox of v, v to u_out: every load of a round
    // before any store, as above, and u_out's store after out's (a store
    // ahead of the loads, which it might alias for all the compiler knows,
    // held them back: a third slower on the H100)
    constexpr bool kF2 = kEpi == kAnaCsrF2;
    constexpr int kB = 4;
    const int gw = vec ? 4 : 1;  // positions a group
    const size_t plane = (size_t)a.H * a.W;
    const int groups = n_o * (kTW / gw);
    for (int e0 = 0; e0 < groups; e0 += kB * kAnaThreads) {
      size_t idx[kB];
      float4 v[kB], zp[kB], za[kB];
      float tau[kB], g1[kB], g2[kB];
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int el = e0 + k * kAnaThreads + tid;
        const int on = el / (kTW / gw), p = el % (kTW / gw) * gw;
        const int ww = w0 + p;
        const bool ok = el < groups && ww < a.W;
        const int no = n * a.O + o0 + on;
        idx[k] = ok ? ((size_t)n * a.O + o0 + on) * plane + (size_t)h0 * a.W + ww : ~(size_t)0;
        tau[k] = ok ? a.tau[no] : 0.f;
        g1[k] = ok ? c.gam1[no] : 0.f;
        g2[k] = ok && kF2 ? c.gam2[no] : 0.f;
        v[k] = zp[k] = za[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!ok) continue;
        const float* u = e_s + on * kAnaEP + p;
        if (vec) {
          const float4 u4 = *reinterpret_cast<const float4*>(u);
          if (a.z) v[k] = *reinterpret_cast<const float4*>(a.z + idx[k]);
          v[k].x -= u4.x, v[k].y -= u4.y, v[k].z -= u4.z, v[k].w -= u4.w;
          zp[k] = *reinterpret_cast<const float4*>(c.zp + idx[k]);
          if (kF2) za[k] = *reinterpret_cast<const float4*>(c.za + idx[k]);
        } else {
          v[k].x = (a.z ? a.z[idx[k]] : 0.f) - u[0];
          zp[k].x = c.zp[idx[k]];
          if (kF2) za[k].x = c.za[idx[k]];
        }
      }
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        if (idx[k] == ~(size_t)0) continue;
        auto prox = [&](float x, float p, float q) {
          return kF2 ? prox_csr_f2(x, p, q, tau[k], g1[k], g2[k]) : prox_csr(x, p, tau[k], g1[k]);
        };
        if constexpr (kBf16) {
          // the fp32 codes, then their rounded copy and v's into the bf16
          // histories (8-byte groups where vec)
          __nv_bfloat16* ub = reinterpret_cast<__nv_bfloat16*>(c.u_out);
          if (vec) {
            const float4 o =
                make_float4(prox(v[k].x, zp[k].x, za[k].x), prox(v[k].y, zp[k].y, za[k].y),
                            prox(v[k].z, zp[k].z, za[k].z), prox(v[k].w, zp[k].w, za[k].w));
            *reinterpret_cast<float4*>(a.out + idx[k]) = o;
            store_bf16x4(hist + idx[k], o);
            if (ub) store_bf16x4(ub + idx[k], v[k]);
          } else {
            const float o = prox(v[k].x, zp[k].x, za[k].x);
            a.out[idx[k]] = o;
            hist[idx[k]] = __float2bfloat16_rn(o);
            if (ub) ub[idx[k]] = __float2bfloat16_rn(v[k].x);
          }
        } else if (vec) {
          *reinterpret_cast<float4*>(a.out + idx[k]) =
              make_float4(prox(v[k].x, zp[k].x, za[k].x), prox(v[k].y, zp[k].y, za[k].y),
                          prox(v[k].z, zp[k].z, za[k].z), prox(v[k].w, zp[k].w, za[k].w));
          if (c.u_out) *reinterpret_cast<float4*>(c.u_out + idx[k]) = v[k];
        } else {
          a.out[idx[k]] = prox(v[k].x, zp[k].x, za[k].x);
          if (c.u_out) c.u_out[idx[k]] = v[k].x;
        }
      }
    }
  } else {
    // The CSR adjoints: dz = [base +] alpha * u, then the prox's adjoint at
    // the stored v (c.u) and z: out = dv, dzp (dza) += the neighbour codes'
    // cotangents. A thread takes groups of 4 positions (16-byte accesses
    // where vec, else 4 scalar ones), so that 16 consecutive lanes hold a
    // code's row: each group's dgam terms are summed in order, then over
    // the 16 lanes by a fixed shuffle tree; the dtau terms go into e_s in
    // place of u and are summed per row in order after the rounds, as the
    // ST adjoint sums them (at zero neighbour codes and gamma banks a CSR
    // adjoint gives its dv and dtau bit for bit). Every load of a round
    // before any store, as above; each element is read, then written, by
    // one thread.
    constexpr bool kF2 = kEpi == kAnaAdjointCsrF2;
    // groups a thread per round: 1, 2 and 4 ran alike on the H100, with
    // the same registers and spills as the ST adjoint (PERF.md)
    constexpr int kB = 2;
    constexpr int kG = kTW / 4;    // groups a row: the lanes that hold it
    const size_t plane = (size_t)a.H * a.W;
    const int groups = n_o * kG;
    const size_t sums = (size_t)gridDim.x * a.N * a.O;  // a sum's partials
    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e0 = 0; e0 < groups; e0 += kB * kAnaThreads) {
      size_t idx[kB];
      int nw[kB];  // the group's positions in the image (0: none, or no group)
      float4 bz[kB], zz[kB], uu[kB], pz[kB], az[kB], dp[kB], da[kB];
      float tau[kB], g1[kB], g2[kB];
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int el = e0 + k * kAnaThreads + tid;
        const int on = el / kG, ww = w0 + el % kG * 4;
        const int no = n * a.O + o0 + on;
        nw[k] = el < groups ? max(0, min(4, a.W - ww)) : 0;
        idx[k] = ((size_t)n * a.O + o0 + on) * plane + (size_t)h0 * a.W + ww;
        tau[k] = nw[k] ? a.tau[no] : 0.f;
        g1[k] = nw[k] ? c.gam1[no] : 0.f;
        g2[k] = nw[k] && kF2 ? c.gam2[no] : 0.f;
        bz[k] = zz[k] = uu[k] = pz[k] = az[k] = dp[k] = da[k] = zero4;
        if (!nw[k]) continue;
        const size_t i = idx[k];
        // kBf16: z and u are bf16 histories, upcast here (exact)
        const __nv_bfloat16* zb = reinterpret_cast<const __nv_bfloat16*>(a.z);
        const __nv_bfloat16* ub = reinterpret_cast<const __nv_bfloat16*>(c.u);
        if (vec) {
          if (e.base) bz[k] = *reinterpret_cast<const float4*>(e.base + i);
          if constexpr (kBf16) {
            zz[k] = load_bf16x4(zb + i);
            uu[k] = load_bf16x4(ub + i);
          } else {
            zz[k] = *reinterpret_cast<const float4*>(a.z + i);
            uu[k] = *reinterpret_cast<const float4*>(c.u + i);
          }
          pz[k] = *reinterpret_cast<const float4*>(c.zp + i);
          dp[k] = *reinterpret_cast<const float4*>(c.dzp + i);
          if (kF2) {
            az[k] = *reinterpret_cast<const float4*>(c.za + i);
            da[k] = *reinterpret_cast<const float4*>(c.dza + i);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q >= nw[k]) continue;
            elem4(bz[k], q) = e.base ? e.base[i + q] : 0.f;
            if constexpr (kBf16) {
              elem4(zz[k], q) = __bfloat162float(zb[i + q]);
              elem4(uu[k], q) = __bfloat162float(ub[i + q]);
            } else {
              elem4(zz[k], q) = a.z[i + q];
              elem4(uu[k], q) = c.u[i + q];
            }
            elem4(pz[k], q) = c.zp[i + q];
            elem4(dp[k], q) = c.dzp[i + q];
            if (kF2) elem4(az[k], q) = c.za[i + q], elem4(da[k], q) = c.dza[i + q];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int el = e0 + k * kAnaThreads + tid;
        float* us = e_s + el / kG * kAnaEP + el % kG * 4;  // the group's sums
        float s1 = 0.f, s2 = 0.f;  // the group's dgam1, dgam2 terms in order
        if (nw[k]) {
          float4 u4 = *reinterpret_cast<const float4*>(us);
          float4 dv = zero4, o1 = zero4, o2 = zero4, dt = zero4;  // dv, dzp, dza, dtau terms
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q >= nw[k]) continue;
            const float dz = elem4(bz[k], q) + e.alpha * elem4(u4, q);
            float dzp, dtau, dg1;
            if constexpr (kF2) {
              float dza, dg2;
              prox_csr_f2_adjoint(dz, elem4(zz[k], q), elem4(uu[k], q), elem4(pz[k], q),
                                  elem4(az[k], q), tau[k], g1[k], g2[k], elem4(dv, q), dzp, dza,
                                  dtau, dg1, dg2);
              elem4(o2, q) = elem4(da[k], q) + dza;
              s2 += dg2;
            } else {
              prox_csr_adjoint(dz, elem4(zz[k], q), elem4(uu[k], q), elem4(pz[k], q), tau[k], g1[k],
                               elem4(dv, q), dzp, dtau, dg1);
            }
            elem4(o1, q) = elem4(dp[k], q) + dzp;
            elem4(dt, q) = dtau;
            s1 += dg1;
          }
          *reinterpret_cast<float4*>(us) = dt;
          const size_t i = idx[k];
          if (vec) {
            *reinterpret_cast<float4*>(a.out + i) = dv;
            *reinterpret_cast<float4*>(c.dzp + i) = o1;
            if (kF2) *reinterpret_cast<float4*>(c.dza + i) = o2;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (q >= nw[k]) continue;
              a.out[i + q] = elem4(dv, q);
              c.dzp[i + q] = elem4(o1, q);
              if (kF2) c.dza[i + q] = elem4(o2, q);
            }
          }
        } else if (el < groups) {
          *reinterpret_cast<float4*>(us) = zero4;  // past the image's width
        }
        // the code's dgam sums over its 16 lanes (every lane of the warp
        // takes part: groups is a multiple of 16)
#pragma unroll
        for (int off = kG / 2; off > 0; off >>= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          if (kF2) s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (el < groups && el % kG == 0) {
          const size_t pi = ((size_t)blockIdx.x * a.N + n) * a.O + o0 + el / kG;
          e.part[sums + pi] = s1;
          if (kF2) e.part[2 * sums + pi] = s2;
        }
      }
    }
    __syncthreads();
    // each code's dtau partial: its terms over the block's row, in order
    for (int on = tid; on < n_o; on += kAnaThreads) {
      const float* r = e_s + on * kAnaEP;
      float s = 0.f;
      for (int p = 0; p < kTW; ++p) s += r[p];
      e.part[((size_t)blockIdx.x * a.N + n) * a.O + o0 + on] = s;
    }
  }
}

// --------------------------------------------------------------- synthesis

// ---- staging of a code stage (8 codes: their input rows and weights)
//
// Where the code grid's width is a multiple of 4 and z sits on the 16-byte
// grid, one TMA tensor copy takes the whole stage's tile: a 4D box (columns,
// rows, 8 codes, 1 image) of z seen as (W, H, M, N), with zeros for every
// element outside the image or past code M. The box starts at the tile's
// first column rounded down to the 16-byte grid (a tensor copy's innermost
// start must lie on it: a copy starting off it stops the kernel with an
// illegal instruction), so it is up to 3 columns wider than the tile. It
// is also a little wider and taller than the tile, so that a channel's
// slab is 8 or 24 floats mod 32 and the fragment loads stay conflict-free:
// rows 2 mod 4, and an odd number of 16-byte columns. Otherwise (ragged
// widths, tensors off the grid: history slices) the rows go by RowStager,
// each keeping its offset from the grid. Either way the weights are 8 spans
// of T x O floats at their offset from the grid, by stage_spans, and the
// copies complete on the buffer's mbarrier.

// the box: rows 2 mod 4, at least `need`; columns an odd number of 4-float
// units, at least `need`
__host__ __device__ inline int box_rows(int need) { return need + (6 - need % 4) % 4; }
__host__ __device__ inline int box_cols(int need) { return 4 * (((need + 3) / 4) | 1); }

// A stage's staged tile: Qh + TH rows (TH output rows read through TH + 1
// A-rows) of 64 + Qw - 1 columns a code, at pitch `pitch` and `slab` floats
// a code; the weights follow at `wts`, then the next ring buffer at `buf`
// (a multiple of 32 floats: each buffer starts on 128 bytes for the TMA).
struct SynTile {
  int rows, cols, pitch, slab, wstride, wts, buf;
  __host__ __device__ SynTile(const MmaArgs& a, int TH, bool tma) {
    const Tile tl(a, TH + 1);
    rows = tma ? box_rows(tl.rows) : tl.rows;
    cols = tma ? box_cols(tl.cols + 3) : tl.cols;
    pitch = tma ? cols : tl.pitch;
    slab = tma ? rows * cols : tl.slab;
    wstride = syn_wstride(a.Qh * a.Qw, a.O);
    wts = 8 * slab;
    buf = (wts + 8 * wstride + 31) & ~31;
  }
};

// The TMA path, by one thread: the stage's box and its 8 weight spans on
// bar, then the thread's arrival (the barrier counts one).
__device__ inline void syn_stage_tma(float* buf, const MmaArgs& a, const SynTile& st,
                                     uint64_t tmap, int n, int h0, int w0, int c0,
                                     uint64_t* bar) {
  fence_proxy_async();  // the buffer's last readers and zero stores came first
  mbar_expect_tx(bar, 4 * 8 * st.slab);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(buf)),
      "l"(tmap), "r"((w0 + a.ow) & ~3), "r"(h0 + a.oh), "r"(c0), "r"(n),
      "r"(smem_addr(bar))
      : "memory");
  stage_spans<1>(buf + st.wts, a, a.Qh * a.Qw, st.wstride, c0, 0, bar);
  mbar_arrive(bar);
}

// the row of a warp's sums for column col of A-row ya in group tg
__device__ inline int ya_col(int tg, int ya, int col, int AR) { return (tg * AR + ya) * 8 + col; }

// the ring of pipeline buffers (reused afterwards for the warps' sums and
// the block's sums), then the table of tap pairs
template <int TH>
__host__ inline int syn_smem_floats(const MmaArgs& a, bool tma) {
  const SynTile st(a, TH, tma);
  const int ring = kSynNB * st.buf;
  const int red = (kSynThreads / 32 * 8 + 4 * TH) * kSynRP;
  return (ring > red ? ring : red) + (a.Qh + 1) / 2 * a.Qw;
}

// TH output rows (3 or 7) of 64 positions a block and 4 outputs. A warp
// owns one A-row (ya in [0, TH]: 4 m16 tiles) and a group of tap pairs;
// a tap pair is the taps (r0, c) and (r0 + 1, c) of one column, r0 even,
// and the n8 tile of a product holds the 4 outputs of each: with A read at
// A-row ya + r0, column n = j * 4 + o is output o of tap r0 + j, which
// belongs to output row ya - j. So a block reads TH + 1 A-rows for TH
// output rows, and each A fragment feeds two taps' products.
// kBf16: the output's bf16 copy into hist too.
template <int TH, bool kTma, bool kBf16 = false>
__global__ void __launch_bounds__(kSynThreads, kSynBlocksPerSM)
lista2d_syn_mma(const MmaArgs a, bool vec, __grid_constant__ const CUtensorMap tmap,
                __nv_bfloat16* hist) {
  constexpr int AR = TH + 1;                  // A-rows
  constexpr int TG = kSynThreads / 32 / AR;   // groups of tap pairs
  static_assert(AR * TG == kSynThreads / 32, "a warp an (A-row, group)");
  extern __shared__ __align__(128) float4 smem4[];
  __shared__ __align__(8) uint64_t bar[kSynNB];  // the ring's buffers
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const Tile tl(a, AR);
  const SynTile st(a, TH, kTma);
  const int T = a.Qh * a.Qw;
  const int PT = (a.Qh + 1) / 2 * a.Qw;  // tap pairs (the last row alone where Qh is odd)
  const int ring = kSynNB * st.buf, red_floats = (kSynThreads / 32 * 8 + 4 * TH) * kSynRP;
  int* s_pair = reinterpret_cast<int*>(smem + max(ring, red_floats));

  // the cluster's blocks split the code stages of one tile (blockIdx.x / S)
  const int tiles_w = (a.W + kTW - 1) / kTW;
  const int tile = blockIdx.x / S;
  const int w0 = (tile % tiles_w) * kTW, h0 = tile / tiles_w * TH;
  const int o_blocks = (a.O + 3) / 4;
  const int n = blockIdx.z / o_blocks;
  const int o0 = (blockIdx.z % o_blocks) * 4;
  const int n_o = min(4, a.O - o0);
  // this block's stages [st0, st0 + count) of the ceil(I / 8) stages of 8
  // codes
  const int nst = (a.I + 7) / 8;
  const int st0 = rank * nst / S, count = (rank + 1) * nst / S - st0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ya = warp % AR, tg = warp / AR;  // the warp's A-row and group
  const RowStager<kSynThreads> rows(a, tl, n, 0, h0, w0);
  // the TMA path's copies arrive from one thread, RowStager's from all
  if (tid < kSynNB) mbar_init(&bar[tid], kTma ? 1 : kSynThreads);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // each tap pair's offset into a code's staged tile << 2 | (RowStager's
  // path) its row's offset from the 16-byte grid less that of row 0, mod 4
  for (int pt = tid; pt < PT; pt += kSynThreads) {
    const int c = pt % a.Qw, r0 = 2 * (pt / a.Qw);
    s_pair[pt] = (r0 * st.pitch + c) << 2 | (kTma ? 0 : (int)(((unsigned)r0 * a.W) & 3u));
  }
  __syncthreads();  // the barriers are initialized

  float acc[kSynMT][4];
#pragma unroll
  for (int mt = 0; mt < kSynMT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  // stage j of this block (codes [8 (st0 + j), + 8) and their weights) into
  // ring buffer j % kSynNB, on its barrier: one tensor copy, or a bulk copy
  // a staged row and a weight span
  const uint64_t tmap_addr = reinterpret_cast<uint64_t>(&tmap);  // param space
  auto stage = [&](int j) {
    if (j >= count) return;
    float* buf = smem + j % kSynNB * st.buf;
    uint64_t* bj = &bar[j % kSynNB];
    const int c0 = 8 * (st0 + j);
    if (kTma) {
      if (tid == 0) syn_stage_tma(buf, a, st, tmap_addr, n, h0, w0, c0, bj);
    } else {
      fence_proxy_async();  // the buffer's last readers came first
      rows.stage(buf, c0, bj);
      stage_spans<kSynThreads>(buf + st.wts, a, T, st.wstride, c0, tid, bj);
      mbar_arrive(bj);
    }
  };

  // this lane's B column: output o0 + (g & 3) of tap r0 + (g >> 2)
  const int jb = g >> 2, ob = o0 + (g & 3);
  // TMA path: the box starts at the tile's first column rounded down to the
  // 16-byte grid (a tensor copy's innermost start must lie on it), dx
  // columns before it
  const int dx = kTma ? (w0 + a.ow) - ((w0 + a.ow) & ~3) : 0;
  const unsigned w4 = (unsigned)a.W & 3u;
  for (int j = 0; j < kSynNB - 1; ++j) stage(j);
  for (int j = 0; j < count; ++j) {
    const int b = j % kSynNB, c0 = 8 * (st0 + j);
    mbar_wait(&bar[b], (j / kSynNB) & 1);
    if (!kTma) rows.fix(smem + b * st.buf, c0);  // rows off the grid
    // stage j has landed for every thread, and every warp is done with
    // stage j - 1's buffer, which stage j + kSynNB - 1's copies fill
    __syncthreads();
    stage(j + kSynNB - 1);
    // the offset from the grid of this lane's code's staged row ya (code
    // t + 4's rows sit 4 planes on, at the same offsets; none on the TMA
    // path, where staged column 0 is the tile's first)
    const unsigned sh_t = kTma ? 0u : rows.sh0(c0, t) + (unsigned)ya * w4;
    const float* x_t = smem + b * st.buf + t * st.slab + ya * st.pitch + g + dx;
    // code t's weights (code t + 4's are 4 slots on, at the same offset
    // from the grid)
    const float* w_t = smem + b * st.buf + st.wts + t * st.wstride + span_sh(a, c0 + t, T);
    // each pair's three products go into a fresh fragment per m16 tile,
    // added to the sums in fp32
    for (int pt = tg; pt < PT; pt += TG) {
      const int c = pt % a.Qw, r = 2 * (pt / a.Qw) + jb;
      const bool real = r < a.Qh && ob < a.O;  // else a zero column
      const int wi = (r * a.Qw + c) * a.O + ob;
      uint32_t bhi[2], blo[2];
      split_rn(real ? w_t[wi] : 0.f, bhi[0], blo[0]);
      split_rn(real ? w_t[4 * st.wstride + wi] : 0.f, bhi[1], blo[1]);
      const int e = s_pair[pt];
      const float* xr = x_t + (e >> 2) + (kTma ? 0u : (sh_t + (unsigned)e) & 3u);
#pragma unroll
      for (int k = 0; k < kSynMT; ++k) {
        uint32_t ahi[4], alo[4];
        load_a<true>(xr + k * 16, st.slab, ahi, alo);
        float part[4] = {};
        mma_tf32(part, alo, bhi);
        mma_tf32(part, ahi, blo);
        mma_tf32(part, ahi, bhi);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][q] += part[q];
      }
    }
  }
  __syncthreads();  // every warp is done with the ring

  // each warp's sums -> shared memory (warp, column, position), then the
  // block's sums -> blk (output, row, position): output row y takes column
  // o of A-row y and column 4 + o of A-row y + 1, over the groups in order;
  // the cluster's blocks read blk
  float* red = smem;
  float* blk = smem + kSynThreads / 32 * 8 * kSynRP;
#pragma unroll
  for (int mt = 0; mt < kSynMT; ++mt) {
    float* rw = red + ((tg * AR + ya) * 8 + 2 * t) * kSynRP + mt * 16 + g;
    rw[0] = acc[mt][0];
    rw[kSynRP] = acc[mt][1];
    rw[8] = acc[mt][2];
    rw[kSynRP + 8] = acc[mt][3];
  }
  __syncthreads();
  for (int e = tid; e < 4 * TH * kTW; e += kSynThreads) {
    const int o = e / (TH * kTW), y = e / kTW % TH, x = e % kTW;
    float u = red[ya_col(0, y, o, AR) * kSynRP + x];
#pragma unroll
    for (int k = 1; k < TG; ++k) u += red[ya_col(k, y, o, AR) * kSynRP + x];
#pragma unroll
    for (int k = 0; k < TG; ++k) u += red[ya_col(k, y + 1, 4 + o, AR) * kSynRP + x];
    blk[(o * TH + y) * kSynRP + x] = u;
  }
  cluster.sync();  // every block's sums are in its shared memory

  // this block's share of the outputs, in groups of 4 positions along a
  // row (W % 4 == 0 and 16-byte aligned tensors, else 1): the cluster's
  // sums in rank order, then [mask *] u [- y]
  const int gw = vec ? 4 : 1;
  const int groups = n_o * TH * (kTW / gw);
  const size_t plane = (size_t)a.H * a.W;
  for (int e = rank * groups / S + tid; e < (rank + 1) * groups / S; e += kSynThreads) {
    const int on = e / (TH * (kTW / gw)), y = e / (kTW / gw) % TH, x = e % (kTW / gw) * gw;
    const int hh = h0 + y, ww = w0 + x;
    if (hh >= a.H || ww >= a.W) continue;
    const size_t idx = ((size_t)n * a.O + o0 + on) * plane + (size_t)hh * a.W + ww;
    const int off = (on * TH + y) * kSynRP + x;
    if (vec) {
      float4 u = *reinterpret_cast<const float4*>(cluster.map_shared_rank(blk, 0) + off);
      for (int k = 1; k < S; ++k) {
        const float4 r4 = *reinterpret_cast<const float4*>(cluster.map_shared_rank(blk, k) + off);
        u.x += r4.x, u.y += r4.y, u.z += r4.z, u.w += r4.w;
      }
      if (a.mask) {
        const float4 m4 = *reinterpret_cast<const float4*>(a.mask + idx);
        u.x *= m4.x, u.y *= m4.y, u.z *= m4.z, u.w *= m4.w;
      }
      if (a.y) {
        const float4 y4 = *reinterpret_cast<const float4*>(a.y + idx);
        u.x -= y4.x, u.y -= y4.y, u.z -= y4.z, u.w -= y4.w;
      }
      *reinterpret_cast<float4*>(a.out + idx) = u;
      if constexpr (kBf16) store_bf16x4(hist + idx, u);
    } else {
      float u = cluster.map_shared_rank(blk, 0)[off];
      for (int k = 1; k < S; ++k) u += cluster.map_shared_rank(blk, k)[off];
      if (a.mask) u *= a.mask[idx];
      if (a.y) u -= a.y[idx];
      a.out[idx] = u;
      if constexpr (kBf16) hist[idx] = __float2bfloat16_rn(u);
    }
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// ------------------------------------------------------------------ launch

// The launch of one call: its grid, and the codes a block (analysis) or the
// rows a block and the blocks a cluster (synthesis). One rule each, from
// the code grid and the card's SM count, so that a small grid still fills
// the card: the analysis takes the fewest code blocks whose blocks fill
// its resident slots (kAnaBlocksPerSM an SM); the synthesis, the cluster
// size with the least modelled time below.
struct Launch {
  dim3 grid;
  int bn;     // analysis: codes a block (a multiple of 16, at most 176)
  int rows;   // synthesis: code rows a block (7, or 3 where 7 cannot fill the card)
  int split;  // synthesis: blocks a cluster, which split the codes
};

inline Launch launch_of(bool synthesis, const MmaArgs& a, int sms) {
  const long tiles_w = (a.W + kTW - 1) / kTW;
  Launch l{};
  if (!synthesis) {
    const long rows = (long)a.N * a.H * tiles_w;  // row tiles
    const int units = (a.O + 15) / 16;  // 16 codes: an n8 tile for each code warp
    int cb = (a.O + kAnaMaxBN - 1) / kAnaMaxBN;
    while (cb < units && rows * cb < (long)kAnaBlocksPerSM * sms) ++cb;
    l.bn = 16 * ((units + cb - 1) / cb);
    l.rows = 1;
    l.split = 1;
    l.grid = dim3((unsigned)(a.H * tiles_w), (unsigned)((a.O + l.bn - 1) / l.bn),
                  (unsigned)a.N);
  } else {
    // 7 rows a block unless even 8 blocks a tile leave resident slots
    // (kSynBlocksPerSM an SM) empty, else 3
    const int o_blocks = (a.O + 3) / 4, nst = (a.I + 7) / 8;
    const long slots = (long)kSynBlocksPerSM * sms;
    auto tiles = [&](int TH) { return (long)a.N * o_blocks * tiles_w * ((a.H + TH - 1) / TH); };
    l.rows = tiles(7) * (nst < kMaxSplit ? nst : kMaxSplit) >= slots ? 7 : 3;
    // the cluster size S with the least modelled time: the call's waves
    // (blocks over the resident slots, rounded up) times a block's time,
    // its stages plus two for its prologue and the cluster's epilogue (the
    // model orders the splits as they measured on the H100: PERF.md)
    auto cost = [&](long S) {
      return (tiles(l.rows) * S + slots - 1) / slots * ((nst + S - 1) / S + 2);
    };
    int S = 1;
    for (int s2 = 2; s2 <= kMaxSplit && s2 <= nst; s2 *= 2)
      if (cost(s2) <= cost(S)) S = s2;  // a tie goes to the finer split
    l.bn = 8;
    l.split = S;
    l.grid = dim3((unsigned)(tiles_w * ((a.H + l.rows - 1) / l.rows) * S), 1,
                  (unsigned)(a.N * o_blocks));
  }
  return l;
}

inline bool valid(const MmaArgs& a) {
  return a.N > 0 && a.I > 0 && a.O > 0 && a.H > 0 && a.W > 0 && a.Qh > 0 && a.Qw > 0 &&
         a.D == 1 && a.Qd == 1;
}

// The launch a call at these sizes makes on the current device, or an error.
inline int query(bool synthesis, const MmaArgs& a, Launch& l) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return (int)err;
  l = launch_of(synthesis, a, sms);
  return 0;
}

// cuTensorMapEncodeTiled, fetched by the runtime's entry-point query (no
// link to libcuda), or NULL.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The synthesis stages by TMA tensor copies where z's rows are 16-byte
// strides and z sits on the grid.
inline bool syn_tma(const MmaArgs& a) { return a.W % 4 == 0 && mis4(a.in) == 0; }

template <int TH, bool kTma, bool kBf16>
int launch_syn(const Launch& l, const MmaArgs& a, bool vec, __nv_bfloat16* hist,
               cudaStream_t stream) {
  const int smem = (int)sizeof(float) * syn_smem_floats<TH>(a, kTma);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tmap;
  memset(&tmap, 0, sizeof(tmap));
  if (kTma) {  // z as (W, H, M, N), a box of one stage's tile
    const SynTile st(a, TH, true);
    const cuuint64_t dims[4] = {(cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)a.I,
                                (cuuint64_t)a.N};
    const cuuint64_t strides[3] = {4ull * a.W, 4ull * a.W * a.H, 4ull * a.W * a.H * a.I};
    const cuuint32_t box[4] = {(cuuint32_t)st.cols, (cuuint32_t)st.rows, 8u, 1u};
    const cuuint32_t ones[4] = {1u, 1u, 1u, 1u};
    const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
    if (!encode) return (int)cudaErrorNotSupported;
    if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(a.in), dims,
               strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  static int limit[64] = {};
  cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(lista2d_syn_mma<TH, kTma, kBf16>), smem, limit);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = l.grid;
  cfg.blockDim = dim3(kSynThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)l.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lista2d_syn_mma<TH, kTma, kBf16>, a, vec, tmap, hist);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One analysis launch with epilogue kEpi (and kBf16, with hist) by the
// analysis's launch rule (its grid into l), the dynamic shared-memory limit
// raised once per size and device.
template <int kEpi, bool kBf16 = false>
int launch_ana(const MmaArgs& a, bool vec, const AdjointArgs& e, const CsrArgs& c, Launch& l,
               cudaStream_t stream, __nv_bfloat16* hist = nullptr) {
  const int q = query(false, a, l);
  if (q != 0) return q;
  if (l.grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
  const int smem = (int)sizeof(float) * ana_smem_floats(a, l.bn);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  static int limit[64] = {};
  const cudaError_t err =
      raise_smem_limit(reinterpret_cast<const void*>(lista2d_ana_mma<kEpi, kBf16>), smem, limit);
  if (err != cudaSuccess) return (int)err;
  lista2d_ana_mma<kEpi, kBf16><<<l.grid, kAnaThreads, smem, stream>>>(a, l.bn, vec, e, c, hist);
  return (int)cudaGetLastError();
}

// The synthesis adjoint: the analysis's launch with the AdjointArgs
// epilogue (z_bf16: on bf16 codes a.z), then the dtau partials (one a block
// of the grid's x: the code blocks of a row write the same partial's other
// codes) summed over the blocks in a fixed order into dtau (N, O).
inline int launch_adjoint(const MmaArgs& a, const AdjointArgs& e, float* dtau, bool z_bf16,
                          cudaStream_t stream) {
  if (!a.z) return (int)cudaErrorInvalidValue;
  const bool vec =
      (z_bf16 ? vec_epilogue_bf16(a, a.z) : vec_epilogue(a)) && (!e.base || mis4(e.base) == 0);
  Launch l;
  const int err = z_bf16 ? launch_ana<kAnaAdjoint, true>(a, vec, e, CsrArgs{}, l, stream)
                         : launch_ana<kAnaAdjoint>(a, vec, e, CsrArgs{}, l, stream);
  if (err != 0) return err;
  return launch_sum_parts(e.part, dtau, a.N * a.O, (int)l.grid.x, stream);
}

// The CSR synthesis adjoints: the analysis's launch with the prox adjoint's
// epilogue (f2 false: c.gam1, c.zp, c.dzp; true: also c.gam2, c.za, c.dza),
// then the partials of each of the 2 (3) sums, e.part + q * blocks * N * O,
// summed over the blocks in a fixed order into sums[q]: dtau, dgam1 (and
// dgam2). 16-byte accesses where the codes' rows are a multiple of 4 floats
// and every code tensor sits on the grid (bf16: a.z and c.u bf16
// histories, on the 8-byte grid).
inline int launch_adjoint_csr(const MmaArgs& a, const AdjointArgs& e, const CsrArgs& c, bool f2,
                              float* const* sums, bool bf16, cudaStream_t stream) {
  if (!a.z || !a.tau || !c.gam1 || !c.zp || !c.u || !c.dzp ||
      (f2 && (!c.gam2 || !c.za || !c.dza)))
    return (int)cudaErrorInvalidValue;
  const bool hists = bf16 ? vec_epilogue_bf16(a, a.z) && aligned8(c.u)
                          : vec_epilogue(a) && mis4(c.u) == 0;
  const bool vec = hists && (!e.base || mis4(e.base) == 0) && mis4(c.zp) == 0 &&
                   mis4(c.dzp) == 0 && (!f2 || (mis4(c.za) == 0 && mis4(c.dza) == 0));
  Launch l;
  int err = f2 ? (bf16 ? launch_ana<kAnaAdjointCsrF2, true>(a, vec, e, c, l, stream)
                       : launch_ana<kAnaAdjointCsrF2>(a, vec, e, c, l, stream))
               : (bf16 ? launch_ana<kAnaAdjointCsr, true>(a, vec, e, c, l, stream)
                       : launch_ana<kAnaAdjointCsr>(a, vec, e, c, l, stream));
  const size_t rows = (size_t)a.N * a.O;
  for (int q = 0; err == 0 && q < (f2 ? 3 : 2); ++q)
    err = launch_sum_parts(e.part + q * l.grid.x * rows, sums[q], (int)rows, (int)l.grid.x,
                           stream);
  return err;
}

// The CSR analyses: the one-sided prox (f2 false: c.gam1, c.zp) or the
// two-sided one (also c.gam2, c.za); hist: NULL, or the bf16 history slice
// (N, O, H, W) that takes the codes' rounded copy, and then u_out is bf16
// too. 16-byte accesses where the codes' rows are a multiple of 4 floats
// and every code tensor sits on the grid (the bf16 ones on the 8-byte grid).
inline int launch_csr(const MmaArgs& a, const CsrArgs& c, bool f2, __nv_bfloat16* hist,
                      cudaStream_t stream) {
  if (!a.tau || !c.gam1 || !c.zp || (f2 && (!c.gam2 || !c.za)))
    return (int)cudaErrorInvalidValue;
  const bool outs = hist ? vec_epilogue_bf16(a, hist) && (!c.u_out || aligned8(c.u_out))
                         : vec_epilogue(a) && (!c.u_out || mis4(c.u_out) == 0);
  const bool vec = outs && mis4(c.zp) == 0 && (!f2 || mis4(c.za) == 0);
  Launch l;
  const AdjointArgs e{};
  if (hist)
    return f2 ? launch_ana<kAnaCsrF2, true>(a, vec, e, c, l, stream, hist)
              : launch_ana<kAnaCsr, true>(a, vec, e, c, l, stream, hist);
  return f2 ? launch_ana<kAnaCsrF2>(a, vec, e, c, l, stream)
            : launch_ana<kAnaCsr>(a, vec, e, c, l, stream);
}

// The forward pair; hist: NULL, or the bf16 history slice (N, O, H, W)
// that takes the output's rounded copy.
template <bool kBf16>
int launch_pair(bool synthesis, const MmaArgs& a, __nv_bfloat16* hist, cudaStream_t stream) {
  Launch l;
  const bool vec = kBf16 ? vec_epilogue_bf16(a, hist) : vec_epilogue(a);
  if (!synthesis)
    return launch_ana<kAnaSt, kBf16>(a, vec, AdjointArgs{}, CsrArgs{}, l, stream, hist);
  const int q = query(true, a, l);
  if (q != 0) return q;
  if (l.grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
  if (syn_tma(a))
    return l.rows == 7 ? launch_syn<7, true, kBf16>(l, a, vec, hist, stream)
                       : launch_syn<3, true, kBf16>(l, a, vec, hist, stream);
  return l.rows == 7 ? launch_syn<7, false, kBf16>(l, a, vec, hist, stream)
                     : launch_syn<3, false, kBf16>(l, a, vec, hist, stream);
}

inline int launch(bool synthesis, const MmaArgs& a, __nv_bfloat16* hist, cudaStream_t stream) {
  return hist ? launch_pair<true>(synthesis, a, hist, stream)
              : launch_pair<false>(synthesis, a, nullptr, stream);
}

}  // namespace mma2d
