// The 3D forward pair on the tensor cores of Hopper (sm_90a): the
// stride-1 phase-domain correlation
//
//   out[n,o,d,h,w] = sum_{i,a,b,c} wt[i,a,b,c,o] * in[n,i,d+a+od,h+b+oh,w+c+ow]
//
// (zero outside the input volume), as an implicit GEMM on
// mma.sync.m16n8k8 TF32 products, with three fused epilogues:
//
//   lista3d_ana_mma<false> (analysis): out = ST(z - u, tau[n, o]); z ==
//       NULL reads as zeros, and out may be z (each output element is read
//       and then written by one thread).
//   lista3d_ana_mma<true> (the reverse pass's synthesis adjoint, with
//       mma_tf32.cuh's AdjointArgs): dz = [base +] alpha * u, out = dv =
//       1{z != 0} dz, and per block and code the dtau partial -sum sign(z)
//       dz over the block's positions in order (sum_parts then sums the
//       blocks in a fixed order). The same mainloop, with the round-to-nearest split.
//   lista3d_syn_mma (synthesis): out = [mask *] u [- y].
//
// The bf16 training histories (kBf16, kernels/lista3d.py::hist_dtype): the
// forward analysis and the synthesis also store their fp32 output, rounded
// to nearest even, as bf16 into the history slice `hist`, in the same
// epilogue (8 bytes a group of 4 positions where the fp32 store is 16); the
// adjoint reads the codes z as bf16, for their zeros and signs alone, which
// bf16 keeps. The fp32 arithmetic is the same, so the fp32 outputs are
// bitwise those of the kBf16 = false instantiations, which the parameter
// leaves as they were.
//
// They replace, for lista3d.cu's entry points, the TPU kernels
// cdlnet_tpu/kernels/lista3d.py::_kernel_resident (K1) and _kernel_syn /
// _kernel_ana (K3), the banded pair lista3d_tiled.py::_kernel_syn3_band /
// _kernel_ana3_band (K9) and the ring kernels of lista3d_ring.py (K11); in
// the reverse pass the synthesis serves as the analysis adjoint
// (lista3d_tiled_bwd.py::_kernel_ds_band, K10; lista3d_ring_bwd.py, K12) and
// the analysis, with its adjoint epilogue, as the synthesis adjoint of
// lista3d_bwd_resident.py::_kernel_bwd_resident (K2), lista3d_bwd.py::
// _kernel_syn_bwd (K4), lista3d_tiled_bwd.py::_kernel_dz_band (K10) and
// the ring reverse (K12).
// Their building blocks (the arguments, the staged tile and its row stager,
// the bulk copies, the operand split and the product) are in mma_tf32.cuh,
// which the 2D pair (lista2d_mma.cuh) shares.
//
// The fp32 contract, by 3xTF32. A TF32 product keeps 11 significant bits,
// about three digits. Each operand x is split into hi = x truncated to 11
// significant bits (one logic operation) and lo = x - hi (exact in fp32;
// the tensor core reads its top 11 bits), and each product accumulates
// lo*hi + hi*lo + hi*hi. What is dropped (lo*lo, lo's low bits) is below
// 2^-20 of the product and shrinks it toward zero, so over a sum of
// products it moves the result by ~2^-21 of itself, not of the terms'
// magnitudes; a round-to-nearest split (Veltkamp's) costs four fp32
// operations instead of two. The tensor core's own fp32 sums truncate, and
// a long chain of them drifts (with 225 products a code at (9,9,5) taps,
// tests/test_torch_cuda.py's K=3 big-frame gradient missed its 1e-4 gate),
// so no chain is long: the analysis
// adds each tap's three products, the synthesis each stage's, from a fresh
// fragment into the running sums in round-to-nearest fp32. A call then sits
// within fp32 reassociation of the plain version and every gate of the
// CUDA-core kernels holds unchanged. Each output is one thread's fixed
// sequence of products and one fixed-order reduction: two runs are
// bitwise equal.
//
// What bounds them on this card. At the flagship shape (M = 169 codes,
// Cp = 8 phases, an 8x64x64 code grid, 4x4x3 phase taps) the function is
// 2.71 GFLOP of nonzero-tap FMAs: 0.0405 ms at fp32's 67 TFLOP/s on the
// CUDA cores, 0.0165 ms as three TF32 products at the dense 495 TFLOP/s of
// the tensor cores (mma.sync reaches less of it than wgmma; the synthesis
// also runs the zero taps, 4.25 GFLOP dense). The analysis moves r, z and
// z_old (45.6 MB, 0.0136 ms at 3.35 TB/s), the synthesis 0.0073 ms of
// bytes. Both are bound by operations; what holds them back is feeding the
// tensor cores: every A fragment is loaded from shared memory and split (4
// loads and 8 operations for 3 products in the synthesis), and the staged
// tiles are read ~7x over (each input element sits in Qd depth taps' and
// the row halo's copies). The design:
//
// - Staging. Per channel stage (8 input channels, the k8 of one product) a
//   block stages its input tile with the tap halo (8 x Qd x (TH + Qh - 1)
//   x (64 + Qw - 1)) once, and every tap reads its A fragments from that
//   tile at the tap's offset: no im2col reaches device memory. Each
//   channel's slab has a stride of 8 mod 32 floats, so the fragment loads
//   (8 positions x 4 channels a warp) are conflict-free. Rows go by the TMA
//   engine's bulk copies (cp.async.bulk, completed on an mbarrier), one a
//   staged row, with zeros stored around it: cp.async would issue a copy
//   per 4 to 16 bytes through the load/store unit that the fragment loads
//   keep busy, where a bulk copy takes a row in one instruction. A row
//   keeps its global offset from the 16-byte grid in shared memory (its
//   columns start 0-3 floats in), so its copy is aligned at both ends once
//   widened to the grid (into the row's padding), and the fragment loads
//   add each row's offset. On a grid whose width is a multiple of 4 every
//   row has the same offset and the widening never reaches the zeros; rows
//   of any other width (the native step's 427-wide grid) or of an
//   unaligned view have their own offsets, and a block at a volume edge
//   zeroes its out-of-volume columns again once the copies have landed.
//   The synthesis stages aligned rows by a leaner loop, in a kernel
//   instantiation that adds one offset for all rows and skips that fix:
//   its staging threads run the loop before their products, and every
//   warp waits for them at the next barrier. tools/bench_video_serve.py
//   times the general path beside it on the same codes placed 4 bytes off
//   the grid (its "off-grid z" lines; PERF.md has the times).
// - mma.sync, not wgmma. wgmma's shared-memory descriptors need tiles that
//   start on 16-byte boundaries, which a one-column tap shift breaks, so A
//   would come from registers anyway; mma.sync.m16n8k8 takes the same
//   fragments with the 8-wide N of the synthesis (Cp = 8) exactly.
// - Synthesis (M = positions, N = 8 output phases, K = codes x taps). A
//   block owns 4 code rows x 64 columns of one depth (256 positions) with
//   16 warps: 2 halves of the positions (8 m16 tiles a warp) x 8 groups of
//   taps (group k takes taps k, k + 8, ...), one block an SM, two pipeline
//   buffers of (tile, weights), so the next 8 codes' copies fly while this
//   stage's products run; at the serve shape 128 blocks, one wave on 132
//   SMs. The tap groups' sums meet in shared memory, added in group order;
//   no atomics, no memset. One n8 tile spans all 8 phases, so no tap is
//   skipped: the 36% of structurally zero products run on the tensor
//   cores, where grouping the tiles by phase would cost a split of every A
//   fragment per phase instead. The epilogue [mask *] u [- y] reads and
//   stores coalesced rows, 16 bytes a thread where the width allows.
// - Analysis (M = positions, N = codes, K = phases x taps). A block owns
//   2 x 64 positions and 176 codes (22 n8 tiles: M = 169 in one block, 4%
//   padding) with 8 warps, 4 along positions (two m16 tiles each) x 2
//   along codes (11 n8 tiles), so each split A fragment feeds 11 products
//   and each B fragment two. The input tile is staged once per 8 phases
//   (once a call at Cp = 8), the weights one tap row at a time through two
//   buffers (one bulk copy per (channel, tap) of its codes, widened to the
//   grid like a row). A tap is skipped where every phase of
//   the stage has a zero weight (mma_tf32.cuh's tap box, united over the
//   8 phases). The epilogue goes through shared memory, so that
//   z_old is read and z written in coalesced rows of 16-byte accesses (4
//   positions a thread and access, 4 in flight before any store; scalar
//   for a grid width that is not a multiple of 4). At the serve shape the
//   grid is 256 blocks, two resident an SM (at most 128 registers a thread
//   by its launch bounds, ~93 KB of shared memory each): 264 slots, one wave,
//   where the CUDA-core kernel's 6 x 32-code tiles padded M to 192 and
//   took 384 blocks.
//
// Every shape the wrappers take: any Cp (1, 8, 24: the stage's missing
// channels are zeros in shared memory), any M (n8 tiles past M are skipped
// per warp), any tap counts and offsets, ragged grids (positions past the
// volume compute on zeros and are not stored), N > 1 with tau per (n, m).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace mma3d {

using namespace tf32x3;

// analysis: 8 warps (4 along positions x 2 along codes), 2 x 64 positions,
// 176 codes; two blocks an SM
constexpr int kAnaThreads = 256, kAnaTH = 2, kAnaBN = 176, kAnaNT = 11;
// synthesis: 16 warps, 2 halves of 4 x 64 positions (8 m16 tiles a warp) x
// 8 groups of taps, 8 outputs; one block an SM
constexpr int kSynThreads = 512, kSynTH = 4, kSynTG = 8;

// ---------------------------------------------------------------- analysis

constexpr int kAnaBM = kAnaTH * kTW;
constexpr int kAnaEP = kAnaBM + 4;  // epilogue row pitch: 4 mod 16 floats
// a (channel, tap)'s 176 codes in a weight buffer start up to 3 floats in
// (their global offset from the 16-byte grid): 184 floats a tap
constexpr int kAnaCS = kAnaBN + 8;

__host__ __device__ inline int ana_wstride(int Qw) { return stride8(Qw * kAnaCS); }

__host__ inline int ana_smem_floats(const MmaArgs& a) {
  const Tile tl(a, kAnaTH);
  const int main = 8 * tl.slab + 2 * 8 * ana_wstride(a.Qw);
  const int epi = kAnaBN * kAnaEP;
  return main > epi ? main : epi;
}

// the 2 x 11 tiles of a warp at one tap: lo*hi, hi*lo, hi*hi into a fresh
// fragment per tile, added to its sums in fp32; w_t, w_t4 point at the
// tap's codes nb + g of channels t and t + 4; NT n8 tiles (all 11 where the
// warp's codes are all real)
template <int NT, bool kRN>
__device__ inline void ana_products(float (&acc)[2][kAnaNT][4], const uint32_t (&ahi)[2][4],
                                    const uint32_t (&alo)[2][4], const float* w_t,
                                    const float* w_t4, int nt) {
#pragma unroll
  for (int jj = 0; jj < (NT > 0 ? NT : kAnaNT); ++jj) {
    if (NT > 0 || jj < nt) {
      uint32_t bhi[2], blo[2];
      split2<kRN>(w_t[jj * 8], bhi[0], blo[0]);
      split2<kRN>(w_t4[jj * 8], bhi[1], blo[1]);
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

// The analysis: kAdj false, the forward's soft threshold (truncating split;
// e unread), with kBf16 also its bf16 copy into hist; kAdj true, the
// reverse pass's synthesis adjoint (AdjointArgs, the round-to-nearest
// split), with kBf16 on bf16 codes a.z (hist unread).
template <bool kAdj, bool kBf16 = false>
__global__ void __launch_bounds__(kAnaThreads, 2)
lista3d_ana_mma(const MmaArgs a, bool vec, const AdjointArgs e, __nv_bfloat16* hist) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t bar[2];  // the two weight buffers
  float* smem = reinterpret_cast<float*>(smem4);
  const Tile tl(a, kAnaTH);
  const int T = a.Qd * a.Qh * a.Qw;
  const int wstride = ana_wstride(a.Qw);
  float* s_in = smem;
  float* s_w = smem + 8 * tl.slab;  // two buffers of 8 x wstride

  const int tiles_w = (a.W + kTW - 1) / kTW;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const int h0 = (blockIdx.x / tiles_w) * kAnaTH;
  const int d = blockIdx.y;
  const int o_blocks = (a.O + kAnaBN - 1) / kAnaBN;
  const int n = blockIdx.z / o_blocks;
  const int o0 = (blockIdx.z % o_blocks) * kAnaBN;
  const int n_o = min(kAnaBN, a.O - o0);  // codes of this block

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wn = warp / 4;  // 4 x 2 warps
  const int nb = wn * kAnaNT * 8;          // the warp's first code in the block
  // the warp's n8 tiles that hold a real code (warp-uniform)
  const int nt = max(0, min(kAnaNT, (n_o - nb + 7) / 8));
  const RowStager<kAnaThreads> rows(a, tl, n, d, h0, w0);
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

  // the warp's two m16 tiles: positions wm * 32 + [0, 32) of the block's
  // TH x 64, all in tile row mrow
  const int mrow = wm * 32 / kTW, mcol = wm * 32 % kTW;

  // (channel c0 + ci, tap) -> its first code's offset in the bank, and
  // that offset's distance from the 16-byte grid (unsigned: mod 4 survives
  // the wrap)
  auto w_start = [&](int c0, int ci, int tap) {
    return ((size_t)(c0 + ci) * T + tap) * a.O + o0;
  };
  auto w_sh = [&](int c0, int ci, int tap) {
    return (mis4(a.wt) + ((unsigned)(c0 + ci) * T + tap) * a.O + o0) & 3u;
  };
  // the weights of tap row (q, r) for channels [c0, c0 + 8) into buffer b:
  // a thread a (channel, tap), its codes by copy_span `w_sh` floats into a
  // 184-float slot; zeros past channel I; codes past O reach only unstored
  // columns
  const size_t w_total = (size_t)a.I * T * a.O;
  auto stage_w = [&](int c0, int q, int r, int b) {
    float* dst = s_w + b * 8 * wstride;
    for (int k = tid; k < 8 * a.Qw; k += kAnaThreads) {
      const int ci = k / a.Qw, c = k % a.Qw, tap = (q * a.Qh + r) * a.Qw + c;
      float* slot = dst + ci * wstride + c * kAnaCS;
      if (c0 + ci >= a.I)
        zero(slot, kAnaCS);
      else  // widened to the grid within the slot
        copy_span(slot + w_sh(c0, ci, tap), a.wt + w_start(c0, ci, tap), n_o, &bar[b],
                  w_start(c0, ci, tap) + n_o + 3 <= w_total);
    }
  };

  for (int c0 = 0; c0 < a.I; c0 += 8) {
    // the taps where some phase of the stage has a nonzero weight
    int qd0 = 0, qd1 = a.Qd, qh0 = 0, qh1 = a.Qh, qw0 = 0, qw1 = a.Qw;
    if (a.s > 0) {
      qd0 = a.Qd, qd1 = 0, qh0 = a.Qh, qh1 = 0, qw0 = a.Qw, qw1 = 0;
      const int s2 = a.s * a.s;
      for (int i = c0; i < min(c0 + 8, a.I); ++i) {
        const int ph = i % (a.s * s2);
        int lo, hi;
        tap_box(a.s, ph / s2, a.P[0], a.pad[0], a.od, a.Qd, lo, hi);
        qd0 = min(qd0, lo), qd1 = max(qd1, hi);
        tap_box(a.s, ph / a.s % a.s, a.P[1], a.pad[1], a.oh, a.Qh, lo, hi);
        qh0 = min(qh0, lo), qh1 = max(qh1, hi);
        tap_box(a.s, ph % a.s, a.P[2], a.pad[2], a.ow, a.Qw, lo, hi);
        qw0 = min(qw0, lo), qw1 = max(qw1, hi);
      }
    }
    const int nh = qh1 - qh0;
    const int n_rows = qd1 > qd0 && nh > 0 && qw1 > qw0 ? (qd1 - qd0) * nh : 0;
    if (n_rows == 0) continue;

    // the previous stage's products are done with s_in and both buffers
    __syncthreads();
    fence_proxy_async();
    // the input tile and row 0's weights, on buffer 0's barrier
    rows.stage(s_in, c0, &bar[0]);
    stage_w(c0, qd0, qh0, 0);
    mbar_arrive(&bar[0]);
    // the offset of this lane's channels' staged rows from the grid
    const unsigned sh_t = rows.sh0(c0, t);
    for (int j = 0; j < n_rows; ++j) {
      const int b = j & 1;
      mbar_wait(&bar[b], (phases >> b) & 1);
      phases ^= 1 << b;
      if (j == 0 && ragged) rows.fix(s_in, c0);
      // row j's weights (and the tile) have landed, and every warp is done
      // with buffer b ^ 1, which row j + 1's copies overwrite
      __syncthreads();
      if (j + 1 < n_rows) {
        fence_proxy_async();
        stage_w(c0, qd0 + (j + 1) / nh, qh0 + (j + 1) % nh, b ^ 1);
        mbar_arrive(&bar[b ^ 1]);
      }
      const int q = qd0 + j / nh, r = qh0 + j % nh;
      const int line = q * tl.rows + r + mrow;
      const float* x_t = s_in + t * tl.slab + line * tl.pitch + mcol + g +
                         rows.sh(sh_t, q, r + mrow);
      const float* wr = s_w + b * 8 * wstride + t * wstride + nb + g;
      for (int c = qw0; c < qw1; ++c) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) load_a<kAdj>(x_t + mt * 16 + c, tl.slab, ahi[mt], alo[mt]);
        // channel t + 4's codes share channel t's offset from the grid
        const float* w_t = wr + c * kAnaCS + w_sh(c0, t, (q * a.Qh + r) * a.Qw + c);
        const float* w_t4 = w_t + 4 * wstride;
        if (nt == kAnaNT)
          ana_products<kAnaNT, kAdj>(acc, ahi, alo, w_t, w_t4, nt);
        else
          ana_products<0, kAdj>(acc, ahi, alo, w_t, w_t4, nt);
      }
    }
  }
  __syncthreads();  // every warp is done with the staged tiles

  // the accumulators -> shared memory (code, position), then the epilogue
  // in coalesced rows
  float* e_s = smem;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int jj = 0; jj < kAnaNT; ++jj) {
      const int on = nb + jj * 8 + 2 * t;
      const int p = wm * 32 + mt * 16 + g;
      e_s[on * kAnaEP + p] = acc[mt][jj][0];
      e_s[(on + 1) * kAnaEP + p] = acc[mt][jj][1];
      e_s[on * kAnaEP + p + 8] = acc[mt][jj][2];
      e_s[(on + 1) * kAnaEP + p + 8] = acc[mt][jj][3];
    }
  __syncthreads();
  if constexpr (!kAdj) {
    // groups of 4 positions along a row (W % 4 == 0 and 16-byte aligned
    // tensors, else 1), kB groups a thread per round: all their z_old loads
    // before any store (out may be z_old, so the compiler cannot move a load
    // above a store)
    constexpr int kB = 4;
    const bool v4 = vec;
    const int gw = v4 ? 4 : 1;  // positions a group
    const size_t plane = (size_t)a.H * a.W;
    const int groups = n_o * (kAnaBM / gw);
    for (int e0 = 0; e0 < groups; e0 += kB * kAnaThreads) {
      size_t idx[kB];
      float4 v[kB];
      float tau[kB];
  #pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int e = e0 + k * kAnaThreads + tid;
        const int on = e / (kAnaBM / gw), p = e % (kAnaBM / gw) * gw;
        const int hh = h0 + p / kTW, ww = w0 + p % kTW;
        const bool ok = e < groups && hh < a.H && ww < a.W;
        idx[k] = ok ? (((size_t)n * a.O + o0 + on) * a.D + d) * plane + (size_t)hh * a.W + ww
                    : ~(size_t)0;
        tau[k] = ok ? a.tau[n * a.O + o0 + on] : 0.f;
        v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!ok) continue;
        const float* u = e_s + on * kAnaEP + p;
        if (v4) {
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
        if (v4) {
          *reinterpret_cast<float4*>(a.out + idx[k]) = st;
          if constexpr (kBf16) store_bf16x4(hist + idx[k], st);
        } else {
          a.out[idx[k]] = st.x;
          if constexpr (kBf16) hist[idx[k]] = __float2bfloat16_rn(st.x);
        }
      }
    }
  } else {
    // dz = [base +] alpha * u; dv = 1{z != 0} dz; each element's dtau term
    // -sign(z) dz into e_s in place of its u (each element is one
    // thread's), zeros at positions outside the volume; loads first, as
    // above
    constexpr int kB = 4;
    const int gw = vec ? 4 : 1;  // positions a group
    const size_t plane = (size_t)a.H * a.W;
    const int groups = n_o * (kAnaBM / gw);
    for (int e0 = 0; e0 < groups; e0 += kB * kAnaThreads) {
      size_t idx[kB];
      float4 bz[kB], zz[kB];
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int el = e0 + k * kAnaThreads + tid;
        const int on = el / (kAnaBM / gw), p = el % (kAnaBM / gw) * gw;
        const int hh = h0 + p / kTW, ww = w0 + p % kTW;
        const bool ok = el < groups && hh < a.H && ww < a.W;
        idx[k] = ok ? (((size_t)n * a.O + o0 + on) * a.D + d) * plane + (size_t)hh * a.W + ww
                    : ~(size_t)0;
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
        float* u = e_s + el / (kAnaBM / gw) * kAnaEP + el % (kAnaBM / gw) * gw;
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
    // each code's dtau partial: its terms over the block's positions, in order
    const size_t blk = (size_t)d * gridDim.x + blockIdx.x;
    for (int on = tid; on < n_o; on += kAnaThreads) {
      const float* r = e_s + on * kAnaEP;
      float s = 0.f;
      for (int p = 0; p < kAnaBM; ++p) s += r[p];
      e.part[(blk * a.N + n) * a.O + o0 + on] = s;
    }
  }
}

// --------------------------------------------------------------- synthesis

constexpr int kSynBM = kSynTH * kTW;
constexpr int kSynMT = kSynBM / 16 / (kSynThreads / 32 / kSynTG);  // m16 tiles a warp
constexpr int kSynEP = kSynBM + 4;

// two pipeline buffers (reused for the warps' partials), then the tap table
__host__ inline int syn_smem_floats(const MmaArgs& a) {
  const Tile tl(a, kSynTH);
  const int T = a.Qd * a.Qh * a.Qw;
  const int main = 2 * syn_buf_floats(tl, T, a.O);
  const int red = kSynTG * 8 * kSynEP;
  return (main > red ? main : red) + T;
}

// kRagged: staged rows sit at different offsets from the 16-byte grid (a
// width that is not a multiple of 4, or an unaligned input); else they all
// sit at the same one and the fragment loads skip the per-row offsets.
// kBf16: the output's bf16 copy into hist too.
template <bool kRagged, bool kBf16 = false>
__global__ void __launch_bounds__(kSynThreads, 1)
lista3d_syn_mma(const MmaArgs a, bool vec, __nv_bfloat16* hist) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t bar[2];  // the two pipeline buffers
  float* smem = reinterpret_cast<float*>(smem4);
  const Tile tl(a, kSynTH);
  const int T = a.Qd * a.Qh * a.Qw;
  const int wstride = syn_wstride(T, a.O);
  const int buf = syn_buf_floats(tl, T, a.O);
  const int red_floats = kSynTG * 8 * kSynEP;
  int* s_tap = reinterpret_cast<int*>(smem + max(2 * buf, red_floats));

  const int tiles_w = (a.W + kTW - 1) / kTW;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const int h0 = (blockIdx.x / tiles_w) * kSynTH;
  const int d = blockIdx.y;
  const int o_blocks = (a.O + 7) / 8;
  const int n = blockIdx.z / o_blocks;
  const int o0 = (blockIdx.z % o_blocks) * 8;
  const int n_o = min(8, a.O - o0);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tg = warp % kSynTG, mh = warp / kSynTG;  // tap group, position half
  const int mrow0 = mh * kSynMT * 16 / kTW;          // the half's first tile row
  const RowStager<kSynThreads> rows(a, tl, n, d, h0, w0);
  if (tid == 0) mbar_init(&bar[0], kSynThreads), mbar_init(&bar[1], kSynThreads);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  int phases = 0;  // bit b: the parity bar[b] completes next

  // each tap's offset into a channel's staged tile << 2 | its row's offset
  // from the 16-byte grid less that of row (0, 0), mod 4
  for (int tap = tid; tap < T; tap += kSynThreads) {
    const int c = tap % a.Qw, r = tap / a.Qw % a.Qh, q = tap / (a.Qw * a.Qh);
    s_tap[tap] = ((q * tl.rows + r) * tl.pitch + c) << 2 |
                 (int)(((unsigned)q * a.H + r) * a.W & 3u);
  }
  __syncthreads();  // the barriers are initialized

  float acc[kSynMT][4];
#pragma unroll
  for (int mt = 0; mt < kSynMT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  // channel c0 + ci's weights: their distance from the 16-byte grid
  auto w_sh = [&](int c0, int ci) { return span_sh(a, c0 + ci, T); };
  // stage c0 (input channels [c0, c0 + 8) and their 8 x T x 8 weights) into
  // pipeline buffer b, zeros past channel I, on bar[b]
  auto s_w0 = [&](int b) { return smem + b * buf + 8 * tl.slab; };
  auto stage = [&](int c0, int b) {
    float* s_in = smem + b * buf;
    float* s_w = s_w0(b);
    if (kRagged)
      rows.stage(s_in, c0, &bar[b]);
    else
      rows.stage_aligned(s_in, c0, &bar[b]);
    stage_spans<kSynThreads>(s_w, a, T, wstride, c0, tid, &bar[b]);
    mbar_arrive(&bar[b]);
  };

  fence_proxy_async();
  stage(0, 0);
  for (int c0 = 0, b = 0; c0 < a.I; c0 += 8, b ^= 1) {
    mbar_wait(&bar[b], (phases >> b) & 1);
    phases ^= 1 << b;
    if (kRagged) rows.fix(smem + b * buf, c0);
    // stage c0 has landed, and every warp is done with buffer b ^ 1, which
    // the next stage's copies fill
    __syncthreads();
    if (c0 + 8 < a.I) {
      fence_proxy_async();
      stage(c0 + 8, b ^ 1);
    }
    const float* s_in = smem + b * buf;
    // the offset from the grid of this lane's channel's row (0, 0), the
    // same in every stage (8 channels are a multiple of 4 rows apart)
    const unsigned sh_t = rows.sh0(c0, t);
    const float* x_t = s_in + t * tl.slab + mrow0 * tl.pitch + g + (kRagged ? 0u : sh_t & 3u);
    // the weights of channel t for output o0 + g (channel t + 4's are 4
    // buffers' rows on, at the same offset from the grid)
    const float* w_t = s_w0(b) + t * wstride + w_sh(c0, t) + o0 + g;
    const unsigned w4 = (unsigned)a.W & 3u;
    // this stage's products of the warp's taps (tg, tg + 8, ...) go into a
    // fresh fragment per m16 tile, added to the running sums in fp32
    float part[kSynMT][4] = {};
    for (int tap = tg; tap < T; tap += kSynTG) {
      uint32_t bhi[2], blo[2];
      split(w_t[tap * a.O], bhi[0], blo[0]);
      split(w_t[4 * wstride + tap * a.O], bhi[1], blo[1]);
      const int e = s_tap[tap];
#pragma unroll
      for (int m = 0; m < kSynMT * 16 / kTW; ++m) {  // the half's tile rows
        const unsigned rsh = (unsigned)e + (mrow0 + m) * w4;  // the row's offset, less row (0, 0)'s
        const float* xr = x_t + (e >> 2) + m * tl.pitch + (kRagged ? (sh_t + rsh) & 3u : 0u);
        for (int k = 0; k < kTW / 16; ++k) {
          const int mt = m * (kTW / 16) + k;
          uint32_t ahi[4], alo[4];
          load_a(xr + k * 16, tl.slab, ahi, alo);
          mma_tf32(part[mt], alo, bhi);
          mma_tf32(part[mt], ahi, blo);
          mma_tf32(part[mt], ahi, bhi);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kSynMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] += part[mt][e];
  }
  __syncthreads();  // every warp is done with the pipeline buffers

  // each warp's sums -> shared memory (tap group, output, position), summed
  // over the tap groups in order by the epilogue's threads
  float* red = smem;
#pragma unroll
  for (int mt = 0; mt < kSynMT; ++mt) {
    float* rw = red + (tg * 8 + 2 * t) * kSynEP + (mh * kSynMT + mt) * 16 + g;
    rw[0] = acc[mt][0];
    rw[kSynEP] = acc[mt][1];
    rw[8] = acc[mt][2];
    rw[kSynEP + 8] = acc[mt][3];
  }
  __syncthreads();
  // groups of 4 positions along a row (W % 4 == 0 and 16-byte aligned
  // tensors, else 1)
  const int gw = vec ? 4 : 1;
  const size_t plane = (size_t)a.H * a.W;
  for (int e = tid; e < n_o * (kSynBM / gw); e += kSynThreads) {
    const int on = e / (kSynBM / gw), p = e % (kSynBM / gw) * gw;
    const int hh = h0 + p / kTW, ww = w0 + p % kTW;
    if (hh >= a.H || ww >= a.W) continue;
    const size_t idx =
        (((size_t)n * a.O + o0 + on) * a.D + d) * plane + (size_t)hh * a.W + ww;
    if (vec) {
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kSynTG; ++k) {
        const float4 r4 = *reinterpret_cast<const float4*>(red + (k * 8 + on) * kSynEP + p);
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
      float u = 0.f;
#pragma unroll
      for (int k = 0; k < kSynTG; ++k) u += red[(k * 8 + on) * kSynEP + p];
      if (a.mask) u *= a.mask[idx];
      if (a.y) u -= a.y[idx];
      a.out[idx] = u;
      if constexpr (kBf16) hist[idx] = __float2bfloat16_rn(u);
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel, typename... Extra>
int launch_kernel(Kernel kern, dim3 grid, int threads, int smem, const MmaArgs& a,
                  bool vec, cudaStream_t stream, const Extra&... extra) {
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(a, vec, extra...);
  return (int)cudaGetLastError();
}

inline int smem_bytes(bool synthesis, const MmaArgs& a) {
  return (int)sizeof(float) * (synthesis ? syn_smem_floats(a) : ana_smem_floats(a));
}

// The grid of a call, (position tiles, D, N x code blocks), and its shared
// memory; or the reason it cannot launch.
inline int grid_of(bool synthesis, const MmaArgs& a, dim3& grid, int& smem) {
  if (a.N <= 0 || a.I <= 0 || a.O <= 0 || a.D <= 0 || a.H <= 0 || a.W <= 0 ||
      a.Qd <= 0 || a.Qh <= 0 || a.Qw <= 0)
    return (int)cudaErrorInvalidValue;
  smem = smem_bytes(synthesis, a);
  const int TH = synthesis ? kSynTH : kAnaTH;
  const int tiles = ((a.W + kTW - 1) / kTW) * ((a.H + TH - 1) / TH);
  const int o_blocks = synthesis ? (a.O + 7) / 8 : (a.O + kAnaBN - 1) / kAnaBN;
  const long zdim = (long)a.N * o_blocks;
  if (smem > kMaxSmem || a.D > 65535 || zdim > 65535 || a.Qw > 255)
    return (int)cudaErrorInvalidConfiguration;
  grid = dim3(tiles, a.D, (unsigned)zdim);
  return 0;
}

// The blocks whose dtau partials the adjoint writes: its grid's x * y (0
// where it cannot launch).
inline int adjoint_parts(const MmaArgs& a) {
  dim3 grid;
  int smem;
  return grid_of(false, a, grid, smem) == 0 ? (int)(grid.x * grid.y) : 0;
}

// The synthesis adjoint: the analysis's mainloop with the AdjointArgs
// epilogue (z_bf16: on bf16 codes a.z), then the dtau partials summed over
// the blocks in a fixed order into dtau (N, O).
template <bool kBf16>
inline int launch_adjoint_as(const MmaArgs& a, const AdjointArgs& e, const dim3& grid, int smem,
                             cudaStream_t stream) {
  static int limit[64] = {};
  const cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(lista3d_ana_mma<true, kBf16>), smem, limit);
  if (err != cudaSuccess) return (int)err;
  const bool base_ok = !e.base || mis4(e.base) == 0;
  const bool vec = (kBf16 ? vec_epilogue_bf16(a, a.z) : vec_epilogue(a)) && base_ok;
  lista3d_ana_mma<true, kBf16><<<grid, kAnaThreads, smem, stream>>>(a, vec, e, nullptr);
  return (int)cudaGetLastError();
}

inline int launch_adjoint(const MmaArgs& a, const AdjointArgs& e, float* dtau, bool z_bf16,
                          cudaStream_t stream) {
  dim3 grid;
  int smem;
  const int q = grid_of(false, a, grid, smem);
  if (q != 0) return q;
  if (!a.z) return (int)cudaErrorInvalidValue;
  const int err = z_bf16 ? launch_adjoint_as<true>(a, e, grid, smem, stream)
                         : launch_adjoint_as<false>(a, e, grid, smem, stream);
  if (err != 0) return err;
  return launch_sum_parts(e.part, dtau, a.N * a.O, (int)(grid.x * grid.y), stream);
}

// The forward pair; hist: NULL, or the bf16 history slice (N, O, D, H, W)
// that takes the output's rounded copy.
inline int launch(bool synthesis, const MmaArgs& a, __nv_bfloat16* hist, cudaStream_t stream) {
  dim3 grid;
  int smem;
  const int q = grid_of(synthesis, a, grid, smem);
  if (q != 0) return q;
  const bool vec = hist ? vec_epilogue_bf16(a, hist) : vec_epilogue(a);
  if (!synthesis)
    return hist ? launch_kernel(lista3d_ana_mma<false, true>, grid, kAnaThreads, smem, a, vec,
                                stream, AdjointArgs{}, hist)
                : launch_kernel(lista3d_ana_mma<false>, grid, kAnaThreads, smem, a, vec, stream,
                                AdjointArgs{}, hist);
  const bool ragged = !(a.W % 4 == 0 && mis4(a.in) == 0);
  if (hist)
    return ragged ? launch_kernel(lista3d_syn_mma<true, true>, grid, kSynThreads, smem, a, vec,
                                  stream, hist)
                  : launch_kernel(lista3d_syn_mma<false, true>, grid, kSynThreads, smem, a, vec,
                                  stream, hist);
  return ragged ? launch_kernel(lista3d_syn_mma<true>, grid, kSynThreads, smem, a, vec, stream,
                                hist)
                : launch_kernel(lista3d_syn_mma<false>, grid, kSynThreads, smem, a, vec, stream,
                                hist);
}

}  // namespace mma3d
