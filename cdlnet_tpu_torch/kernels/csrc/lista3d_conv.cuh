// The stride-1 phase-domain 3D correlation, fp32 on the CUDA cores, for
// Hopper (sm_90a), run by the CSR models' synthesis adjoints (lista3d_bwd.cu)
// at D = 1, Qd = 1 with the 2D phase map (sd = 1). Every other kernel runs on
// the tensor cores (lista3d_mma.cuh, lista2d_mma.cuh, lista3d_bwd.cu's
// weight gradient; their shared mma_tf32.cuh takes tap_box and kMaxSmem from
// here), the CSR analyses as lista2d_mma.cuh's prox epilogues; this template
// stays until the CSR adjoints move:
//
//   out[n,o,d,h,w] = sum_{i,a,b,c} wt[i,a,b,c,o] * in[n,i,d+a+od,h+b+oh,w+c+ow]
//
// with zero outside the input volume (the reference Conv3d's zero padding,
// handled by explicit bounds checks while staging the input tile), followed
// by one of two fused epilogues (csr_prox.cuh's):
//
//   kAdjointCsr, kAdjointCsrF2: dz = [base +] alpha * u, then the adjoint
//               of z = prox_csr(v, zp) / prox_csr_f2(v, zp, za) at the
//               stored prox argument v = uh and code z: out = dv, the
//               cotangent of v; dzp (and dza) += the neighbour codes'
//               cotangents, in place (each element is one thread's in a
//               launch); and per block and output channel the sums of
//               dtau, dgam1 (and dgam2) into part[q][block][n, o], q = 0, 1
//               (, 2), summed in a fixed order afterwards. Every prox
//               internal is recomputed from v in the order of the TPU
//               kernel's adjoint (cdlnet_tpu/kernels/lista2d.py:537-603),
//               with sign(0) = 0 and each mask != 0.
//
// What bounds it on this card: the epilogues' bytes, or fp32 FMAs. The
// design keeps the FMA units fed: each thread owns OT output channels x 8
// output columns in registers (64 accumulators), the input tile with its
// halo and the block's weight slice are staged in shared memory per
// input-channel stage by cp.async (double-buffered, so that one stage's
// copies fly while the previous stage computes), and each (tap) step is 8
// conflict-free input loads + 2 broadcast float4 weight loads for 64 FMAs.
// Every epilogue skips each input phase's structurally zero taps. The sums
// pass through shared memory, so that every epilogue store is coalesced.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "csr_prox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPX = 8;            // output columns per thread (stride kTPX)
constexpr int kTPX = 8;           // threads along a tile row
constexpr int kTW = kPX * kTPX;   // tile width: 64 columns
// The tiling every epilogue runs: 32 output channels x (8 rows x 64
// columns) per block, 8 channels x 8 columns a thread, 2 input channels a
// stage (kAnaOB, kAnaOT, kAnaTH, kAnaIC).
constexpr int kAnaOB = 32, kAnaOT = 8, kAnaTH = 8, kAnaIC = 2;
constexpr int kMaxSmem = 227 * 1024;

// (the numbers of the instantiations lista3d_conv<5>, <6>)
enum Epilogue { kAdjointCsr = 5, kAdjointCsrF2 = 6 };

// Per-(n, o) sums an epilogue reduces per block: dtau and dgam1
// (kAdjointCsr), dtau, dgam1 and dgam2 (kAdjointCsrF2).
__host__ __device__ constexpr int block_sums(int epi) {
  return epi == kAdjointCsrF2 ? 3 : 2;
}

struct ConvArgs {
  const float* in;     // (N, I, D, H, W)
  const float* wt;     // (I, Qd, Qh, Qw, O)
  float* out;          // (N, O, D, H, W)
  const float* z;      // the codes whose support masks dz
  float* u_out;        // unread (the CSR analyses' field before they moved
                       // to lista2d_mma.cuh): kept so that the adjoints'
                       // parameter offsets, and their machine code, stay
  const float* uh;     // CSR adjoint: the stored prox argument v
  float* dzp;          // CSR adjoint: zp's cotangent, accumulated
  float* dza;          // two-sided CSR adjoint: za's cotangent, accumulated
  const float* tau;    // (N, O)
  const float* zp;     // CSR: the neighbour code (N, O, D, H, W)
  const float* za;     // two-sided CSR: the following frame's code
  const float* gam1;   // CSR: (N, O)
  const float* gam2;   // two-sided CSR: (N, O)
  const float* base;   // CSR adjoint: (N, O, D, H, W) or NULL for zeros
  float* part;         // CSR adjoint: (block_sums, D * tiles, N, O)
                       // per-block partials of dtau, dgam1 (, dgam2)
  float alpha;         // CSR adjoint: scale of the correlation
  int N, I, O, D, H, W;
  int Qd, Qh, Qw;
  int od, oh, ow;
  // s > 0: input channel i is stride phase
  // i % (sd * s^2) of a stride-s conv with kernel P and padding pad, the
  // phase index ordered (c, a_d, a_h, a_w), so its weights vanish outside a
  // box of taps per dim, and the box is all the FMAs it needs. sd is the
  // depth stride: s for the 3D convs, 1 for the 2D ones (D = Qd = 1, P[0] =
  // 1, pad[0] = 0: no depth phase, so the phase is i % s^2 in (c, a_h, a_w))
  int s, sd;
  int P[3], pad[3];
};

// Row pitch of the staged input tile: the smallest p >= cols with
// p % 32 == kTPX, so a warp (4 rows x 8 threads) reads 32 distinct banks.
__host__ __device__ inline int row_pitch(int cols) {
  int p = cols;
  while ((p & 31) != kTPX) ++p;
  return p;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// One pipeline buffer (floats): a stage's input tile and weight slice.
__host__ __device__ inline int stage_floats(int Qd, int Qh, int Qw) {
  return round4(kAnaIC * Qd * (kAnaTH + Qh - 1) * row_pitch(kTW + Qw - 1)) +
         round4(kAnaIC * Qd * Qh * Qw * kAnaOB);
}

// Shared memory (floats) of one block: two pipeline buffers, reused
// afterwards for the sums and then the block_sums per-element terms.
template <int EPI>
__host__ __device__ inline int smem_floats(int Qd, int Qh, int Qw) {
  const int bufs = 2 * stage_floats(Qd, Qh, Qw);
  const int red = block_sums(EPI) * kAnaOB * kAnaTH * kTW;
  return bufs > red ? bufs : red;
}

// 4-byte global -> shared copy that bypasses registers; valid == false
// writes a zero (src-size 0), and src must then still be a mapped address.
__device__ inline void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ inline int floordiv(int x, int y) {
  return x >= 0 ? x / y : -((-x + y - 1) / y);
}

// Taps [lo, hi) of one dim whose phase-ph weights can be nonzero: the
// original kernel index s * (q + q0) + ph + p must lie in [0, P).
__device__ inline void tap_box(int s, int ph, int P, int p, int q0, int Q,
                               int& lo, int& hi) {
  lo = max(0, floordiv(-ph - p + s - 1, s) - q0);
  hi = min(Q, floordiv(P - 1 - ph - p, s) - q0 + 1);
}

// One tap's operands: kPX inputs (stride kTPX, conflict-free across the
// warp) and OT weights (two broadcast float4 loads per 8).
template <int OT>
__device__ inline void load_tap(float* x, float* w, const float* xs,
                                const float* ws) {
#pragma unroll
  for (int p = 0; p < kPX; ++p) x[p] = xs[p * kTPX];
#pragma unroll
  for (int j = 0; j < OT; j += 4) {
    const float4 v4 = *reinterpret_cast<const float4*>(ws + j);
    w[j] = v4.x;
    w[j + 1] = v4.y;
    w[j + 2] = v4.z;
    w[j + 3] = v4.w;
  }
}

// kAnaOB output channels per block, kAnaOT per thread, kAnaTH tile rows,
// kAnaIC input channels per stage, two pipeline buffers (the next stage's
// copies overlap this stage's FMAs).
template <int EPI>
__global__ void __launch_bounds__(kThreads)
lista3d_conv(const ConvArgs a) {
  constexpr int OB = kAnaOB, OT = kAnaOT, TH = kAnaTH, stage = kAnaIC;
  static_assert((OB / OT) * TH * kTPX == kThreads, "thread layout");
  static_assert(OT % 4 == 0 && OB % OT == 0, "float4 weight loads");
  static_assert(kThreads % OB == 0 && kThreads / OB <= 32,
                "a power-of-two thread group per output channel");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int T = a.Qd * a.Qh * a.Qw;
  const int rows = TH + a.Qh - 1;
  const int cols = kTW + a.Qw - 1;
  const int pitch = row_pitch(cols);
  const int in_ch = a.Qd * rows * pitch;  // floats per staged channel

  const int tiles_w = (a.W + kTW - 1) / kTW;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int d = blockIdx.y;
  const int o_tiles = (a.O + OB - 1) / OB;
  const int n = blockIdx.z / o_tiles;
  const int o0 = (blockIdx.z % o_tiles) * OB;

  const int tid = threadIdx.x;
  const int tx = tid % kTPX;
  const int ty = (tid / kTPX) % TH;
  const int oc = tid / (kTPX * TH);

  float acc[OT][kPX];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int p = 0; p < kPX; ++p) acc[j][p] = 0.f;

  const size_t plane = (size_t)a.H * a.W;
  const float* in_n = a.in + (size_t)n * a.I * a.D * plane;
  const int buf_floats = stage_floats(a.Qd, a.Qh, a.Qw);
  const int w_off = round4(stage * in_ch);

  // Issue the asynchronous copies of input channels [i0, i0 + stage) into
  // pipeline buffer b: one warp per staged row (channel, depth tap, row),
  // lanes along it, zeros outside the volume; then the weight slice.
  auto issue = [&](int i0, int b) {
    float* s_in = smem + b * buf_floats;
    float* s_w = s_in + w_off;
    const int lines = stage * a.Qd * rows;
    for (int line = tid / 32; line < lines; line += kThreads / 32) {
      const int r = line % rows;
      const int q = (line / rows) % a.Qd;
      const int ci = line / (rows * a.Qd);
      const int i = i0 + ci;
      const int dd = d + q + a.od, hh = h0 + r + a.oh;
      const bool row_ok = i < a.I && dd >= 0 && dd < a.D && hh >= 0 && hh < a.H;
      const float* src =
          row_ok ? in_n + ((size_t)i * a.D + dd) * plane + (size_t)hh * a.W
                 : a.in;
      float* dst = s_in + ci * in_ch + (q * rows + r) * pitch;
      for (int col = tid % 32; col < cols; col += 32) {
        const int ww = w0 + col + a.ow;
        const bool ok = row_ok && ww >= 0 && ww < a.W;
        cp_async4(dst + col, ok ? src + ww : a.in, ok);
      }
    }
    const int w_elems = stage * T * OB;
    for (int e = tid; e < w_elems; e += kThreads) {
      const int t = e / OB;  // ci * T + tap
      const int og = o0 + e % OB;
      const bool ok = i0 + t / T < a.I && og < a.O;
      cp_async4(s_w + e, ok ? a.wt + ((size_t)i0 * T + t) * a.O + og : a.wt,
                ok);
    }
    cp_async_commit();
  };

  // the copies of stage s+1 fly while stage s computes
  issue(0, 0);
  for (int i0 = 0, b = 0; i0 < a.I; i0 += stage, b ^= 1) {
    if (i0 + stage < a.I) {
      issue(i0 + stage, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage s has landed for every thread
    const float* s_in = smem + b * buf_floats;
    const float* s_w = s_in + w_off;

#pragma unroll
    for (int ci = 0; ci < stage; ++ci) {
      const float* xin = s_in + ci * in_ch + ty * pitch + tx;
      const float* wv = s_w + ci * T * OB + oc * OT;
      int qd0 = 0, qd1 = a.Qd, qh0 = 0, qh1 = a.Qh, qw0 = 0, qw1 = a.Qw;
      if (a.s > 0) {  // skip the phase's zero taps
        const int ph = (i0 + ci) % (a.sd * a.s * a.s);
        tap_box(a.sd, ph / (a.s * a.s), a.P[0], a.pad[0], a.od, a.Qd, qd0, qd1);
        tap_box(a.s, ph / a.s % a.s, a.P[1], a.pad[1], a.oh, a.Qh, qh0, qh1);
        tap_box(a.s, ph % a.s, a.P[2], a.pad[2], a.ow, a.Qw, qw0, qw1);
      }
      for (int q = qd0; q < qd1; ++q) {
        for (int r = qh0; r < qh1; ++r) {
          const float* xrow = xin + (q * rows + r) * pitch;
          const float* wrow = wv + (q * a.Qh + r) * a.Qw * OB;
          for (int c = qw0; c < qw1; ++c) {
            float x[kPX], w[OT];
            load_tap<OT>(x, w, xrow + c, wrow + c * OB);
#pragma unroll
            for (int j = 0; j < OT; ++j)
#pragma unroll
              for (int p = 0; p < kPX; ++p)
                acc[j][p] = fmaf(w[j], x[p], acc[j][p]);
          }
        }
      }
    }
    __syncthreads();  // buffer b is free for the copies issued next round
  }

  // the sums -> shared memory (OB, TH, kTW)
  float* red = smem;
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int p = 0; p < kPX; ++p)
      red[((oc * OT + j) * TH + ty) * kTW + tx + p * kTPX] = acc[j][p];
  __syncthreads();

  const int outs = OB * TH * kTW;
  for (int e = tid; e < outs; e += kThreads) {
    const float u = red[e];
    const int col = e % kTW;
    const int r = (e / kTW) % TH;
    const int og = o0 + e / (kTW * TH);
    const int hh = h0 + r, ww = w0 + col;
    const bool inside = og < a.O && hh < a.H && ww < a.W;
    // red[q * outs + e] (this thread's alone) now takes the per-element
    // terms of the block sums (zero outside the volume)
#pragma unroll
    for (int q = 0; q < block_sums(EPI); ++q) red[q * outs + e] = 0.f;
    if (!inside) continue;
    const size_t idx = (((size_t)n * a.O + og) * a.D + d) * plane +
                       (size_t)hh * a.W + ww;
    if (EPI == kAdjointCsr) {
      const float dz = (a.base ? a.base[idx] : 0.f) + a.alpha * u;
      const int no = n * a.O + og;
      float dv, dzp, dtau, dgam;
      prox_csr_adjoint(dz, a.z[idx], a.uh[idx], a.zp[idx], a.tau[no],
                       a.gam1[no], dv, dzp, dtau, dgam);
      a.out[idx] = dv;
      a.dzp[idx] += dzp;
      red[e] = dtau;
      red[outs + e] = dgam;
    } else {  // kAdjointCsrF2
      const float dz = (a.base ? a.base[idx] : 0.f) + a.alpha * u;
      const int no = n * a.O + og;
      float dv, dzp, dza, dtau, dg1, dg2;
      prox_csr_f2_adjoint(dz, a.z[idx], a.uh[idx], a.zp[idx], a.za[idx],
                          a.tau[no], a.gam1[no], a.gam2[no], dv, dzp, dza,
                          dtau, dg1, dg2);
      a.out[idx] = dv;
      a.dzp[idx] += dzp;
      a.dza[idx] += dza;
      red[e] = dtau;
      red[outs + e] = dg1;
      red[2 * outs + e] = dg2;
    }
  }

  // per sum and output channel: TPC threads sum its TH x kTW terms in a
  // fixed order, then a fixed shuffle tree combines them (deterministic)
  __syncthreads();
  constexpr int TPC = kThreads / OB;
  const int per = TH * kTW;
  const int ol = tid / TPC, j = tid % TPC;
  const size_t blocks = (size_t)a.D * gridDim.x;
  const size_t blk = (size_t)d * gridDim.x + blockIdx.x;
#pragma unroll
  for (int q = 0; q < block_sums(EPI); ++q) {
    float sum = 0.f;
    for (int e = j; e < per; e += TPC) sum += red[q * outs + ol * per + e];
#pragma unroll
    for (int off = TPC / 2; off > 0; off >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, off, TPC);
    if (j == 0 && o0 + ol < a.O)
      a.part[((q * blocks + blk) * a.N + n) * a.O + o0 + ol] = sum;
  }
}

template <int EPI>
int launch(const ConvArgs& a, cudaStream_t stream) {
  if (a.N <= 0 || a.I <= 0 || a.O <= 0 || a.D <= 0 || a.H <= 0 || a.W <= 0 ||
      a.Qd <= 0 || a.Qh <= 0 || a.Qw <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)smem_floats<EPI>(a.Qd, a.Qh, a.Qw);
  const int tiles = ((a.W + kTW - 1) / kTW) * ((a.H + kAnaTH - 1) / kAnaTH);
  const int zdim = a.N * ((a.O + kAnaOB - 1) / kAnaOB);
  if (smem > (size_t)kMaxSmem || a.D > 65535 || zdim > 65535)
    return (int)cudaErrorInvalidConfiguration;
  auto kern = lista3d_conv<EPI>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(tiles, a.D, zdim), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
