// The reverse pass of the fused 3D LISTA for Hopper (sm_90a), fp32 on the
// CUDA cores.
//
// Replaces the TPU kernels cdlnet_tpu/kernels/lista3d_bwd_resident.py::
// _kernel_bwd_resident (the whole-K reverse) and its per-iteration pair
// lista3d_bwd.py::_kernel_syn_bwd/_kernel_ana_bwd. The reverse loop runs
// one iteration at a time from the stored code and residual histories, in
// the stride-phase domain of the forward (kernels/lista3d_bwd.py), on three
// kernels: the forward's lista3d_syn_residual (the analysis adjoint
// m * A_k^T dv, with A's flipped bank), and the two entry points here:
//
//   lista3d_syn_adjoint: the synthesis adjoint and the soft-threshold
//       subgradient, dz = [base +] alpha * B_k^* g (the analysis-form
//       correlation of lista3d_conv.cuh with B's unflipped bank); writes
//       dv = 1{z != 0} dz and dtau[n, m] = -sum sign(z) dz. The 2D reverse
//       pass (kernels/lista2d_bwd.py, in place of the TPU kernels
//       lista2d.py::_kernel_bwd and lista2d_tiled_bwd.py::_kernel_tiled_bwd)
//       calls it at D = Qd = 1 with the 2D phase map, sd = 1.
//   lista2d_syn_adjoint_csr, lista2d_syn_adjoint_csrf2: the 2D synthesis
//       adjoint with the CSR prox's adjoint in its epilogue instead of the
//       soft threshold's (the prox modes "csr" / "csrf2" of the TPU kernel
//       lista2d.py::_kernel_bwd, :537-603): from the stored prox argument
//       v_k and code z_k, the neighbour codes zp (za) and the banks tau,
//       gam1 (gam2) it writes dv, adds the neighbour codes' cotangents
//       into dzp (dza) in place, and reduces dtau, dgam1 (dgam2) per
//       (n, m) in a fixed order. The two-sided adjoint reads u, z, zp, za,
//       base and dzp, dza and writes dv, dzp, dza: at the CSR models'
//       training shape (M = 169, a 320x184 code grid) ~400 MB a call,
//       ~0.12 ms of bytes at 3.35 TB/s against ~0.025 ms of FMAs, so it is
//       bound by bytes, and the fused epilogue reads dz from registers
//       instead of a second pass over it. Its shared-memory partials take
//       three (N, M) sums a block: 192 KB of the 227 KB cap at P = 9 (one
//       block an SM).
//   lista3d_wgrad: the weight gradient of one correlation,
//       dw[i, q, o] = alpha * sum_{n,p} x[n, i, p + q + off] y[n, o, p],
//       in the banks' own (I, Qd, Qh, Qw, O) layout; dA (x = r, y = dv) and
//       dB (x = z, y = g) alike. It reads no phase map, so the 2D reverse
//       pass runs it at D = Qd = 1 as it is.
//
// What bounds them on this card: fp32 FMAs, as in the forward. At the
// flagship training shape (N=2, M=169, Cp=8, 8x64x64 code grid, 4x4x3
// phase taps) each call is ~8.5 GFLOP in the phase form, while its
// operands are 2-45 MB. The adjoint shares the forward analysis's design
// and tap skipping. The weight gradient is a reduction over all 65,536
// code positions for each of 64,896 outputs: an implicit-im2col GEMM whose
// block owns a 128 x 64 output tile in registers (8 x 4 per thread, three
// float4 operand loads per 32 FMAs) and one contiguous split of the
// positions, so that ~500 blocks fill the card; each split writes its own
// partial tile, and a second kernel sums the splits in ascending order. No
// float atomics: two runs give bitwise-equal gradients. At the flagship 2D
// training shape (N=10 crops of 128^2, M=169, Cp=4, 4x4 phase taps) an
// adjoint call is ~0.7 GFLOP against ~83 MB of codes, base and dv: there it
// is bound by bytes.
//
// Plain C interface for ctypes: each entry returns cudaGetLastError() (or
// the first CUDA error met) as an int; 0 means launched.

#include <algorithm>

#include "lista3d_conv.cuh"

namespace {

// out[r] = alpha * sum_{b < nb} part[b * rows + r], b ascending.
__global__ void reduce_parts(const float* part, float* out, int rows, int nb,
                             float alpha) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += part[(size_t)b * rows + r];
  out[r] = alpha * s;
}

int launch_reduce(const float* part, float* out, int rows, int nb,
                  float alpha, cudaStream_t stream) {
  reduce_parts<<<(rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part, out, rows, nb, alpha);
  return (int)cudaGetLastError();
}

struct WgradArgs {
  const float* x;  // (N, I, D, H, W)
  const float* y;  // (N, O, D, H, W)
  float* part;     // (splits, I, Qd, Qh, Qw, O)
  int N, I, O, D, H, W;
  int Qd, Qh, Qw;
  int od, oh, ow;
  int chunk;       // code positions per split, a multiple of BK
};

// Block: output rows (i, q) [m0, m0 + BM) x output channels [o0, o0 + BN)
// over the code positions of split blockIdx.z; BK positions per step. The
// x operand is gathered tap-shifted from x (implicit im2col, zeros outside
// the volume), the y operand read as it is; both are staged in shared
// memory position-major, so each step's operands are float4 loads.
template <int BM, int BN, int TM, int TN, int BK>
__global__ void __launch_bounds__(kThreads)
lista3d_wgrad_part(const WgradArgs a) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "thread layout");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 operand loads");
  static_assert(kThreads % BK == 0, "each thread stages one position");
  constexpr int XP = BM + 4, YP = BN + 4;  // pitches: rows stay 16B-aligned
  // a thread's TM rows are TM/4 runs of 4, RG * 4 rows apart, so that a
  // warp's float4 loads of one run are contiguous (conflict-free)
  constexpr int RG = BM / TM;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // (BK, XP)
  float* ys = xs + BK * XP;                      // (BK, YP)
  int* rinfo = reinterpret_cast<int*>(ys + BK * YP);  // (BM,)

  const int tid = threadIdx.x;
  const int T = a.Qd * a.Qh * a.Qw;
  const int rows = a.I * T;
  const int m0 = blockIdx.x * BM, o0 = blockIdx.y * BN;
  const int plane = a.H * a.W, vol = a.D * plane;
  const int P = a.N * vol;
  const int p_begin = blockIdx.z * a.chunk;
  const int p_end = min(P, p_begin + a.chunk);

  // the tile's rows as packed (i, qd, qh, qw), -1 past the last row
  for (int m = tid; m < BM; m += kThreads) {
    const int row = m0 + m;
    int info = -1;
    if (row < rows) {
      const int q = row % T;
      info = (row / T) << 12 | (q / (a.Qh * a.Qw)) << 8 |
             (q / a.Qw % a.Qh) << 4 | q % a.Qw;
    }
    rinfo[m] = info;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int kk = tid % BK;  // the position this thread stages each step
  __syncthreads();

  for (int p0 = p_begin; p0 < p_end; p0 += BK) {
    const int p = p0 + kk;
    const bool pok = p < p_end;
    const int n = p / vol, d = p / plane % a.D, h = p / a.W % a.H,
              w = p % a.W;
    for (int m = tid / BK; m < BM; m += kThreads / BK) {
      const int info = rinfo[m];
      float v = 0.f;
      if (pok && info >= 0) {
        const int dd = d + (info >> 8 & 15) + a.od;
        const int hh = h + (info >> 4 & 15) + a.oh;
        const int ww = w + (info & 15) + a.ow;
        if (dd >= 0 && dd < a.D && hh >= 0 && hh < a.H && ww >= 0 &&
            ww < a.W)
          v = a.x[((size_t)n * a.I + (info >> 12)) * vol +
                  (size_t)dd * plane + hh * a.W + ww];
      }
      xs[kk * XP + m] = v;
    }
    for (int c = tid / BK; c < BN; c += kThreads / BK) {
      const int o = o0 + c;
      ys[kk * YP + c] =
          pok && o < a.O
              ? a.y[((size_t)n * a.O + o) * vol + (size_t)d * plane +
                    h * a.W + w]
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float xv[TM], yv[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(xs + k * XP + i * RG + ty * 4);
        xv[i] = v4.x, xv[i + 1] = v4.y, xv[i + 2] = v4.z, xv[i + 3] = v4.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(ys + k * YP + tx * TN + j);
        yv[j] = v4.x, yv[j + 1] = v4.y, yv[j + 2] = v4.z, yv[j + 3] = v4.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = a.part + (size_t)blockIdx.z * rows * a.O;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + i / 4 * RG * 4 + ty * 4 + i % 4;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o < a.O) out[(size_t)row * a.O + o] = acc[i][j];
    }
  }
}

// The tile: 128 rows (i, q) x 64 output channels a block, 8 x 4 a thread;
// 32 code positions a step. (The reverse pass calls it with O = M only: a
// dB is computed as the adjoint bank of the same product with x and y
// swapped, kernels/lista3d_bwd.py.)
constexpr int kBM = 128, kBN = 64, kTM = 8, kTN = 4, kBK = 32;

constexpr size_t kWgradSmem =
    sizeof(float) * ((size_t)kBK * (kBM + 4) + kBK * (kBN + 4) + kBM);

// Code positions a split takes: enough splits for ~4 blocks per SM, each
// at least 16 steps long; a multiple of kBK.
inline int wgrad_chunk(int rows, int O, int P) {
  const int tiles = ((rows + kBM - 1) / kBM) * ((O + kBN - 1) / kBN);
  int splits = (4 * 132 + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, (P + 16 * kBK - 1) / (16 * kBK)));
  const int chunk = (P + splits - 1) / splits;
  return (chunk + kBK - 1) / kBK * kBK;
}

// The adjoint's operands shared by the two CSR entry points (2D, D = 1).
ConvArgs csr_adjoint_args(const float* g, const float* wt, const float* base,
                          const float* z, const float* u, const float* tau,
                          const float* zp, float* work, float* dv, float* dzp,
                          int N, int Cp, int M, int H, int W, int Qh, int Qw,
                          int oh, int ow, int s, int Ph, int Pw, int ph,
                          int pw, float alpha) {
  ConvArgs a{};
  a.in = g, a.wt = wt, a.out = dv, a.z = z, a.uh = u, a.base = base;
  a.tau = tau, a.zp = zp, a.dzp = dzp, a.part = work, a.alpha = alpha;
  a.N = N, a.I = Cp, a.O = M, a.D = 1, a.H = H, a.W = W;
  a.Qd = 1, a.Qh = Qh, a.Qw = Qw, a.od = 0, a.oh = oh, a.ow = ow;
  a.s = s, a.sd = 1, a.P[0] = 1, a.P[1] = Ph, a.P[2] = Pw;
  a.pad[0] = 0, a.pad[1] = ph, a.pad[2] = pw;
  return a;
}

// The block partials of `sums` (N, M) sums in work, summed in order into
// outs[q].
int reduce_sums(const float* work, float* const* outs, int sums, int N, int M,
                int parts, cudaStream_t stream) {
  for (int q = 0; q < sums; ++q) {
    const int err = launch_reduce(work + (size_t)q * parts * N * M, outs[q],
                                  N * M, parts, 1.f, stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Blocks per (n, m) whose dtau partials lista3d_syn_adjoint writes: its
// work buffer holds parts * N * M floats.
int lista3d_syn_adjoint_parts(int D, int H, int W) {
  return D * ((W + kTW - 1) / kTW) * ((H + kAnaTH - 1) / kAnaTH);
}

// dz = [base +] alpha * (B_k^* g); dv = 1{z != 0} dz; dtau = -sum sign(z) dz.
// g (N, Cp, D, H, W); wt (Cp, Qd, Qh, Qw, M) (B's unflipped phase bank);
// base, z, dv (N, M, D, H, W), base may be NULL (zeros); work (parts, N, M);
// dtau (N, M). s, P, pad as for lista3d_ana_threshold; sd is the phase
// map's depth stride: s for video, 1 for images (D = Qd = 1, Pd = 1).
int lista3d_syn_adjoint(const float* g, const float* wt, const float* base,
                        const float* z, float* work, float* dv, float* dtau,
                        int N, int Cp, int M, int D, int H, int W, int Qd,
                        int Qh, int Qw, int od, int oh, int ow, int s, int sd,
                        int Pd, int Ph, int Pw, int pd, int ph, int pw,
                        float alpha, void* stream) {
  ConvArgs a{};
  a.in = g, a.wt = wt, a.out = dv, a.z = z, a.base = base, a.part = work;
  a.alpha = alpha;
  a.N = N, a.I = Cp, a.O = M, a.D = D, a.H = H, a.W = W;
  a.Qd = Qd, a.Qh = Qh, a.Qw = Qw, a.od = od, a.oh = oh, a.ow = ow;
  a.s = s, a.sd = sd, a.P[0] = Pd, a.P[1] = Ph, a.P[2] = Pw;
  a.pad[0] = pd, a.pad[1] = ph, a.pad[2] = pw;
  const int err = launch<kAdjoint>(a, (cudaStream_t)stream);
  if (err != 0) return err;
  return launch_reduce(work, dtau, N * M, lista3d_syn_adjoint_parts(D, H, W),
                       1.f, (cudaStream_t)stream);
}

// dz = [base +] alpha * (B_k^* g), then the adjoint of z = prox_csr(v, zp;
// tau, gam) at the stored v = u and z: dv (the cotangent of v), dzp += the
// cotangent of zp, and dtau, dgam (N, M). g (N, Cp, H, W); wt (Cp, Qh, Qw,
// M); base (may be NULL), z, u, zp, dv, dzp (N, M, H, W); work (2, parts,
// N, M), parts = lista3d_syn_adjoint_parts(1, H, W); s, P, pad as for
// lista2d_ana_threshold.
int lista2d_syn_adjoint_csr(const float* g, const float* wt, const float* base,
                            const float* z, const float* u, const float* tau,
                            const float* gam, const float* zp, float* work,
                            float* dv, float* dzp, float* dtau, float* dgam,
                            int N, int Cp, int M, int H, int W, int Qh, int Qw,
                            int oh, int ow, int s, int Ph, int Pw, int ph,
                            int pw, float alpha, void* stream) {
  ConvArgs a = csr_adjoint_args(g, wt, base, z, u, tau, zp, work, dv, dzp, N,
                                Cp, M, H, W, Qh, Qw, oh, ow, s, Ph, Pw, ph, pw,
                                alpha);
  a.gam1 = gam;
  const int err = launch<kAdjointCsr>(a, (cudaStream_t)stream);
  if (err != 0) return err;
  float* outs[2] = {dtau, dgam};
  return reduce_sums(work, outs, 2, N, M, lista3d_syn_adjoint_parts(1, H, W),
                     (cudaStream_t)stream);
}

// The two-sided form: the adjoint of z = prox_csr_f2(v, zp, za; tau, gam1,
// gam2); dza (N, M, H, W) += the cotangent of za; work (3, parts, N, M);
// dgam1, dgam2 (N, M); the rest as in lista2d_syn_adjoint_csr.
int lista2d_syn_adjoint_csrf2(const float* g, const float* wt,
                              const float* base, const float* z,
                              const float* u, const float* tau,
                              const float* gam1, const float* gam2,
                              const float* zp, const float* za, float* work,
                              float* dv, float* dzp, float* dza, float* dtau,
                              float* dgam1, float* dgam2, int N, int Cp, int M,
                              int H, int W, int Qh, int Qw, int oh, int ow,
                              int s, int Ph, int Pw, int ph, int pw,
                              float alpha, void* stream) {
  ConvArgs a = csr_adjoint_args(g, wt, base, z, u, tau, zp, work, dv, dzp, N,
                                Cp, M, H, W, Qh, Qw, oh, ow, s, Ph, Pw, ph, pw,
                                alpha);
  a.gam1 = gam1, a.gam2 = gam2, a.za = za, a.dza = dza;
  const int err = launch<kAdjointCsrF2>(a, (cudaStream_t)stream);
  if (err != 0) return err;
  float* outs[3] = {dtau, dgam1, dgam2};
  return reduce_sums(work, outs, 3, N, M, lista3d_syn_adjoint_parts(1, H, W),
                     (cudaStream_t)stream);
}

// Splits of the code positions lista3d_wgrad runs: its work buffer holds
// splits * I * T * O floats (T = Qd * Qh * Qw taps, P = N * D * H * W).
int lista3d_wgrad_splits(int I, int T, int O, int P) {
  if (I <= 0 || T <= 0 || O <= 0 || P <= 0) return -1;
  const int chunk = wgrad_chunk(I * T, O, P);
  return (P + chunk - 1) / chunk;
}

// dw[i, q, o] = alpha * sum_{n,p} x[n, i, p + q + off] y[n, o, p]: x (N, I,
// D, H, W); y (N, O, D, H, W); work (splits, I * T * O); dw (I, Qd, Qh, Qw,
// O); off = (od, oh, ow).
int lista3d_wgrad(const float* x, const float* y, float* work, float* dw,
                  int N, int I, int O, int D, int H, int W, int Qd, int Qh,
                  int Qw, int od, int oh, int ow, float alpha, void* stream) {
  const long long P = (long long)N * D * H * W;
  if (N <= 0 || I <= 0 || O <= 0 || D <= 0 || H <= 0 || W <= 0 || Qd <= 0 ||
      Qh <= 0 || Qw <= 0)
    return (int)cudaErrorInvalidValue;
  // packed row info: 4 bits a tap index; 32-bit position and element indices
  if (Qd > 16 || Qh > 16 || Qw > 16 || I >= (1 << 19) ||
      P * (I > O ? I : O) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int T = Qd * Qh * Qw, rows = I * T;
  const WgradArgs a{x,  y,  work, N,  I,  O,  D,  H, W,
                    Qd, Qh, Qw,   od, oh, ow, wgrad_chunk(rows, O, (int)P)};
  const int splits = ((int)P + a.chunk - 1) / a.chunk;
  const dim3 grid((rows + kBM - 1) / kBM, (O + kBN - 1) / kBN, splits);
  if (grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  auto kern = lista3d_wgrad_part<kBM, kBN, kTM, kTN, kBK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgradSmem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, kWgradSmem, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(work, dw, rows * O, splits, alpha, (cudaStream_t)stream);
}

}  // extern "C"
