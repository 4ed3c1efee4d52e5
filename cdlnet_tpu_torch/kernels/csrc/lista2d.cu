// Fused 2D LISTA steps for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the forward of the TPU kernels
// cdlnet_tpu/kernels/lista2d.py::_kernel (the whole-K VMEM-resident 2D
// forward, soft-threshold mode, with the JDD mask and per-image
// thresholds) and lista2d_tiled.py::_kernel_syn_band/_kernel_ana_band (the
// banded pair for images too big for VMEM). On this card one pair with the
// code tensor z in device memory between launches covers every image size,
// so neither the TPU kernel's lane rolls nor its row bands and halos are
// carried over. Both entry points are one stride-1 2D correlation in the
// stride-phase (space-to-depth) domain with a fused epilogue: the 3D
// template of lista3d_conv.cuh run with D = 1, Qd = 1 and the 2D phase map
// (sd = 1: input channel i is phase i % s^2 in the order (c, a_h, a_w)):
//
//   lista2d_ana_threshold: in = r (Cp = C*s^2 channels), out = z (M),
//       z <- ST(z_old - out, tau[n, m]); z_old == NULL reads as zeros (k=0).
//   lista2d_syn_residual:  in = z (M channels), out = r (Cp channels),
//       r <- [mask *] out [- y].
//   lista2d_ana_csr, lista2d_ana_csrf2: the analysis with the CSR prox in
//       its epilogue instead of ST (the prox modes "csr" and "csrf2" of the
//       TPU kernels, lista2d.py:281-295 and lista2d_tiled.py:189-250):
//       z <- prox_csr(z_old - out, zp; tau, gam) or
//       z <- prox_csr_f2(z_old - out, zp, za; tau, gam1, gam2), with the
//       neighbour-frame codes zp, za (N, M, H, W) read once per output. The
//       synthesis is the ST loop's: CSR changes only the prox. For training
//       they also store the prox argument v = z_old - out to u_out (the
//       TPU kernel's u history rows, lista2d.py:297-313, 343-348), which
//       the CSR adjoints of lista3d_bwd.cu read; serving passes NULL.
//
// The CSR epilogues add one (csr) or two (csrf2) code-sized reads a call.
// At the CSR models' width on a fastMRI frame (M = 169, P = 9, s = 2;
// 640x384 bucketed, a 320x192 code grid) one call is 1.68 GFLOP of
// nonzero-tap FMAs (~0.025 ms at the fp32 peak), and z_old, z and each
// neighbour code are 41.5 MB: ~0.025 ms of bytes for st, ~0.037 ms for csr
// and ~0.050 ms for csrf2, so the CSR modes are bound by bytes. The prox
// itself is ~30 flops a code, little beside the 81-tap correlation.
//
// What bounds them on this card: at the flagship 2D shape (M=169, Cp=4,
// 4x4 phase taps) one call at a 128^2 image is ~68 MFLOP of nonzero-tap
// FMAs (~1 us at the fp32 peak) against ~5.5 MB of codes (~1.7 us at
// 3.35 TB/s): each call is tiny, so the 2K launches per image are bound by
// launch latency and by how few blocks a 64x64 code grid gives, not by
// FMAs; at 512^2 the calls are 16x larger. The design is the 3D one (its
// header says how it keeps the FMA units fed); the synthesis takes 4 phase
// channels per block, the 2D Cp, instead of the 3D kernel's 8.
//
// Plain C interface for ctypes: each entry returns cudaGetLastError() (or
// the first CUDA error met) as an int; 0 means launched.

#include "lista3d_conv.cuh"

namespace {

// The analysis arguments shared by the three analysis entry points.
ConvArgs ana_args(const float* r, const float* wt, const float* z_old,
                  const float* tau, float* z_out, int N, int Cp, int M, int H,
                  int W, int Qh, int Qw, int oh, int ow, int s, int Ph, int Pw,
                  int ph, int pw) {
  ConvArgs a{};
  a.in = r, a.wt = wt, a.out = z_out, a.z = z_old, a.tau = tau;
  a.N = N, a.I = Cp, a.O = M, a.D = 1, a.H = H, a.W = W;
  a.Qd = 1, a.Qh = Qh, a.Qw = Qw, a.od = 0, a.oh = oh, a.ow = ow;
  a.s = s, a.sd = 1, a.P[0] = 1, a.P[1] = Ph, a.P[2] = Pw;
  a.pad[0] = 0, a.pad[1] = ph, a.pad[2] = pw;
  return a;
}

}  // namespace

extern "C" {

// z_out = ST(z_old - A_k * r, tau): r (N, Cp, H, W); wt (Cp, Qh, Qw, M);
// z_old/z_out (N, M, H, W), z_old may be NULL (zeros) or equal to z_out;
// tau (N, M). s, P, pad: the stride, kernel and padding of the strided
// conv the phase form rewrites (s = 0 runs every tap).
int lista2d_ana_threshold(const float* r, const float* wt, const float* z_old,
                          const float* tau, float* z_out, int N, int Cp, int M,
                          int H, int W, int Qh, int Qw, int oh, int ow, int s,
                          int Ph, int Pw, int ph, int pw, void* stream) {
  const ConvArgs a = ana_args(r, wt, z_old, tau, z_out, N, Cp, M, H, W, Qh,
                              Qw, oh, ow, s, Ph, Pw, ph, pw);
  return launch<kAnaOB, kAnaOT, kAnaTH, 1, kAnaIC, 1, 2, kAnalysis>(
      a, (cudaStream_t)stream);
}

// z_out = prox_csr(z_old - A_k * r, zp; tau, gam): as lista2d_ana_threshold,
// with gam (N, M) and the neighbour code zp (N, M, H, W), not z_out; u_out
// (N, M, H, W) takes the prox argument z_old - A_k * r, or is NULL.
int lista2d_ana_csr(const float* r, const float* wt, const float* z_old,
                    const float* tau, const float* gam, const float* zp,
                    float* z_out, float* u_out, int N, int Cp, int M, int H,
                    int W, int Qh, int Qw, int oh, int ow, int s, int Ph,
                    int Pw, int ph, int pw, void* stream) {
  ConvArgs a = ana_args(r, wt, z_old, tau, z_out, N, Cp, M, H, W, Qh, Qw, oh,
                        ow, s, Ph, Pw, ph, pw);
  a.gam1 = gam, a.zp = zp, a.u_out = u_out;
  return launch<kAnaOB, kAnaOT, kAnaTH, 1, kAnaIC, 1, 2, kAnalysisCsr>(
      a, (cudaStream_t)stream);
}

// z_out = prox_csr_f2(z_old - A_k * r, zp, za; tau, gam1, gam2): the
// two-sided form, with the previous and following frames' codes zp, za;
// u_out as in lista2d_ana_csr.
int lista2d_ana_csrf2(const float* r, const float* wt, const float* z_old,
                      const float* tau, const float* gam1, const float* gam2,
                      const float* zp, const float* za, float* z_out,
                      float* u_out, int N, int Cp, int M, int H, int W, int Qh,
                      int Qw, int oh, int ow, int s, int Ph, int Pw, int ph,
                      int pw, void* stream) {
  ConvArgs a = ana_args(r, wt, z_old, tau, z_out, N, Cp, M, H, W, Qh, Qw, oh,
                        ow, s, Ph, Pw, ph, pw);
  a.gam1 = gam1, a.gam2 = gam2, a.zp = zp, a.za = za, a.u_out = u_out;
  return launch<kAnaOB, kAnaOT, kAnaTH, 1, kAnaIC, 1, 2, kAnalysisCsrF2>(
      a, (cudaStream_t)stream);
}

// r_out = [mask *] B_k^T z [- y]: z (N, M, H, W); wt (M, Qh, Qw, Cp)
// (flipped taps); mask, y (N, Cp, H, W), either may be NULL.
int lista2d_syn_residual(const float* z, const float* wt, const float* mask,
                         const float* y, float* r_out, int N, int M, int Cp,
                         int H, int W, int Qh, int Qw, int oh, int ow,
                         void* stream) {
  ConvArgs a{};
  a.in = z, a.wt = wt, a.out = r_out, a.mask = mask, a.y = y;
  a.N = N, a.I = M, a.O = Cp, a.D = 1, a.H = H, a.W = W;
  a.Qd = 1, a.Qh = Qh, a.Qw = Qw, a.od = 0, a.oh = oh, a.ow = ow;
  // 4 phase channels x (4 rows x 64 columns) per block; 8 groups of one warp
  // each take every 8th code channel, summed in shared memory; two blocks
  // split the code channels (atomicAdd into a zeroed output: with two
  // addends the sum does not depend on their order)
  return launch<4, 4, 4, 8, 1, 2, 1, kSynthesis>(a, (cudaStream_t)stream);
}

}  // extern "C"
