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

extern "C" {

// z_out = ST(z_old - A_k * r, tau): r (N, Cp, H, W); wt (Cp, Qh, Qw, M);
// z_old/z_out (N, M, H, W), z_old may be NULL (zeros) or equal to z_out;
// tau (N, M). s, P, pad: the stride, kernel and padding of the strided
// conv the phase form rewrites (s = 0 runs every tap).
int lista2d_ana_threshold(const float* r, const float* wt, const float* z_old,
                          const float* tau, float* z_out, int N, int Cp, int M,
                          int H, int W, int Qh, int Qw, int oh, int ow, int s,
                          int Ph, int Pw, int ph, int pw, void* stream) {
  ConvArgs a{};
  a.in = r, a.wt = wt, a.out = z_out, a.z = z_old, a.tau = tau;
  a.N = N, a.I = Cp, a.O = M, a.D = 1, a.H = H, a.W = W;
  a.Qd = 1, a.Qh = Qh, a.Qw = Qw, a.od = 0, a.oh = oh, a.ow = ow;
  a.s = s, a.sd = 1, a.P[0] = 1, a.P[1] = Ph, a.P[2] = Pw;
  a.pad[0] = 0, a.pad[1] = ph, a.pad[2] = pw;
  return launch<kAnaOB, kAnaOT, kAnaTH, 1, kAnaIC, 1, 2, kAnalysis>(
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
