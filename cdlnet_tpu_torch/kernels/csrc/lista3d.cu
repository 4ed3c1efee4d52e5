// Fused 3D LISTA steps for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernels cdlnet_tpu/kernels/lista3d.py::_kernel_resident
// (the whole-K forward) and its per-iteration pair _kernel_syn/_kernel_ana.
// Both entry points below are one stride-1 3D correlation in the
// stride-phase (space-to-depth) domain followed by a fused epilogue
// (lista3d_conv.cuh, which also says what bounds them and how the design
// answers it):
//
//   lista3d_ana_threshold: in = r (Cp channels), out = z (M channels),
//       z <- ST(z_old - out, tau[n, m]); z_old == NULL reads as zeros (k=0).
//   lista3d_syn_residual:  in = z (M channels), out = r (Cp channels),
//       r <- [mask *] out [- y].
//
// Plain C interface for ctypes: each entry returns cudaGetLastError() (or
// the first CUDA error met) as an int; 0 means launched.

#include "lista3d_conv.cuh"

extern "C" {

// z_out = ST(z_old - A_k * r, tau): r (N, Cp, D, H, W); wt (Cp, Qd, Qh, Qw,
// M); z_old/z_out (N, M, D, H, W), z_old may be NULL (zeros) or equal to
// z_out (each output reads only its own z element); tau (N, M). s, P, pad:
// the stride, kernel and padding of the strided conv the phase form
// rewrites (s = 0 runs every tap).
int lista3d_ana_threshold(const float* r, const float* wt, const float* z_old,
                          const float* tau, float* z_out, int N, int Cp, int M,
                          int D, int H, int W, int Qd, int Qh, int Qw, int od,
                          int oh, int ow, int s, int Pd, int Ph, int Pw,
                          int pd, int ph, int pw, void* stream) {
  ConvArgs a{};
  a.in = r, a.wt = wt, a.out = z_out, a.z = z_old, a.tau = tau;
  a.N = N, a.I = Cp, a.O = M, a.D = D, a.H = H, a.W = W;
  a.Qd = Qd, a.Qh = Qh, a.Qw = Qw, a.od = od, a.oh = oh, a.ow = ow;
  a.s = s, a.sd = s, a.P[0] = Pd, a.P[1] = Ph, a.P[2] = Pw;
  a.pad[0] = pd, a.pad[1] = ph, a.pad[2] = pw;
  return launch<kAnaOB, kAnaOT, kAnaTH, 1, kAnaIC, 1, 2, kAnalysis>(
      a, (cudaStream_t)stream);
}

// r_out = [mask *] B_k^T z [- y]: z (N, M, D, H, W); wt (M, Qd, Qh, Qw, Cp)
// (flipped taps); mask, y (N, Cp, D, H, W), either may be NULL.
int lista3d_syn_residual(const float* z, const float* wt, const float* mask,
                         const float* y, float* r_out, int N, int M, int Cp,
                         int D, int H, int W, int Qd, int Qh, int Qw, int od,
                         int oh, int ow, void* stream) {
  ConvArgs a{};
  a.in = z, a.wt = wt, a.out = r_out, a.mask = mask, a.y = y;
  a.N = N, a.I = M, a.O = Cp, a.D = D, a.H = H, a.W = W;
  a.Qd = Qd, a.Qh = Qh, a.Qw = Qw, a.od = od, a.oh = oh, a.ow = ow;
  // 8 phase channels x (4 rows x 64 columns) per block; 8 groups of one warp
  // each take every 8th code channel, summed in shared memory; two blocks
  // split the code channels, one pipeline buffer each, so that two blocks
  // (16 warps) share an SM
  return launch<8, 8, 4, 8, 1, 2, 1, kSynthesis>(a, (cudaStream_t)stream);
}

}  // extern "C"
