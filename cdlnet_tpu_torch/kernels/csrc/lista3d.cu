// Fused 3D LISTA steps for Hopper (sm_90a), on the tensor cores in 3xTF32.
//
// Replaces the TPU kernels cdlnet_tpu/kernels/lista3d.py::_kernel_resident
// (K1, the whole-K forward) and its per-iteration pair _kernel_syn /
// _kernel_ana (K3), the banded lista3d_tiled.py pair (K9) and the depth-ring
// kernels of lista3d_ring.py (K11); the synthesis is also the reverse pass's
// analysis adjoint (K10, K12). Both entry points below are one stride-1 3D
// correlation in the stride-phase (space-to-depth) domain followed by a
// fused epilogue, run as an implicit GEMM on mma.sync TF32 products with
// every operand split into two TF32 parts, so that a call keeps the fp32
// contract (lista3d_mma.cuh, which also says what bounds them and how the
// design answers it):
//
//   lista3d_ana_threshold: in = r (Cp channels), out = z (M channels),
//       z <- ST(z_old - out, tau[n, m]); z_old == NULL reads as zeros (k=0).
//   lista3d_syn_residual:  in = z (M channels), out = r (Cp channels),
//       r <- [mask *] out [- y].
//   lista3d_syn_adjoint: the reverse pass's synthesis adjoint and the soft
//       threshold's subgradient (the TPU reverses K2, K4, K10, K12): the
//       analysis of g (Cp channels) with B's unflipped bank, dz = [base +]
//       alpha * out, dv = 1{z != 0} dz, dtau[n, m] = -sum sign(z) dz.
//
// The training histories in bf16 (the JAX package's default, its
// hist_dtype; kernels/lista3d.py::hist_dtype here): the forward pair's
// `hist` also takes its output rounded to nearest even as bf16 (the TPU
// kernels' bf16 history stores, K1's and the ring's), with the fp32 output
// still the iteration's carry; the adjoint reads bf16 codes z (z_bf16).
//
// Plain C interface for ctypes: each entry returns cudaGetLastError() (or
// the first CUDA error met) as an int; 0 means launched.

#include "lista3d_mma.cuh"

extern "C" {

// z_out = ST(z_old - A_k * r, tau): r (N, Cp, D, H, W); wt (Cp, Qd, Qh, Qw,
// M); z_old/z_out (N, M, D, H, W), z_old may be NULL (zeros) or equal to
// z_out (each output reads only its own z element); tau (N, M); hist: NULL,
// or a bf16 (N, M, D, H, W) that takes z_out rounded to nearest even. s, P,
// pad: the stride, kernel and padding of the strided conv the phase form
// rewrites (s = 0 runs every tap).
int lista3d_ana_threshold(const float* r, const float* wt, const float* z_old,
                          const float* tau, float* z_out, void* hist, int N, int Cp, int M,
                          int D, int H, int W, int Qd, int Qh, int Qw, int od,
                          int oh, int ow, int s, int Pd, int Ph, int Pw,
                          int pd, int ph, int pw, void* stream) {
  mma3d::MmaArgs a{};
  a.in = r, a.wt = wt, a.out = z_out, a.z = z_old, a.tau = tau;
  a.N = N, a.I = Cp, a.O = M, a.D = D, a.H = H, a.W = W;
  a.Qd = Qd, a.Qh = Qh, a.Qw = Qw, a.od = od, a.oh = oh, a.ow = ow;
  a.s = s, a.P[0] = Pd, a.P[1] = Ph, a.P[2] = Pw;
  a.pad[0] = pd, a.pad[1] = ph, a.pad[2] = pw;
  return mma3d::launch(false, a, static_cast<__nv_bfloat16*>(hist), (cudaStream_t)stream);
}

// r_out = [mask *] B_k^T z [- y]: z (N, M, D, H, W); wt (M, Qd, Qh, Qw, Cp)
// (flipped taps); mask, y (N, Cp, D, H, W), either may be NULL; hist: NULL,
// or a bf16 (N, Cp, D, H, W) that takes r_out rounded to nearest even.
int lista3d_syn_residual(const float* z, const float* wt, const float* mask,
                         const float* y, float* r_out, void* hist, int N, int M, int Cp,
                         int D, int H, int W, int Qd, int Qh, int Qw, int od,
                         int oh, int ow, void* stream) {
  mma3d::MmaArgs a{};
  a.in = z, a.wt = wt, a.out = r_out, a.mask = mask, a.y = y;
  a.N = N, a.I = M, a.O = Cp, a.D = D, a.H = H, a.W = W;
  a.Qd = Qd, a.Qh = Qh, a.Qw = Qw, a.od = od, a.oh = oh, a.ow = ow;
  return mma3d::launch(true, a, static_cast<__nv_bfloat16*>(hist), (cudaStream_t)stream);
}

// Blocks whose dtau partials lista3d_syn_adjoint writes: its work buffer
// holds parts * N * M floats.
int lista3d_syn_adjoint_parts(int N, int Cp, int M, int D, int H, int W, int Qd, int Qh,
                              int Qw) {
  mma3d::MmaArgs a{};
  a.N = N, a.I = Cp, a.O = M, a.D = D, a.H = H, a.W = W, a.Qd = Qd, a.Qh = Qh, a.Qw = Qw;
  return mma3d::adjoint_parts(a);
}

// dz = [base +] alpha * (B_k^* g); dv = 1{z != 0} dz; dtau = -sum sign(z) dz:
// the analysis of g with B's unflipped bank and the adjoint epilogue. g (N,
// Cp, D, H, W); wt (Cp, Qd, Qh, Qw, M); base (may be NULL: zeros), z, dv (N,
// M, D, H, W), z in bf16 where z_bf16 != 0; work (parts, N, M); dtau (N, M).
// s, P, pad as for lista3d_ana_threshold.
int lista3d_syn_adjoint(const float* g, const float* wt, const float* base, const void* z,
                        float* work, float* dv, float* dtau, int N, int Cp, int M, int D,
                        int H, int W, int Qd, int Qh, int Qw, int od, int oh, int ow, int s,
                        int Pd, int Ph, int Pw, int pd, int ph, int pw, int z_bf16, float alpha,
                        void* stream) {
  mma3d::MmaArgs a{};
  a.in = g, a.wt = wt, a.out = dv, a.z = static_cast<const float*>(z);
  a.N = N, a.I = Cp, a.O = M, a.D = D, a.H = H, a.W = W;
  a.Qd = Qd, a.Qh = Qh, a.Qw = Qw, a.od = od, a.oh = oh, a.ow = ow;
  a.s = s, a.P[0] = Pd, a.P[1] = Ph, a.P[2] = Pw;
  a.pad[0] = pd, a.pad[1] = ph, a.pad[2] = pw;
  const tf32x3::AdjointArgs e{base, work, alpha};
  return mma3d::launch_adjoint(a, e, dtau, z_bf16 != 0, (cudaStream_t)stream);
}

}  // extern "C"
