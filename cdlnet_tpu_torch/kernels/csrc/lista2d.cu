// Fused 2D LISTA steps for Hopper (sm_90a).
//
// Replaces the forward of the TPU kernels
// cdlnet_tpu/kernels/lista2d.py::_kernel (the whole-K VMEM-resident 2D
// forward, soft-threshold mode, with the JDD mask and per-image
// thresholds) and lista2d_tiled.py::_kernel_syn_band/_kernel_ana_band (the
// banded pair for images too big for VMEM). On this card one pair with the
// code tensor z in device memory between launches covers every image size,
// so neither the TPU kernel's lane rolls nor its row bands and halos are
// carried over. Every entry point is one stride-1 2D correlation in the
// stride-phase (space-to-depth) domain with a fused epilogue (input channel
// i is phase i % s^2 in the order (c, a_h, a_w)):
//
//   lista2d_ana_threshold: in = r (Cp = C*s^2 channels), out = z (M),
//       z <- ST(z_old - out, tau[n, m]); z_old == NULL reads as zeros (k=0).
//   lista2d_syn_residual:  in = z (M channels), out = r (Cp channels),
//       r <- [mask *] out [- y].
//   lista2d_syn_adjoint: the 2D reverse pass's synthesis adjoint and the
//       soft threshold's subgradient (the TPU reverses K6, K8): the analysis
//       of g (Cp channels) with B's unflipped bank, dz = [base +] alpha *
//       out, dv = 1{z != 0} dz, dtau[n, m] = -sum sign(z) dz.
//   lista2d_ana_csr, lista2d_ana_csrf2: the analysis with the CSR prox in
//       its epilogue instead of ST (the prox modes "csr" and "csrf2" of the
//       TPU kernels, lista2d.py:281-295 and lista2d_tiled.py:189-250):
//       z <- prox_csr(z_old - out, zp; tau, gam) or
//       z <- prox_csr_f2(z_old - out, zp, za; tau, gam1, gam2), with the
//       neighbour-frame codes zp, za (N, M, H, W) read once per output. The
//       synthesis is the ST loop's: CSR changes only the prox. For training
//       they also store the prox argument v = z_old - out to u_out (the
//       TPU kernel's u history rows, lista2d.py:297-313, 343-348), which
//       the CSR adjoints read; serving passes NULL.
//   lista2d_syn_adjoint_csr, lista2d_syn_adjoint_csrf2: the synthesis
//       adjoint with the CSR prox's adjoint in its epilogue (the prox modes
//       "csr" / "csrf2" of the TPU kernel lista2d.py::_kernel_bwd,
//       :537-603): from the stored prox argument v_k and code z_k, the
//       neighbour codes zp (za) and the banks tau, gam1 (gam2) they write
//       dv, add the neighbour codes' cotangents into dzp (dza) in place, and
//       reduce dtau, dgam1 (dgam2) per (n, m) in a fixed order.
//
// The training histories in bf16 (kernels/lista3d.py::hist_dtype; the TPU
// kernel K5's bf16 `hist` rows, its prox modes' u rows too):
// lista2d_ana_threshold, lista2d_ana_csr(f2) and lista2d_syn_residual also
// store their output rounded to nearest even into `hist` (the CSR analyses
// then store the prox argument to a bf16 u_out), lista2d_syn_adjoint reads
// bf16 codes (z_bf16), and lista2d_syn_adjoint_csr(f2) bf16 codes and prox
// arguments (hist_bf16). The iteration itself stays fp32.
//
// Every entry runs on the tensor cores in 3xTF32 (lista2d_mma.cuh says what
// bounds them and how their tiling fills the card at a single 128^2 image):
// the analyses (ST, CSR, and the ST and CSR adjoints) share one mainloop
// and its launch, which lista2d_launch_grid reports beside the synthesis's.
//
// The CSR analyses add one (csr) or two (csrf2) code-sized reads a call.
// At the CSR models' width on a fastMRI frame (M = 169, P = 9, s = 2;
// 640x384 bucketed, a 320x192 code grid) one call is 1.68 GFLOP of
// nonzero-tap FMAs (~0.010 ms as three TF32 products each at 495 TFLOP/s),
// and z_old, z and each neighbour code are 41.5 MB: ~0.025 ms of bytes for
// st, ~0.037 ms for csr and ~0.050 ms for csrf2, so the CSR modes are bound
// by bytes. The prox itself is ~30 flops a code, little beside the 81-tap
// correlation. The CSR adjoints move 7 (csr) or 10 (csrf2) such code
// tensors (base, z, u, the neighbour codes and their cotangents, dv):
// ~0.087 or ~0.124 ms at 3.35 TB/s, bound by bytes too.
//
// Plain C interface for ctypes: each entry returns cudaGetLastError() (or
// the first CUDA error met) as an int; 0 means launched.

#include "lista2d_mma.cuh"

namespace {

// The kernels' arguments: in (N, I, H, W), wt (I, Qh, Qw, O),
// out (N, O, H, W), the 3D layout at D = Qd = 1.
tf32x3::MmaArgs mma_args(const float* in, const float* wt, float* out, int N,
                         int I, int O, int H, int W, int Qh, int Qw, int oh,
                         int ow) {
  tf32x3::MmaArgs a{};
  a.in = in, a.wt = wt, a.out = out;
  a.N = N, a.I = I, a.O = O, a.D = 1, a.H = H, a.W = W;
  a.Qd = 1, a.Qh = Qh, a.Qw = Qw, a.od = 0, a.oh = oh, a.ow = ow;
  a.P[0] = 1, a.pad[0] = 0;
  return a;
}

// The analyses' arguments: mma_args with z_old, tau and the phase map.
tf32x3::MmaArgs analysis_args(const float* r, const float* wt, const float* z_old,
                              const float* tau, float* z_out, int N, int Cp, int M, int H,
                              int W, int Qh, int Qw, int oh, int ow, int s, int Ph, int Pw,
                              int ph, int pw) {
  tf32x3::MmaArgs a = mma_args(r, wt, z_out, N, Cp, M, H, W, Qh, Qw, oh, ow);
  a.z = z_old, a.tau = tau, a.s = s;
  a.P[1] = Ph, a.P[2] = Pw, a.pad[1] = ph, a.pad[2] = pw;
  return a;
}

}  // namespace

extern "C" {

// z_out = ST(z_old - A_k * r, tau): r (N, Cp, H, W); wt (Cp, Qh, Qw, M);
// z_old/z_out (N, M, H, W), z_old may be NULL (zeros) or equal to z_out;
// tau (N, M); hist: NULL, or a bf16 (N, M, H, W) that takes z_out rounded
// to nearest even. s, P, pad: the stride, kernel and padding of the
// strided conv the phase form rewrites (s = 0 runs every tap).
int lista2d_ana_threshold(const float* r, const float* wt, const float* z_old,
                          const float* tau, float* z_out, void* hist, int N, int Cp, int M,
                          int H, int W, int Qh, int Qw, int oh, int ow, int s,
                          int Ph, int Pw, int ph, int pw, void* stream) {
  const tf32x3::MmaArgs a = analysis_args(r, wt, z_old, tau, z_out, N, Cp, M, H, W, Qh, Qw,
                                          oh, ow, s, Ph, Pw, ph, pw);
  return mma2d::launch(false, a, static_cast<__nv_bfloat16*>(hist), (cudaStream_t)stream);
}

// z_out = prox_csr(z_old - A_k * r, zp; tau, gam): as lista2d_ana_threshold,
// with gam (N, M) and the neighbour code zp (N, M, H, W); u_out (N, M, H, W)
// takes the prox argument z_old - A_k * r, or is NULL; hist: NULL (u_out
// fp32), or a bf16 (N, M, H, W) that takes z_out rounded to nearest even,
// and then u_out (or NULL) is bf16 and takes the prox argument rounded.
int lista2d_ana_csr(const float* r, const float* wt, const float* z_old,
                    const float* tau, const float* gam, const float* zp,
                    float* z_out, void* u_out, void* hist, int N, int Cp, int M,
                    int H, int W, int Qh, int Qw, int oh, int ow, int s, int Ph,
                    int Pw, int ph, int pw, void* stream) {
  const tf32x3::MmaArgs a = analysis_args(r, wt, z_old, tau, z_out, N, Cp, M, H, W, Qh, Qw,
                                          oh, ow, s, Ph, Pw, ph, pw);
  return mma2d::launch_csr(
      a, mma2d::CsrArgs{gam, nullptr, zp, nullptr, static_cast<float*>(u_out)}, false,
      static_cast<__nv_bfloat16*>(hist), (cudaStream_t)stream);
}

// z_out = prox_csr_f2(z_old - A_k * r, zp, za; tau, gam1, gam2): the
// two-sided form, with the previous and following frames' codes zp, za;
// u_out and hist as in lista2d_ana_csr.
int lista2d_ana_csrf2(const float* r, const float* wt, const float* z_old,
                      const float* tau, const float* gam1, const float* gam2,
                      const float* zp, const float* za, float* z_out,
                      void* u_out, void* hist, int N, int Cp, int M, int H, int W,
                      int Qh, int Qw, int oh, int ow, int s, int Ph, int Pw, int ph,
                      int pw, void* stream) {
  const tf32x3::MmaArgs a = analysis_args(r, wt, z_old, tau, z_out, N, Cp, M, H, W, Qh, Qw,
                                          oh, ow, s, Ph, Pw, ph, pw);
  return mma2d::launch_csr(
      a, mma2d::CsrArgs{gam1, gam2, zp, za, static_cast<float*>(u_out)}, true,
      static_cast<__nv_bfloat16*>(hist), (cudaStream_t)stream);
}

// r_out = [mask *] B_k^T z [- y]: z (N, M, H, W); wt (M, Qh, Qw, Cp)
// (flipped taps); mask, y (N, Cp, H, W), either may be NULL; hist: NULL, or
// a bf16 (N, Cp, H, W) that takes r_out rounded to nearest even.
int lista2d_syn_residual(const float* z, const float* wt, const float* mask,
                         const float* y, float* r_out, void* hist, int N, int M, int Cp,
                         int H, int W, int Qh, int Qw, int oh, int ow,
                         void* stream) {
  tf32x3::MmaArgs a = mma_args(z, wt, r_out, N, M, Cp, H, W, Qh, Qw, oh, ow);
  a.mask = mask, a.y = y;
  return mma2d::launch(true, a, static_cast<__nv_bfloat16*>(hist), (cudaStream_t)stream);
}

// Blocks whose dtau partials lista2d_syn_adjoint writes: its work buffer
// holds parts * N * M floats (0 where it cannot launch).
int lista2d_syn_adjoint_parts(int N, int Cp, int M, int H, int W, int Qh, int Qw) {
  const tf32x3::MmaArgs a = mma_args(nullptr, nullptr, nullptr, N, Cp, M, H, W, Qh, Qw, 0, 0);
  mma2d::Launch l;
  return mma2d::query(false, a, l) == 0 ? (int)l.grid.x : 0;
}

// dz = [base +] alpha * (B_k^* g); dv = 1{z != 0} dz; dtau = -sum sign(z) dz:
// the analysis of g with B's unflipped bank (2D phase map) and the adjoint
// epilogue. g (N, Cp, H, W); wt (Cp, Qh, Qw, M); base (may be NULL: zeros),
// z, dv (N, M, H, W), z in bf16 where z_bf16 != 0; work (parts, N, M); dtau
// (N, M). s, P, pad as for lista2d_ana_threshold.
int lista2d_syn_adjoint(const float* g, const float* wt, const float* base, const void* z,
                        float* work, float* dv, float* dtau, int N, int Cp, int M, int H,
                        int W, int Qh, int Qw, int oh, int ow, int s, int Ph, int Pw, int ph,
                        int pw, int z_bf16, float alpha, void* stream) {
  const tf32x3::MmaArgs a = analysis_args(g, wt, static_cast<const float*>(z), nullptr, dv, N,
                                          Cp, M, H, W, Qh, Qw, oh, ow, s, Ph, Pw, ph, pw);
  const tf32x3::AdjointArgs e{base, work, alpha};
  return mma2d::launch_adjoint(a, e, dtau, z_bf16 != 0, (cudaStream_t)stream);
}

// Blocks per (n, m) whose partials the CSR adjoints write (the analysis's
// grid: a block a row of 64 positions): their work buffers hold sums *
// parts * N * M floats.
int lista2d_syn_adjoint_csr_parts(int H, int W) {
  return H * ((W + tf32x3::kTW - 1) / tf32x3::kTW);
}

// dz = [base +] alpha * (B_k^* g), then the adjoint of z = prox_csr(v, zp;
// tau, gam) at the stored v = u and z: dv (the cotangent of v), dzp += the
// cotangent of zp, and dtau, dgam (N, M). g (N, Cp, H, W); wt (Cp, Qh, Qw,
// M); base (may be NULL), z, u, zp, dv, dzp (N, M, H, W), z and u bf16
// where hist_bf16 != 0; work (2, parts, N, M), parts =
// lista2d_syn_adjoint_csr_parts(H, W); s, P, pad as for
// lista2d_ana_threshold.
int lista2d_syn_adjoint_csr(const float* g, const float* wt, const float* base, const void* z,
                            const void* u, const float* tau, const float* gam, const float* zp,
                            float* work, float* dv, float* dzp, float* dtau, float* dgam, int N,
                            int Cp, int M, int H, int W, int Qh, int Qw, int oh, int ow, int s,
                            int Ph, int Pw, int ph, int pw, int hist_bf16, float alpha,
                            void* stream) {
  const tf32x3::MmaArgs a = analysis_args(g, wt, static_cast<const float*>(z), tau, dv, N, Cp, M,
                                          H, W, Qh, Qw, oh, ow, s, Ph, Pw, ph, pw);
  float* sums[2] = {dtau, dgam};
  return mma2d::launch_adjoint_csr(
      a, tf32x3::AdjointArgs{base, work, alpha},
      mma2d::CsrArgs{gam, nullptr, zp, nullptr, nullptr, static_cast<const float*>(u), dzp,
                     nullptr},
      false, sums, hist_bf16 != 0, (cudaStream_t)stream);
}

// The two-sided form: the adjoint of z = prox_csr_f2(v, zp, za; tau, gam1,
// gam2); dza (N, M, H, W) += the cotangent of za; work (3, parts, N, M);
// dgam1, dgam2 (N, M); the rest as in lista2d_syn_adjoint_csr.
int lista2d_syn_adjoint_csrf2(const float* g, const float* wt, const float* base, const void* z,
                              const void* u, const float* tau, const float* gam1,
                              const float* gam2, const float* zp, const float* za, float* work,
                              float* dv, float* dzp, float* dza, float* dtau, float* dgam1,
                              float* dgam2, int N, int Cp, int M, int H, int W, int Qh, int Qw,
                              int oh, int ow, int s, int Ph, int Pw, int ph, int pw,
                              int hist_bf16, float alpha, void* stream) {
  const tf32x3::MmaArgs a = analysis_args(g, wt, static_cast<const float*>(z), tau, dv, N, Cp, M,
                                          H, W, Qh, Qw, oh, ow, s, Ph, Pw, ph, pw);
  float* sums[3] = {dtau, dgam1, dgam2};
  return mma2d::launch_adjoint_csr(
      a, tf32x3::AdjointArgs{base, work, alpha},
      mma2d::CsrArgs{gam1, gam2, zp, za, nullptr, static_cast<const float*>(u), dzp, dza}, true,
      sums, hist_bf16 != 0, (cudaStream_t)stream);
}

// The launch that lista2d_syn_residual (synthesis != 0) or the analyses
// (lista2d_ana_threshold, _csr, _csrf2, lista2d_syn_adjoint, _csr, _csrf2)
// make on the
// current device at these sizes (I input and O output channels: M and Cp,
// or Cp and M): out[0..2] its grid; out[3] the codes a block (analysis) or
// the blocks a cluster, which split the codes (synthesis); out[4] the code
// rows a block. Returns 0, or the CUDA error met.
int lista2d_launch_grid(int synthesis, int N, int I, int O, int H, int W,
                        int Qh, int Qw, int* out) {
  const tf32x3::MmaArgs a =
      mma_args(nullptr, nullptr, nullptr, N, I, O, H, W, Qh, Qw, 0, 0);
  mma2d::Launch l;
  const int err = mma2d::query(synthesis != 0, a, l);
  if (err != 0) return err;
  out[0] = (int)l.grid.x, out[1] = (int)l.grid.y, out[2] = (int)l.grid.z;
  out[3] = synthesis ? l.split : l.bn;
  out[4] = l.rows;
  return 0;
}

}  // extern "C"
