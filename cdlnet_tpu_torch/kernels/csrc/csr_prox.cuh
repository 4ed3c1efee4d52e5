// The CSR models' proxes and their adjoints, elementwise, for the Hopper
// kernels (sm_90a): the epilogues of lista2d_mma.cuh's CSR analyses and CSR
// synthesis adjoints. The expressions and their order are those of
// core/ops.py::prox_csr / prox_csr_f2 and of the TPU kernel's prox modes
// (cdlnet_tpu/kernels/lista2d.py:283-295, and its adjoint at :537-603),
// with sign(0) = 0; the soft threshold is the ST kernels' too.

#pragma once

#include <cuda_runtime.h>

namespace {

// Three-way sign (0 at 0, as jnp.sign and torch.sign) and soft threshold.
__device__ inline float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}
__device__ inline float soft(float x, float t) {
  const float m = fmaxf(fabsf(x) - t, 0.f);
  return x > 0.f ? m : (x < 0.f ? -m : 0.f);  // sign(x) * m
}

// core/ops.py::prox_csr(v, zp, tau, gam)
__device__ inline float prox_csr(float v, float zp, float tau, float gam) {
  const float shift = zp + tau * sgn(zp);
  return soft(soft(v - shift, tau * gam) + shift, tau);
}

// core/ops.py::prox_csr_f2(v, zp, za, tau, g1, g2). It jumps where v
// crosses Ca (corr flips sign), as the reference's does.
__device__ inline float prox_csr_f2(float v, float zp, float za, float tau,
                                    float g1, float g2) {
  const float Ca = zp + tau * sgn(zp) + tau * g2 * sgn(zp - za);
  const float Cb = za + tau * sgn(za) + tau * g1 * sgn(za - zp);
  const float inner = soft(v - Ca, g1 * tau);
  const float corr = tau * g1 * sgn(v - Ca);
  const float midder = soft(inner - Cb + corr, g2 * tau);
  return soft(midder + Cb - corr, tau);
}

// The adjoint of z = prox_csr(v, zp, tau, gam) at the stored v and z for the
// cotangent dz (the TPU kernel's, cdlnet_tpu/kernels/lista2d.py:548-563):
// dv, and the cotangents of zp, tau and gam.
__device__ inline void prox_csr_adjoint(float dz, float z, float v, float zp,
                                        float tau, float gam, float& dv,
                                        float& dzp, float& dtau,
                                        float& dgam) {
  const float gw = z != 0.f ? dz : 0.f;
  const float s_o = sgn(z);
  const float s_zp = sgn(zp);
  const float shift = zp + tau * s_zp;
  const float inner = soft(v - shift, tau * gam);
  const float m_i = inner != 0.f ? 1.f : 0.f;
  const float s_i = sgn(inner);
  dv = gw * m_i;
  dzp = gw * (1.f - m_i);
  dtau = -s_o * gw + s_zp * dzp - gam * s_i * dv;
  dgam = -tau * s_i * dv;
}

// The adjoint of z = prox_csr_f2(v, zp, za, tau, g1, g2) at the stored v and
// z (lista2d.py:564-603): dv, and the cotangents of zp, za, tau, g1, g2.
__device__ inline void prox_csr_f2_adjoint(float dz, float z, float v,
                                           float zp, float za, float tau,
                                           float g1, float g2, float& dv,
                                           float& dzp, float& dza,
                                           float& dtau, float& dg1,
                                           float& dg2) {
  const float gw = z != 0.f ? dz : 0.f;
  const float s_o = sgn(z);
  const float s_zp = sgn(zp), s_za = sgn(za);
  const float s_pa = sgn(zp - za);
  const float s_ap = -s_pa;
  const float Ca = zp + tau * s_zp + tau * g2 * s_pa;
  const float Cb = za + tau * s_za + tau * g1 * s_ap;
  const float uCa = v - Ca;
  const float s_uca = sgn(uCa);
  const float inner = soft(uCa, g1 * tau);
  const float m_i = inner != 0.f ? 1.f : 0.f;
  const float s_i = sgn(inner);
  const float corr = tau * g1 * s_uca;
  const float midder = soft(inner - Cb + corr, g2 * tau);
  const float m_m = midder != 0.f ? 1.f : 0.f;
  const float s_m = sgn(midder);
  dtau = -s_o * gw;
  const float gx = gw * m_m;  // on (inner - Cb + corr)
  dtau += -g2 * s_m * gx;
  dg2 = -tau * s_m * gx;
  const float g_i = gx * m_i;  // on (v - Ca)
  dtau += -g1 * s_i * g_i;
  dg1 = -tau * s_i * g_i;
  dv = g_i;
  const float dCa = -g_i;
  const float dcorr = gx - gw;
  dtau += g1 * s_uca * dcorr;
  dg1 += tau * s_uca * dcorr;
  const float dCb = gw - gx;
  dzp = dCa;
  dtau += (s_zp + g2 * s_pa) * dCa;
  dg2 += tau * s_pa * dCa;
  dza = dCb;
  dtau += (s_za + g1 * s_ap) * dCb;
  dg1 += tau * s_ap * dCb;
}

}  // namespace
