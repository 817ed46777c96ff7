// Fresnel, microfacet and BSDF math of the path megakernel, per thread.
// Mirrors rene_tpu_torch/ops/{fresnel,microfacet,bsdf}.py, which mirror
// rene_tpu/integrators/pallas_path.py:3528-4130. The plain versions
// evaluate every material under a select; a thread here evaluates only
// the branch of its hit's material, with the same arithmetic.
#pragma once
#include "layout.cuh"
#include "math.cuh"

struct Mat {
  int type;
  float ab[3], eta[3], k[3], ax, ay, ir, op[3], kr2[3], kt2[3], fs[3];
};

__device__ __forceinline__ Mat load_mat(const float* __restrict__ mats,
                                        int id) {
  Mat m;
  const float* r = mats + id * MAT_W;
  m.type = (int)__ldg(r + MAT_TYPE);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m.ab[c] = __ldg(r + MAT_ALBEDO + c);
    m.eta[c] = __ldg(r + MAT_ETA + c);
    m.k[c] = __ldg(r + MAT_K + c);
    m.op[c] = __ldg(r + MAT_OP + c);
    m.kr2[c] = __ldg(r + MAT_KR2 + c);
    m.kt2[c] = __ldg(r + MAT_KT2 + c);
    m.fs[c] = __ldg(r + MAT_FSCALE + c);
  }
  m.ax = __ldg(r + MAT_ALPHA);
  m.ay = __ldg(r + MAT_ALPHA + 1);
  m.ir = __ldg(r + MAT_IR);
  return m;
}

__device__ __forceinline__ bool on3(const float* v) {
  return v[0] != 0.f || v[1] != 0.f || v[2] != 0.f;
}

// ---- Fresnel ---------------------------------------------------------
__device__ __forceinline__ float fr_dielectric(float cos_i, float eta_i,
                                               float eta_t) {
  float c = clampn(cos_i, -1.f, 1.f);
  bool entering = c > 0.f;
  float ei = entering ? eta_i : eta_t;
  float et = entering ? eta_t : eta_i;
  c = fabsf(c);
  float sin_i = sqrtf(clamp_min(1.f - c * c, 0.f));
  float sin_t = ei / et * sin_i;
  float cos_t = sqrtf(clamp_min(1.f - sin_t * sin_t, 0.f));
  float rp = ((et * c) - (ei * cos_t)) / clamp_min((et * c) + (ei * cos_t), 1e-20f);
  float rs = ((ei * c) - (et * cos_t)) / clamp_min((ei * c) + (et * cos_t), 1e-20f);
  return sin_t >= 1.f ? 1.f : 0.5f * (rp * rp + rs * rs);
}

__device__ __forceinline__ float fr_conductor_ch(float c2, float s2, float eta,
                                                 float etk, float c) {
  float eta2 = eta * eta;
  float etk2 = etk * etk;
  float t0 = eta2 - etk2 - s2;
  float a2b2 = sqrtf(clamp_min(t0 * t0 + 4.f * eta2 * etk2, 0.f));
  float t1 = a2b2 + c2;
  float a_ = sqrtf(clamp_min(0.5f * (a2b2 + t0), 0.f));
  float t2 = 2.f * c * a_;
  float rs = (t1 - t2) / clamp_min(t1 + t2, 1e-20f);
  float t3 = c2 * a2b2 + s2 * s2;
  float t4 = t2 * s2;
  float rp = rs * (t3 - t4) / clamp_min(t3 + t4, 1e-20f);
  return 0.5f * (rp + rs);
}

// ---- microfacet distribution (GGX, or Beckmann when `beck`) ------------
__device__ __forceinline__ void cos_sin_phi(float x, float y, float sin_t,
                                            float& cphi, float& sphi) {
  cphi = sin_t == 0.f ? 1.f : clampn(x / clamp_min(sin_t, 1e-20f), -1.f, 1.f);
  sphi = sin_t == 0.f ? 0.f : clampn(y / clamp_min(sin_t, 1e-20f), -1.f, 1.f);
}

__device__ __forceinline__ float mf_d(float ax, float ay, V3 h, bool beck) {
  float c2 = h.z * h.z;
  float s2 = clamp_min(1.f - c2, 0.f);
  float tan2 = s2 / clamp_min(c2, 1e-20f);
  float sin_t = sqrtf(s2);
  float cphi, sphi;
  cos_sin_phi(h.x, h.y, sin_t, cphi, sphi);
  float e = (cphi * cphi / clamp_min(ax * ax, 1e-20f)
             + sphi * sphi / clamp_min(ay * ay, 1e-20f)) * tan2;
  float d;
  if (beck) {
    d = expf(-clamp_max(e, 80.f)) / clamp_min(PI_F * ax * ay * c2 * c2, 1e-30f);
  } else {
    float q = 1.f + e;
    d = 1.f / clamp_min(PI_F * ax * ay * c2 * c2 * (q * q), 1e-30f);
  }
  return tan2 < 3e38f ? d : 0.f;
}

__device__ __forceinline__ float mf_lambda(float ax, float ay, V3 w,
                                           bool beck) {
  float c2 = w.z * w.z;
  float s2 = clamp_min(1.f - c2, 0.f);
  float abs_tan = sqrtf(s2) / clamp_min(fabsf(w.z), 1e-20f);
  float sin_t = sqrtf(s2);
  float cphi, sphi;
  cos_sin_phi(w.x, w.y, sin_t, cphi, sphi);
  float alpha = sqrtf(cphi * cphi * ax * ax + sphi * sphi * ay * ay);
  if (beck) {
    float a = 1.f / clamp_min(alpha * abs_tan, 1e-9f);
    float lam = a >= 1.6f ? 0.f
        : (1.f - 1.259f * a + 0.396f * a * a)
          / clamp_min(3.535f * a + 2.181f * a * a, 1e-9f);
    return abs_tan < 3e38f ? lam : 0.f;
  }
  float at = alpha * abs_tan;
  float at2 = clamp_max(at * at, 1e30f);
  return 0.5f * (-1.f + sqrtf(1.f + at2));
}

__device__ __forceinline__ float wh_pdf(float ax, float ay, V3 wo, V3 h,
                                        float d, bool beck) {
  if (beck) return d * fabsf(h.z);
  float g1o = 1.f / (1.f + mf_lambda(ax, ay, wo, beck));
  return d * g1o * fabsf(dot3(wo, h)) / clamp_min(fabsf(wo.z), 1e-9f);
}

__device__ __forceinline__ V3 sample_wh(float ax, float ay, V3 w, float u1,
                                        float u2, bool beck) {
  bool flip = w.z < 0.f;
  V3 h;
  if (beck) {
    float t = TWO_PI_F * u2;
    float rx = ax * cosf(t);
    float ry = ay * sinf(t);
    float rn = sqrtf(clamp_min(rx * rx + ry * ry, 1e-30f));
    float cphi = rx / rn;
    float sphi = ry / rn;
    float logs = logf(clamp_min(1.f - u1, 1e-9f));
    float tan2 = -logs / clamp_min(cphi * cphi / clamp_min(ax * ax, 1e-20f)
                               + sphi * sphi / clamp_min(ay * ay, 1e-20f), 1e-20f);
    float cz = 1.f / sqrtf(1.f + tan2);
    float sz = sqrtf(clamp_min(1.f - cz * cz, 0.f));
    h = v3(sz * cphi, sz * sphi, cz);
  } else {
    V3 s = flip ? neg(w) : w;
    V3 st = normalize3(v3(ax * s.x, ay * s.y, s.z));
    float cos_t = st.z;
    float r_s = sqrtf(u1 / clamp_min(1.f - u1, 1e-9f));
    float phi_s = TWO_PI_F * u2;
    float spec_x = r_s * cosf(phi_s);
    float spec_y = r_s * sinf(phi_s);
    float cc = clampn(cos_t, -1.f, 1.f);
    float sin_t = sqrtf(clamp_min(1.f - cc * cc, 0.f));
    float tan_t = sin_t / clamp_min(cc, 1e-9f);
    float a0 = 1.f / clamp_min(tan_t, 1e-9f);
    float g1 = 2.f / (1.f + sqrtf(1.f + 1.f / (a0 * a0)));
    float aa = 2.f * u1 / clamp_min(g1, 1e-9f) - 1.f;
    float a2m1 = aa * aa - 1.f;
    float tmp = clamp_max(1.f / (fabsf(a2m1) > 1e-12f ? a2m1 : 1e-12f), 1e10f);
    float bb = tan_t;
    float dd = sqrtf(clamp_min(bb * bb * tmp * tmp - (aa * aa - bb * bb) * tmp,
                           0.f));
    float sl1 = bb * tmp - dd;
    float sl2 = bb * tmp + dd;
    float slope_x = (aa < 0.f || sl2 > a0) ? sl1 : sl2;
    float sflip = u2 > 0.5f ? 1.f : -1.f;
    float u2f = u2 > 0.5f ? 2.f * (u2 - 0.5f) : 2.f * (0.5f - u2);
    float zz = (u2f * (u2f * (u2f * 0.27385f - 0.73369f) + 0.46341f))
        / (u2f * (u2f * (u2f * 0.093073f + 0.309420f) - 1.f) + 0.597999f);
    float slope_y = sflip * zz * sqrtf(1.f + slope_x * slope_x);
    float sin_p = sin_t == 0.f ? 0.f
        : clampn(st.y / clamp_min(sin_t, 1e-20f), -1.f, 1.f);
    float cos_p = sin_t == 0.f ? 1.f
        : clampn(st.x / clamp_min(sin_t, 1e-20f), -1.f, 1.f);
    float sx2 = cos_t > 0.9999f ? spec_x : cos_p * slope_x - sin_p * slope_y;
    float sy2 = cos_t > 0.9999f ? spec_y : sin_p * slope_x + cos_p * slope_y;
    h = normalize3(v3(-ax * sx2, -ay * sy2, 1.f));
  }
  return flip ? neg(h) : h;
}

// ---- BSDF ------------------------------------------------------------
struct BsdfVal {
  float f[3];
  float pdf;
};

__device__ __forceinline__ BsdfVal bsdf_eval(const Mat& m, V3 wo, V3 wi,
                                             bool beck) {
  BsdfVal r = {{0.f, 0.f, 0.f}, 0.f};
  if (!(wo.z * wi.z > 0.f)) return r;
  if (m.type == MAT_MATTE) {
    for (int c = 0; c < 3; ++c) r.f[c] = m.ab[c] * INV_PI_F;
    r.pdf = fabsf(wi.z) * INV_PI_F;
  } else if (m.type == MAT_METAL) {
    V3 h = normalize3(v3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z));
    if (h.z < 0) h = neg(h);
    float d = mf_d(m.ax, m.ay, h, beck);
    float g = 1.f / (1.f + mf_lambda(m.ax, m.ay, wo, beck)
                     + mf_lambda(m.ax, m.ay, wi, beck));
    float ci = fabsf(wi.z), co = fabsf(wo.z);
    float cos_ih = dot3(wi, h);
    float cl = clampn(cos_ih, -1.f, 1.f);
    float c2 = cl * cl;
    float s2 = 1.f - c2;
    float cabs = fabsf(cos_ih);
    float base = d * g / clamp_min(4.f * ci * co, 1e-20f);
    if (!(ci == 0.f || co == 0.f)) {
      for (int c = 0; c < 3; ++c)
        r.f[c] = base * (fr_conductor_ch(c2, s2, m.eta[c], m.k[c], cabs)
                         * m.fs[c]);
    }
    r.pdf = wh_pdf(m.ax, m.ay, wo, h, d, beck)
        / clamp_min(4.f * dot3(wo, h), 1e-20f);
  } else if (m.type == MAT_SUBSTRATE) {
    float awi = fabsf(wi.z), awo = fabsf(wo.z);
    float a = 1.f - 0.5f * awi, b = 1.f - 0.5f * awo;
    float dterm = (float)(28.0 / (23.0 * PI_D))
        * (1.f - (a * a) * (a * a) * a) * (1.f - (b * b) * (b * b) * b);
    V3 h0 = v3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z);
    if (h0.x * h0.x + h0.y * h0.y + h0.z * h0.z < 1e-18f) return r;
    V3 h = normalize3(h0);
    float cos_ih = dot3(wi, h);
    float x = clampn(1.f - cos_ih, 0.f, 1.f);
    float sch = (x * x) * (x * x) * x;
    float d = mf_d(m.ax, m.ay, h, beck);
    float sden = clamp_min(4.f * fabsf(cos_ih) * maxn(awi, awo), 1e-20f);
    for (int c = 0; c < 3; ++c)
      r.f[c] = m.ab[c] * (1.f - m.k[c]) * dterm
          + (m.k[c] + (1.f - m.k[c]) * sch) * d / sden;
    float doh = dot3(wo, h);
    r.pdf = 0.5f * (awi * INV_PI_F + wh_pdf(m.ax, m.ay, wo, h, d, beck)
                    / clamp_min(4.f * doh, 1e-20f));
  } else if (m.type == MAT_PLASTIC || m.type == MAT_UBER) {
    V3 h0 = v3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z);
    bool degen = (h0.x * h0.x + h0.y * h0.y + h0.z * h0.z) < 1e-18f;
    V3 h = normalize3(h0);
    if (h.z < 0) h = neg(h);
    float d = mf_d(m.ax, m.ay, h, beck);
    float g = 1.f / (1.f + mf_lambda(m.ax, m.ay, wo, beck)
                     + mf_lambda(m.ax, m.ay, wi, beck));
    float ci = fabsf(wi.z), co = fabsf(wo.z);
    float cos_ih = dot3(wi, h);
    float base = d * g / clamp_min(4.f * ci * co, 1e-20f);
    bool mic_bad = (ci == 0.f) || (co == 0.f) || degen;
    float doh = dot3(wo, h);
    float pdf_mic = wh_pdf(m.ax, m.ay, wo, h, d, beck) / clamp_min(4.f * doh, 1e-20f);
    bool kd_on = on3(m.ab), ks_on = on3(m.k);
    bool uber = m.type == MAT_UBER;
    float fr = uber ? fr_dielectric(cos_ih, 1.f, m.ir)
                    : fr_dielectric(cos_ih, 1.5f, 1.f);
    float nact = (float)kd_on + (float)ks_on;
    if (uber) nact = nact + (float)on3(m.op) + (float)on3(m.kr2)
        + (float)on3(m.kt2);
    bool mic_ok = ks_on && !mic_bad;
    for (int c = 0; c < 3; ++c)
      r.f[c] = (kd_on ? m.ab[c] * INV_PI_F : 0.f)
          + (mic_ok ? m.k[c] * fr * base : 0.f);
    r.pdf = ((kd_on ? fabsf(wi.z) * INV_PI_F : 0.f)
             + (ks_on ? pdf_mic : 0.f)) / clamp_min(nact, 1.f);
  }
  return r;
}

struct BsdfSample {
  V3 wi;
  float f[3];
  float pdf;
};

__device__ __forceinline__ BsdfSample bsdf_sample(const Mat& m, V3 wo,
                                                  float u_coin, float u1,
                                                  float u2, float ul,
                                                  bool beck) {
  BsdfSample s = {v3(0.f, 0.f, 0.f), {0.f, 0.f, 0.f}, 0.f};
  // cosine-weighted hemisphere on wo's side
  float zc = sqrtf(clamp_min(1.f - u2, 0.f));
  float phi = TWO_PI_F * u1;
  float r2s = sqrtf(u2);
  V3 cw = v3(cosf(phi) * r2s, sinf(phi) * r2s, wo.z < 0.f ? -zc : zc);
  if (m.type == MAT_MATTE) {
    s.wi = cw;
    for (int c = 0; c < 3; ++c) s.f[c] = m.ab[c] * INV_PI_F;
    s.pdf = fabsf(cw.z) * INV_PI_F;
  } else if (m.type == MAT_MIRROR) {
    float inv_c = 1.f / clamp_min(fabsf(wo.z), 1e-9f);
    s.wi = v3(-wo.x, -wo.y, wo.z);
    for (int c = 0; c < 3; ++c) s.f[c] = m.ab[c] * inv_c;
    s.pdf = 1.f;
  } else if (m.type == MAT_GLASS) {
    float fd = fr_dielectric(wo.z, 1.f, m.ir);
    bool take_refl = u_coin < fd;
    float nz_ = wo.z > 0.f ? 1.f : -1.f;
    float eta_ratio = wo.z > 0.f ? 1.f / clamp_min(m.ir, 1e-9f) : m.ir;
    float cos_i = nz_ * wo.z;
    float sin2_t = eta_ratio * eta_ratio * clamp_min(1.f - cos_i * cos_i, 0.f);
    bool ok_t = sin2_t < 1.f;
    float cos_t = sqrtf(clamp_min(1.f - sin2_t, 0.f));
    V3 t = v3(-wo.x * eta_ratio, -wo.y * eta_ratio,
              -wo.z * eta_ratio + (eta_ratio * cos_i - cos_t) * nz_);
    s.wi = take_refl ? v3(-wo.x, -wo.y, wo.z) : t;
    float val = take_refl ? fd / clamp_min(fabsf(wo.z), 1e-9f)
                          : (1.f - fd) / clamp_min(fabsf(s.wi.z), 1e-9f);
    for (int c = 0; c < 3; ++c) s.f[c] = val;
    s.pdf = take_refl ? fd : (ok_t ? 1.f - fd : 0.f);
  } else if (m.type == MAT_METAL || m.type == MAT_SUBSTRATE
             || m.type == MAT_PLASTIC || m.type == MAT_UBER) {
    // half-vector reflection
    V3 h = sample_wh(m.ax, m.ay, wo, u1, u2, beck);
    float doh = dot3(wo, h);
    V3 mr = v3(-wo.x + 2.f * doh * h.x, -wo.y + 2.f * doh * h.y,
               -wo.z + 2.f * doh * h.z);
    bool mic_bad = (wo.z == 0.f) || (doh < 0.f) || (wo.z * mr.z <= 0.f);
    float d = mf_d(m.ax, m.ay, h, beck);
    float pdf_mic = wh_pdf(m.ax, m.ay, wo, h, d, beck) / clamp_min(4.f * doh, 1e-20f);
    if (m.type == MAT_METAL) {
      s.wi = mr;
      if (!mic_bad) {
        BsdfVal e = bsdf_eval(m, wo, mr, beck);
        for (int c = 0; c < 3; ++c) s.f[c] = e.f[c];
        s.pdf = pdf_mic;
      }
    } else if (m.type == MAT_SUBSTRATE) {
      s.wi = u_coin < 0.5f ? cw : mr;
      BsdfVal e = bsdf_eval(m, wo, s.wi, beck);
      for (int c = 0; c < 3; ++c) s.f[c] = e.f[c];
      s.pdf = e.pdf;
    } else {
      float g = 1.f / (1.f + mf_lambda(m.ax, m.ay, wo, beck)
                       + mf_lambda(m.ax, m.ay, mr, beck));
      float ci = fabsf(mr.z), co = fabsf(wo.z);
      float mic_base = d * g / clamp_min(4.f * ci * co, 1e-20f);
      float cos_ih = dot3(mr, h);
      bool kd_on = on3(m.ab), ks_on = on3(m.k);
      float pdf_lam = fabsf(cw.z) * INV_PI_F;
      if (m.type == MAT_PLASTIC) {
        float fr = fr_dielectric(cos_ih, 1.5f, 1.f);
        float nact = (float)kd_on + (float)ks_on;
        float j = floorf(ul * nact);
        bool pick_lam = kd_on && (j == 0.f);
        bool pick_mic = ks_on && (j == (float)kd_on);
        bool ok_mic = pick_mic && !mic_bad;
        for (int c = 0; c < 3; ++c)
          s.f[c] = (pick_lam ? m.ab[c] * INV_PI_F : 0.f)
              + (ok_mic ? m.k[c] * fr * mic_base : 0.f);
        s.pdf = ((pick_lam ? pdf_lam : 0.f) + (ok_mic ? pdf_mic : 0.f))
            / clamp_min(nact, 1.f);
        s.wi = pick_lam ? cw : mr;
      } else {
        float eta = m.ir;
        float fr = fr_dielectric(cos_ih, 1.f, eta);
        bool op_on = on3(m.op), kr_on = on3(m.kr2), kt_on = on3(m.kt2);
        float i0 = (float)op_on, i1 = (float)kd_on, i2 = (float)ks_on;
        float i3 = (float)kr_on, i4 = (float)kt_on;
        float nact = i0 + i1 + i2 + i3 + i4;
        float j = floorf(ul * nact);
        float rank1 = i0, rank2 = rank1 + i1, rank3 = rank2 + i2;
        float rank4 = rank3 + i3;
        bool pick_op = op_on && (j == 0.f);
        bool pick_lam = kd_on && (j == rank1);
        bool pick_mic = ks_on && (j == rank2);
        bool pick_kr = kr_on && (j == rank3);
        bool pick_kt = kt_on && (j == rank4);
        float inv_co = 1.f / clamp_min(fabsf(wo.z), 1e-9f);
        float fr_kr = fr_dielectric(wo.z, 1.f, eta);
        float nz_ = wo.z > 0.f ? 1.f : -1.f;
        float eta_ratio = wo.z > 0.f ? 1.f / clamp_min(eta, 1e-9f) : eta;
        float cos_i = nz_ * wo.z;
        float sin2_t = eta_ratio * eta_ratio * clamp_min(1.f - cos_i * cos_i, 0.f);
        bool ok_t = sin2_t < 1.f;
        float cos_t = sqrtf(clamp_min(1.f - sin2_t, 0.f));
        V3 t = v3(-wo.x * eta_ratio, -wo.y * eta_ratio,
                  -wo.z * eta_ratio + (eta_ratio * cos_i - cos_t) * nz_);
        float fr_kt = fr_dielectric(t.z, 1.f, eta);
        float inv_ct = 1.f / clamp_min(fabsf(t.z), 1e-9f);
        bool ok_mic = pick_mic && !mic_bad;
        bool ok_kt = pick_kt && ok_t;
        s.wi = pick_op ? neg(wo)
            : pick_lam ? cw
            : pick_mic ? mr
            : pick_kr ? v3(-wo.x, -wo.y, wo.z) : t;
        for (int c = 0; c < 3; ++c)
          s.f[c] = (pick_op ? m.op[c] * inv_co : 0.f)
              + (pick_lam ? m.ab[c] * INV_PI_F : 0.f)
              + (ok_mic ? m.k[c] * fr * mic_base : 0.f)
              + (pick_kr ? m.kr2[c] * fr_kr * inv_co : 0.f)
              + (ok_kt ? m.kt2[c] * (1.f - fr_kt) * inv_ct : 0.f);
        s.pdf = ((pick_op || pick_kr) ? 1.f : 0.f)
            + (pick_lam ? pdf_lam : 0.f) + (ok_mic ? pdf_mic : 0.f);
        s.pdf = (s.pdf + (ok_kt ? 1.f : 0.f)) / clamp_min(nact, 1.f);
      }
    }
  }
  return s;
}

// Bsdf::contains(DIFFUSE)
__device__ __forceinline__ bool is_diffuse(const Mat& m) {
  if (m.type == MAT_MATTE || m.type == MAT_METAL || m.type == MAT_SUBSTRATE)
    return true;
  if (m.type == MAT_PLASTIC || m.type == MAT_UBER)
    return on3(m.ab) || on3(m.k);
  return false;
}
