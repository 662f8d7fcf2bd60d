// Shading for the kernels that stand in for eager torch shading code
// (csrc/ris.cu, csrc/vertex.cu, csrc/surface.cu): the rounding helpers,
// vec3 arithmetic in torch's order, the shading frame, the sampler's
// draws, the alias pick, the light sample without visibility, and the
// pieces of the Lambertian and GGX lobes that ris.cu and vertex.cu
// evaluate.
//
// Arithmetic: each operation rounded on its own as the eager ops round it
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: nothing is
// contracted into an FMA), sinf / cosf as torch's sin / cos call them, the
// hash on uint32, clamps that keep NaN as torch.clamp keeps it.  A sum over
// a vec3's three components (torch.sum over the last axis on the card)
// takes torch's order: its reduction gives the row to two threads, one
// summing elements 0 and 2, the other element 1, then adds the two; its
// accumulators start at +0, so a sum is never -0.  A Python float operand
// is the nearest f32 of the double (torch rounds a scalar so), and
// ``1.0 / x`` on a tensor is torch's reciprocal times 1.0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace shading {

constexpr int kMatLambertian = 0;
constexpr int kMatMetallic = 1;
constexpr int kMatDielectric = 2;
constexpr double kPi = 3.14159265358979323846;
constexpr double kInvPi = 1.0 / kPi;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
// torch's ``1.0 / x``: reciprocal(x) * 1.0
__device__ __forceinline__ float rcp(float x) { return mul(div(1.0f, x), 1.0f); }

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
// torch.sqrt(torch.clamp(x, min=0))
__device__ __forceinline__ float sqrt0(float x) { return __fsqrt_rn(clamp_min(x, 0.0f)); }

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void store3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}
__device__ __forceinline__ V3 vneg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 vadd(V3 a, V3 b) { return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)}; }
__device__ __forceinline__ V3 vsub(V3 a, V3 b) { return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)}; }
__device__ __forceinline__ V3 vmul(V3 a, V3 b) { return {mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z)}; }
__device__ __forceinline__ V3 vscale(V3 a, float s) { return {mul(a.x, s), mul(a.y, s), mul(a.z, s)}; }
__device__ __forceinline__ V3 vdiv(V3 a, float s) { return {div(a.x, s), div(a.y, s), div(a.z, s)}; }

// torch.sum over the last axis of a [N, 3] tensor on the card: (x + z) + y,
// never -0 (its accumulators start at +0)
__device__ __forceinline__ float sum3(V3 p) { return add(add(add(p.x, p.z), p.y), 0.0f); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return sum3(vmul(a, b)); }
__device__ __forceinline__ float length(V3 a) { return sqrt0(dot(a, a)); }
__device__ __forceinline__ V3 normalize(V3 a) {
  return vdiv(a, clamp_min(length(a), (float)1e-12));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}
__device__ __forceinline__ float luminance(V3 c) {
  return add(add(mul((float)0.2126, c.x), mul((float)0.7152, c.y)), mul((float)0.0722, c.z));
}

// utils/math.py::local_ref_matrix: the frame (t, b, n)
struct Frame {
  V3 t, b;
};

__device__ __forceinline__ Frame local_frame(V3 n) {
  const V3 up = fabsf(n.y) > (float)0.9999 ? V3{0.0f, 0.0f, 1.0f} : V3{0.0f, 1.0f, 0.0f};
  Frame f;
  f.b = normalize(cross(n, up));
  f.t = cross(f.b, n);
  return f;
}

// t * x + b * y + n * z
__device__ __forceinline__ V3 to_world(const Frame& f, V3 n, float x, float y, float z) {
  return vadd(vadd(vscale(f.t, x), vscale(f.b, y)), vscale(n, z));
}

// ---- the sampler (sampling/rng.py) ----

// utils/math.py::utilhash on uint32
__device__ __forceinline__ uint32_t utilhash(uint32_t a) {
  a = (a + 0x7ED55D16u) + (a << 12);
  a = (a ^ 0xC761C23Cu) ^ (a >> 19);
  a = (a + 0x165667B1u) + (a << 5);
  a = (a + 0xD3A2646Cu) ^ (a << 9);
  a = (a + 0xFD7046C5u) + (a << 3);
  a = (a ^ 0xB55A4F09u) ^ (a >> 16);
  return a;
}

// u32_to_unit: f32(bits) * 2^-32
__device__ __forceinline__ float unit(uint32_t bits) {
  return mul(__uint2float_rn(bits), 2.3283064365386963e-10f);
}

// what the draw at dimension ``p`` of the wavefront's pointer mixes into a
// lane's scramble: the Sobol table's word at the clamped pointer, or in the
// hash mode (no table) the salt, (p * 0x9E3779B9) & 0xFFFFFFFF.  The mode is
// a template argument: testing the table's pointer at run time instead cost
// the RIS kernel 3.5% of its time on an H100.
template <bool kHash>
__device__ __forceinline__ uint32_t draw_word(long long p, const long long* sobol,
                                              long long sobol_len) {
  if (kHash) return (uint32_t)(unsigned long long)p * 0x9E3779B9u;
  return (uint32_t)sobol[min(max(p, 0LL), sobol_len - 1)];
}

// rng.sample_1d for one lane: the number, then the scramble hashed on
template <bool kHash>
__device__ __forceinline__ float draw(uint32_t word, uint32_t& scr) {
  const float r = unit(kHash ? utilhash(scr ^ word) : (word ^ scr));
  scr = utilhash(scr);
  return r;
}

// sampling/alias.py::alias_sample over a table of n buckets
__device__ __forceinline__ int alias_pick(const float* prob, const int* alias, int n, float r1,
                                          float r2) {
  const int idx = min(__float2int_rz(mul(r1, (float)n)), n - 1);
  return r2 < prob[idx] ? idx : alias[idx];
}

// ---- lights (scene/device_scene.py) ----

// utils/math.py::triangle_normal
__device__ __forceinline__ V3 triangle_normal(V3 v0, V3 v1, V3 v2) {
  return normalize(cross(vsub(v1, v0), vsub(v2, v0)));
}

// an area light's record: vertices, normal, radiance
struct Light {
  V3 v0, v1, v2, normal, radiance;
};

// area light ``l`` read from the scene's tables, its normal computed with
// the plain version's operations
__device__ __forceinline__ Light light_from_scene(const float* tri_v, const int* light_prim,
                                                  const float* light_radiance, int l) {
  const float* v = tri_v + (size_t)__ldg(light_prim + l) * 9;
  Light L;
  L.v0 = {__ldg(v + 0), __ldg(v + 1), __ldg(v + 2)};
  L.v1 = {__ldg(v + 3), __ldg(v + 4), __ldg(v + 5)};
  L.v2 = {__ldg(v + 6), __ldg(v + 7), __ldg(v + 8)};
  L.normal = triangle_normal(L.v0, L.v1, L.v2);
  const float* r = light_radiance + (size_t)l * 3;
  L.radiance = {__ldg(r + 0), __ldg(r + 1), __ldg(r + 2)};
  return L;
}

// what a light sample reads besides the area lights' records: the light
// alias table (its last bucket the env map's, when there is one), 1 / sum
// of power, and the env map's texels (at its offset in the atlas), alias
// table and size
struct Lights {
  const float* prob;
  const int* alias;
  int n_alias, n_area;
  bool has_env, single_sided;
  float slpi;
  const float* env_prob;
  const int* env_alias;
  const float* env_texels;
  int n_env, env_w;
  float env_wf, env_hf;
};

__device__ __forceinline__ Lights lights_of(const float* prob, const int* alias, int n_alias,
                                            int n_area, int has_env, int single_sided,
                                            const float* sum_light_power_inv,
                                            const float* env_prob, const int* env_alias,
                                            const float* tex_data, const int* tex_offset,
                                            const int* tex_width, const int* tex_height,
                                            int n_env, int env_tex) {
  Lights s;
  s.prob = prob;
  s.alias = alias;
  s.n_alias = n_alias;
  s.n_area = n_area;
  s.has_env = has_env != 0;
  s.single_sided = single_sided != 0;
  s.slpi = (n_area > 0 || has_env) ? *sum_light_power_inv : 0.0f;
  s.env_prob = env_prob;
  s.env_alias = env_alias;
  s.n_env = n_env;
  s.env_texels = tex_data;
  s.env_w = 1;
  s.env_wf = s.env_hf = 1.0f;
  if (has_env) {
    s.env_w = tex_width[env_tex];
    s.env_texels = tex_data + 3 * (size_t)tex_offset[env_tex];
    s.env_wf = __int2float_rn(s.env_w);
    s.env_hf = __int2float_rn(tex_height[env_tex]);
  }
  return s;
}

struct LightSample {
  V3 li, wi;
  float dist, pdf;  // pdf <= 0: no sample
};

// device_scene.py::sample_direct_light_no_vis for one lane at ``pos`` with
// the draws r[0..3]: the light pick, then a uniform point of the area
// light's triangle, its radiance, distance and direction, the pdf
// (luminance x 2 pi x 1 / sum of power, area to solid angle) and the
// single-sided facing test; or the env map's texel (its own alias pick, the
// texel's centre through to_sphere, dist 1e6, the env pdf).  ``light_at(l)``
// gives area light l's record.
template <class LightAt>
__device__ __forceinline__ LightSample sample_light(const Lights& s, LightAt light_at, V3 pos,
                                                    const float* r) {
  LightSample out = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f, -1.0f};
  if (s.n_area == 0 && !s.has_env) return out;
  const int light_id = alias_pick(s.prob, s.alias, s.n_alias, r[0], r[1]);
  if (s.has_env && light_id == s.n_area) {
    // _sample_env_map
    const int pix = alias_pick(s.env_prob, s.env_alias, s.n_env, r[2], r[3]);
    const int y = pix / s.env_w;
    const int x = pix - y * s.env_w;
    out.li = v3(s.env_texels + 3 * (size_t)pix);
    const float phi = mul(div(add(__int2float_rn(x), 0.5f), s.env_wf), (float)(2.0 * kPi));
    const float theta = mul(div(add(__int2float_rn(y), 0.5f), s.env_hf), (float)kPi);
    const float sin_t = sinf(theta);
    out.wi = {mul(cosf(phi), sin_t), cosf(theta), mul(sinf(phi), sin_t)};
    out.dist = 1e6f;
    out.pdf = mul(mul(mul(mul(mul(luminance(out.li), s.slpi), s.env_wf), s.env_hf),
                      (float)(kInvPi * kInvPi)), 0.5f);
  } else if (s.n_area > 0) {
    const Light L = light_at(min(max(light_id, 0), s.n_area - 1));
    // sample_triangle_uniform
    const float sq = __fsqrt_rn(r[3]);
    const float u = sub(1.0f, sq);
    const float v = mul(r[2], sq);
    const float bw = sub(sub(1.0f, u), v);
    const V3 sampled = vadd(vadd(vscale(L.v1, u), vscale(L.v2, v)), vscale(L.v0, bw));
    const V3 to = vsub(sampled, pos);
    const float d2 = dot(to, to);
    out.dist = sqrt0(d2);
    out.wi = vdiv(to, clamp_min(out.dist, (float)1e-12));
    out.li = L.radiance;
    const float pdf_area = mul(mul(luminance(out.li), (float)(2.0 * kPi)), s.slpi);
    // pdf_area_to_solid_angle(pdf_area, pos, sampled, normal): its
    // pos - sampled is -to, so its squared length is d2 and its
    // normalized direction -wi, bit for bit
    const float cos_l = dot(L.normal, vneg(out.wi));
    out.pdf = div(mul(pdf_area, d2), clamp_min(fabsf(cos_l), (float)1e-12));
    if (s.single_sided && !(cos_l > (float)1e-6)) out.pdf = -1.0f;
  }
  return out;
}

// ---- BSDFs (bsdf/materials.py) ----

// _lambertian_eval / _lambertian_pdf's factor
__device__ __forceinline__ float lambert(float c) { return mul(c, (float)kInvPi); }

// schlick_g with a = alpha * 0.5
__device__ __forceinline__ float schlick_g(float c, float a, float one_minus_a) {
  return div(c, add(mul(c, one_minus_a), a));
}

// what a lane's GGX lobe holds for any wi: alpha = roughness^2 and its
// square, schlick_g's a and 1 - a, cos_o = dot(n, wo), the view side's
// Smith term schlick_g(|cos_o|)
struct Ggx {
  float alpha, alpha2, a, one_minus_a, cos_o, g_o;
};

__device__ __forceinline__ Ggx ggx_lane(float roughness, V3 n, V3 wo) {
  Ggx g;
  g.alpha = mul(roughness, roughness);
  g.alpha2 = mul(g.alpha, g.alpha);
  g.a = mul(g.alpha, 0.5f);
  g.one_minus_a = sub(1.0f, g.a);
  g.cos_o = dot(n, wo);
  g.g_o = schlick_g(fabsf(g.cos_o), g.a, g.one_minus_a);
  return g;
}

// _metallic_eval at wi up to the base colour: h = normalize(wo + wi), hw =
// dot(h, wo), the distribution d = ggx_distribution(dot(n, h)), the
// Fresnel power t = pow5(max(1 - hw, 0)), the specular term g d / max(4
// cos_i cos_o, 1e-12), and whether the lobe is zero (cos_i cos_o < 1e-7)
struct GgxEval {
  float hw, d, t, spec;
  bool zero;
};

__device__ __forceinline__ GgxEval ggx_eval(const Ggx& g, V3 n, V3 wo, V3 wi) {
  GgxEval e;
  const V3 h = normalize(vadd(wo, wi));
  const float cos_i = dot(n, wi);
  e.hw = dot(h, wo);
  const float x = clamp_min(sub(1.0f, e.hw), 0.0f);
  const float x2 = mul(x, x);
  e.t = mul(mul(x2, x2), x);
  const float nh = dot(n, h);
  const float denom = add(mul(mul(nh, nh), sub(g.alpha2, 1.0f)), 1.0f);
  e.d = div(g.alpha2, clamp_min(mul(mul(denom, denom), (float)kPi), (float)1e-12));
  if (nh < (float)1e-6) e.d = 0.0f;
  const float gg = mul(g.g_o, schlick_g(fabsf(cos_i), g.a, g.one_minus_a));
  e.spec = div(mul(gg, e.d), clamp_min(mul(mul(4.0f, cos_i), g.cos_o), (float)1e-12));
  e.zero = mul(cos_i, g.cos_o) < (float)1e-7;
  return e;
}

// one channel of _metallic_eval: f0 = 0.08 + (c - 0.08) metallic, the
// Schlick Fresnel f, c / pi (1 - metallic) (1 - f) + spec f
__device__ __forceinline__ float ggx_channel(const GgxEval& e, float c, float metallic) {
  const float f0 = add((float)0.08, mul(sub(c, (float)0.08), metallic));
  const float f = add(f0, mul(sub(1.0f, f0), e.t));
  const float diffuse = mul(lambert(c), sub(1.0f, metallic));
  return add(mul(diffuse, sub(1.0f, f)), mul(e.spec, f));
}

}  // namespace shading
