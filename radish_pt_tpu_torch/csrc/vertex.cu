// One vertex of the path tracer's bounce for Hopper (sm_90a): the two-sided
// shading normal, next-event estimation's light sample, BSDF evaluation and
// MIS weight, then the BSDF sample and the throughput update, for every lane
// of the wavefront in one launch.  The shadow test of NEE's segment is not
// in it: the caller runs the scene's occlusion kernel on the segments this
// kernel writes, as before, and zeroes the contribution where it is blocked.
//
// Replaces no Pallas kernel: the JAX package runs the vertex as XLA code
// (radish_pt_tpu/render/pathtrace.py::_nee_contrib and _bsdf_advance), and
// the port ran it as 415 (Lambertian only) to 808 (with GGX) eager torch
// operations over the whole wavefront
// (radish_pt_tpu_torch/render/pathtrace.py::vertex_plain, which stays the
// plain version).  Per lane, in the plain version's order:
//   * wo = -ray_d; the shading normal flipped toward wo for a material that
//     is not a dielectric;
//   * 4 draws (sampling/rng.py), the light sample without visibility
//     (shading.cuh::sample_light: area lights, the env map), and ok =
//     pdf > 0, active, not a dielectric, wi above the shading normal's
//     horizon; the shadow segment pos -> pos + wi * dist;
//   * where ok: bsdf_eval and bsdf_pdf at wi (Lambertian, MetallicWorkflow
//     with the lane's base colour; every other type 0), the power
//     heuristic, and the contribution throughput * f * li * sat_dot(n, wi)
//     / max(pdf, 1e-12) * mis_w as if unoccluded; elsewhere 0;
//   * 3 draws and bsdf_sample: Lambertian (cosine hemisphere),
//     MetallicWorkflow (GGX VNDF or the cosine direction, chosen against
//     1 / (2 - metallic)), Dielectric (exact Fresnel: reflect or refract);
//     every other type an invalid sample; a lobe that ``mat_types`` leaves
//     out gives an invalid sample and a zero eval, as in the plain version;
//   * the lane dies on an invalid sample or pdf < 1e-8; throughput *= bsdf
//     * (1 for a delta sample, else |dot(n, dir)|) / max(pdf, 1e-12).
// Inactive lanes draw and compute as the plain version's do (their outputs
// are the plain version's too), so the sampler state stays in step.  The
// arithmetic is the plain version's, operation for operation, each rounded
// on its own (csrc/shading.cuh, shared with csrc/ris.cu).
//
// Bound on the card: bytes.  A lane reads 73 bytes (position, normal,
// direction, throughput, active, the material's type, base colour, the
// scramble), 8 more on a MetallicWorkflow lane (metallic, roughness) and 4
// on a dielectric one (ior), and writes 63 (segment end, ok, contribution,
// scramble, active, throughput, direction, pdf, delta): at 800x800 with
// every lane Lambertian, 87 MB, 0.026 ms at 3.35 TB/s, against ~600
// operations a lane (0.012 ms at the f32 instruction rate, 33.5 T/s).  The design keeps every
// intermediate in registers: one thread a lane, 256-thread blocks, each
// input read once and each output written once; the 7 draws' Sobol words
// are the same address for every lane (one broadcast load each); the light
// records and alias tables are read through the read-only cache (a few KB,
// L1/L2-resident).  The launch is on the caller's stream, reads the
// sampler's pointer on the card (a CUDA graph replays each frame's looper)
// and writes it 7 draws on; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "shading.cuh"

extern "C" {

// The launch's arguments, field for field radish_pt_tpu_torch/render/vertex.py's
// VertexArgs.
struct VertexArgs {
  // the lanes: hit position, shading normal, ray direction, throughput
  // [N, 3], active [N] (bool), the material's type [N] (int32), base colour
  // [N, 3], metallic, roughness, ior [N], the sampler's scramble [N]
  const float* pos;
  const float* norm;
  const float* ray_d;
  const float* throughput;
  const unsigned char* active;
  const int* mtype;
  const float* base_color;
  const float* metallic;
  const float* roughness;
  const float* ior;
  const long long* scramble;
  int n;
  // the sampler's dimension pointer (0-d), the Sobol table (NULL: hash
  // mode) and its length
  const long long* ptr;
  const long long* sobol;
  long long sobol_len;
  // area lights: triangle vertices [T, 3, 3], the lights' triangle ids and
  // radiance [L, 3], the light alias table [n_alias], 1 / sum of power (0-d)
  const float* tri_v;
  const int* light_prim;
  const float* light_radiance;
  const float* light_prob;
  const int* light_alias;
  const float* sum_light_power_inv;
  int n_area;
  int n_alias;
  int has_env;
  int single_sided;
  // material types present: MAT_LAMBERTIAN, MAT_METALLIC_WORKFLOW,
  // MAT_DIELECTRIC
  int lambertian;
  int metallic_lobe;
  int dielectric;
  // the env map: its alias table over texels, the texture atlas, its id
  const float* env_prob;
  const int* env_alias;
  const float* tex_data;
  const int* tex_offset;
  const int* tex_width;
  const int* tex_height;
  int n_env;
  int env_tex;
  // outputs: the shadow segment's end [N, 3], ok [N], the unoccluded
  // contribution [N, 3], the scramble [N] and pointer (0-d) 7 draws on,
  // active, throughput [N, 3], the sampled direction [N, 3], its pdf, delta
  unsigned char* ok;
  float* seg_end;
  float* contrib;
  long long* scramble_out;
  long long* ptr_out;
  unsigned char* active_out;
  float* throughput_out;
  float* new_dir;
  float* pdf;
  unsigned char* delta;
};

}  // extern "C"

namespace {

using namespace shading;

constexpr int kBlock = 256;
// BSDF sample type flags (bsdf/materials.py)
constexpr int kDiffuse = 1 << 0;
constexpr int kGlossy = 1 << 1;
constexpr int kSpecular = 1 << 2;
constexpr int kReflection = 1 << 4;
constexpr int kTransmission = 1 << 5;
constexpr int kInvalid = 1 << 15;

// MetallicWorkflow's _metallic_eval (the lane's base colour) and
// _metallic_pdf at wi
__device__ __forceinline__ void metal_eval_pdf(const Ggx& g, V3 n, V3 wo, V3 wi, V3 base,
                                               float metallic, V3* f, float* pdf) {
  const GgxEval e = ggx_eval(g, n, wo, wi);
  *f = e.zero ? V3{0.0f, 0.0f, 0.0f}
              : V3{ggx_channel(e, base.x, metallic), ggx_channel(e, base.y, metallic),
                   ggx_channel(e, base.z, metallic)};
  const float spec_w = rcp(sub(2.0f, metallic));
  const float diff_pdf = lambert(clamp_min(dot(n, wi), 0.0f));
  // ggx_pdf(n, h, wo, alpha): D * schlick_g(dot(n, wo)) * |dot(h, wo)| /
  // max(|dot(n, wo)|, 1e-12)
  const float ggx_pdf = div(mul(mul(e.d, schlick_g(g.cos_o, g.a, g.one_minus_a)), fabsf(e.hw)),
                            clamp_min(fabsf(g.cos_o), (float)1e-12));
  const float spec_pdf = div(ggx_pdf, clamp_min(mul(4.0f, fabsf(e.hw)), (float)1e-12));
  *pdf = add(mul(diff_pdf, sub(1.0f, spec_w)), mul(spec_pdf, spec_w));
}

// ggx_sample_vndf: the half vector for the disk point (px, p1)
__device__ __forceinline__ V3 ggx_vndf(const Frame& fr, V3 n, V3 wo, float alpha, float px,
                                       float p1) {
  const V3 wl = {dot(wo, fr.t), dot(wo, fr.b), dot(wo, n)};
  const V3 vh = normalize({mul(wl.x, alpha), mul(wl.y, alpha), mul(wl.z, 1.0f)});
  const float len_sq = add(mul(vh.x, vh.x), mul(vh.y, vh.y));
  const float inv_len = rcp(__fsqrt_rn(clamp_min(len_sq, (float)1e-24)));
  const V3 t1 = len_sq > 0.0f ? V3{mul(-vh.y, inv_len), mul(vh.x, inv_len), mul(0.0f, inv_len)}
                              : V3{1.0f, 0.0f, 0.0f};
  const V3 t2 = cross(vh, t1);
  const float s = mul(0.5f, add(vh.z, 1.0f));
  const float py = add(mul(sub(1.0f, s), sqrt0(sub(1.0f, mul(px, px)))), mul(s, p1));
  const float pz = sqrt0(sub(sub(1.0f, mul(px, px)), mul(py, py)));
  const V3 h = vadd(vadd(vscale(t1, px), vscale(t2, py)), vscale(vh, pz));
  return normalize(to_world(fr, n, mul(h.x, alpha), mul(h.y, alpha), clamp_min(h.z, 0.0f)));
}

struct Sample {
  V3 dir, bsdf;
  float pdf;
  int type;
};

// bsdf_sample for one lane with the draws r[0..2]
__device__ __forceinline__ Sample bsdf_sample(const VertexArgs& a, int i, int mtype, V3 n,
                                              V3 wo, V3 base, const float* r) {
  Sample out = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f, kInvalid};
  const bool lam = a.lambertian && mtype == kMatLambertian;
  const bool metal = a.metallic_lobe && mtype == kMatMetallic;
  if (lam || metal) {
    // cosine_sample_hemisphere: the disk point (concentric_sample_disk),
    // lifted, through local_to_world; the metallic lobe's diffuse choice
    // and its VNDF take the same point
    const float rr = __fsqrt_rn(r[0]);
    const float theta = mul(r[1], (float)(2.0 * kPi));
    const float dx = mul(rr, cosf(theta));
    const float dy = mul(rr, sinf(theta));
    const float z = sqrt0(sub(1.0f, add(mul(dx, dx), mul(dy, dy))));
    const Frame fr = local_frame(n);
    const V3 lam_dir = normalize(to_world(fr, n, dx, dy, z));
    if (lam) {
      out.dir = lam_dir;
      out.bsdf = {lambert(base.x), lambert(base.y), lambert(base.z)};
      out.pdf = lambert(clamp_min(dot(n, lam_dir), 0.0f));
      out.type = kDiffuse | kReflection;
    } else {
      const float metallic = a.metallic[i];
      const Ggx g = ggx_lane(a.roughness[i], n, wo);
      const V3 h = ggx_vndf(fr, n, wo, g.alpha, dx, dy);
      const V3 spec_dir = normalize(vsub(vscale(h, mul(2.0f, dot(h, wo))), wo));
      const bool use_diffuse = r[2] > rcp(sub(2.0f, metallic));
      out.dir = use_diffuse ? lam_dir : spec_dir;
      metal_eval_pdf(g, n, wo, out.dir, base, metallic, &out.bsdf, &out.pdf);
      out.type = dot(n, out.dir) < 0.0f ? kInvalid : kGlossy | kReflection;
    }
  } else if (a.dielectric && mtype == kMatDielectric) {
    const float ior = a.ior[i];
    const float cos_wo = dot(n, wo);
    const float eta = cos_wo < 0.0f ? rcp(ior) : ior;
    // fresnel(cos_wo, ior)
    const float ci = fabsf(cos_wo);
    const float sin_in = sqrt0(sub(1.0f, mul(ci, ci)));
    const float sin_tr = div(sin_in, eta);
    const float cos_t = sqrt0(sub(1.0f, mul(sin_tr, sin_tr)));
    const float r_par = div(sub(ci, mul(eta, cos_t)), add(ci, mul(eta, cos_t)));
    const float r_per = div(sub(mul(eta, ci), cos_t), add(mul(eta, ci), cos_t));
    const float fr = mul(add(mul(r_par, r_par), mul(r_per, r_per)), 0.5f);
    const float pdf_refl = sin_tr >= 1.0f ? 1.0f : fr;
    // refract(n, wo, ior)
    const float sin2_tr = div(clamp_min(sub(1.0f, mul(cos_wo, cos_wo)), 0.0f), mul(eta, eta));
    float cos_tr = sqrt0(sub(1.0f, sin2_tr));
    if (cos_wo < 0.0f) cos_tr = -cos_tr;
    const bool choose_refl = r[2] < pdf_refl;
    if (choose_refl) {
      out.dir = normalize(vsub(vscale(n, mul(2.0f, cos_wo)), wo));
      out.bsdf = base;
      out.type = kSpecular | kReflection;
    } else {
      out.dir = normalize(vadd(vdiv(vneg(wo), eta), vscale(n, sub(div(cos_wo, eta), cos_tr))));
      out.bsdf = vdiv(base, mul(eta, eta));
      out.type = sin2_tr < 1.0f ? kSpecular | kTransmission : kInvalid;
    }
    out.pdf = 1.0f;
  }
  return out;
}

template <bool kHash>
__global__ void __launch_bounds__(kBlock) vertex_kernel(const VertexArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const long long ptr = *a.ptr;
  if (i == 0) *a.ptr_out = ptr + 7;
  if (i >= a.n) return;

  // ---- the sampler's 7 draws: 4 for NEE, 3 for the BSDF sample ----
  uint32_t scr = (uint32_t)a.scramble[i];
  float r[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    r[k] = draw<kHash>(draw_word<kHash>(ptr + k, a.sobol, a.sobol_len), scr);
  }
  a.scramble_out[i] = (long long)scr;

  // ---- the lane ----
  const V3 pos = v3(a.pos + 3 * (size_t)i);
  V3 n = v3(a.norm + 3 * (size_t)i);
  const V3 wo = vneg(v3(a.ray_d + 3 * (size_t)i));
  const V3 thr = v3(a.throughput + 3 * (size_t)i);
  const bool active = a.active[i] != 0;
  const int mtype = a.mtype[i];
  const V3 base = v3(a.base_color + 3 * (size_t)i);
  const bool delta_mat = mtype == kMatDielectric;
  // two-sided shading for non-delta materials
  if (!delta_mat && dot(n, wo) < 0.0f) n = vneg(n);

  // ---- NEE: the light sample, its segment, the unoccluded contribution ----
  const Lights lights = lights_of(a.light_prob, a.light_alias, a.n_alias, a.n_area, a.has_env,
                                  a.single_sided, a.sum_light_power_inv, a.env_prob,
                                  a.env_alias, a.tex_data, a.tex_offset, a.tex_width,
                                  a.tex_height, a.n_env, a.env_tex);
  const LightSample ls = sample_light(
      lights, [&](int l) { return light_from_scene(a.tri_v, a.light_prim, a.light_radiance, l); },
      pos, r);
  const bool ok = ls.pdf > 0.0f && active && !delta_mat && dot(n, ls.wi) > 0.0f;
  a.ok[i] = ok;
  store3(a.seg_end + 3 * (size_t)i, vadd(pos, vscale(ls.wi, ls.dist)));
  V3 contrib = {0.0f, 0.0f, 0.0f};
  if (ok) {
    V3 f = {0.0f, 0.0f, 0.0f};
    float b_pdf = 0.0f;
    if (a.metallic_lobe && mtype == kMatMetallic) {
      metal_eval_pdf(ggx_lane(a.roughness[i], n, wo), n, wo, ls.wi, base, a.metallic[i], &f,
                     &b_pdf);
    } else if (a.lambertian && mtype == kMatLambertian) {
      f = {lambert(base.x), lambert(base.y), lambert(base.z)};
      b_pdf = lambert(clamp_min(dot(n, ls.wi), 0.0f));
    }
    const float p2 = mul(ls.pdf, ls.pdf);
    const float mis_w = div(p2, add(p2, mul(b_pdf, b_pdf)));
    const float s = mul(div(clamp_min(dot(n, ls.wi), 0.0f), clamp_min(ls.pdf, (float)1e-12)),
                        mis_w);
    contrib = vscale(vmul(vmul(thr, f), ls.li), s);
  }
  store3(a.contrib + 3 * (size_t)i, contrib);

  // ---- the BSDF sample and the throughput update ----
  const Sample smp = bsdf_sample(a, i, mtype, n, wo, base, r + 4);
  const bool bad = (smp.type & kInvalid) != 0 || smp.pdf < (float)1e-8;
  const bool delta = (smp.type & kSpecular) != 0;
  const float cos_term = delta ? 1.0f : fabsf(dot(n, smp.dir));
  a.active_out[i] = active && !bad;
  a.delta[i] = delta;
  a.pdf[i] = smp.pdf;
  store3(a.new_dir + 3 * (size_t)i, smp.dir);
  store3(a.throughput_out + 3 * (size_t)i,
         vscale(vmul(thr, smp.bsdf), div(cos_term, clamp_min(smp.pdf, (float)1e-12))));
}

}  // namespace

extern "C" {

// Launches the vertex of args->n lanes on ``stream``; returns
// cudaGetLastError().  With no lane nothing is launched and the pointer is
// not written.
int vertex_shade(const VertexArgs* args, void* stream) {
  const VertexArgs& a = *args;
  if (a.n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (a.n + kBlock - 1) / kBlock;
  if (a.sobol == nullptr) {
    vertex_kernel<true><<<blocks, kBlock, 0, s>>>(a);
  } else {
    vertex_kernel<false><<<blocks, kBlock, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
