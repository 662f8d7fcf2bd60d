// ReSTIR's candidate RIS for Hopper (sm_90a): every lane draws
// reservoir_size light samples without visibility, weighs each by its
// target function over its pdf and keeps one in a weighted reservoir, in one
// launch.
//
// Replaces no Pallas kernel: the JAX package runs this loop as XLA code
// (radish_pt_tpu/render/restir.py, the candidate loop of restir_direct),
// and the port ran it as ~256 eager torch operations a candidate over the
// whole wavefront (radish_pt_tpu_torch/render/restir.py::ris_plain, which
// stays the plain version).  Each candidate is, per lane:
//   * 5 draws of the sampler (sampling/rng.py): Sobol, table[clamp(ptr)] ^
//     scramble; or, without a table, the hash mode, utilhash(scramble ^
//     salt(ptr)); then scramble = utilhash(scramble), ptr + 1;
//   * the light pick (sampling/alias.py::alias_sample), then
//     device_scene.py::sample_direct_light_no_vis: a uniform point of the
//     area light's triangle, its normal, radiance, distance and direction,
//     the pdf (luminance x 2 pi x 1 / sum of power, area to solid angle),
//     the single-sided facing test; or the env map's texel (its own alias
//     pick, the texel's centre through to_sphere, dist 1e6, the env pdf);
//   * bsdf/materials.py::bsdf_eval with a white base colour (the
//     demodulated material restir_candidates shades with): Lambertian,
//     MetallicWorkflow (GGX, Schlick Fresnel), every other type 0;
//   * p_hat = li * f * sat_dot(n, wi), w = |p_hat| / max(pdf, 1e-12), zero
//     unless finite with pdf > 0, and the update: weight += w, the
//     candidate taken where rand * weight < w.
//
// Arithmetic: each operation rounded on its own as the eager ops round it
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: nothing is
// contracted into an FMA), sinf / cosf as torch's sin / cos call them, the
// hash on uint32, clamps that keep NaN as torch.clamp keeps it.  A sum over
// a vec3's three components (torch.sum over the last axis on the card)
// takes torch's order: its reduction gives the row to two threads, one
// summing elements 0 and 2, the other element 1, then adds the two; its
// accumulators start at +0, so a sum is never -0.
//
// Bound on the card: operations.  A candidate is ~250 operations a lane
// (~110 of them the integer hashing), ~70 bytes read and ~45 written a lane
// in all: at 800x800 and 32 candidates, 5.1e9 operations, 0.15 ms at the
// f32 instruction rate (33.5 T/s), against ~0.02 ms of device memory.  The
// design keeps the work in registers and out of device memory: one thread
// a lane, 256-thread blocks; the reservoir, the lane's position, normal,
// view direction and the material's per-lane constants stay in registers
// across the candidates; the lane's inputs are read once and its reservoir
// and sampler state written once.  What every lane shares sits in shared
// memory, staged once a block: the draws' 5 x reservoir_size Sobol words
// (read through the device pointer, so a CUDA graph replays each frame's
// looper) or hash salts, and, when there are at most RIS_SMEM_LIGHTS area
// lights, each light's vertices, normal (computed once a block, with the
// plain version's operations) and radiance, and the light alias table.
// More lights are read through the read-only cache and their normal
// computed per sample.  The env map's texels and alias table are read from
// device memory (L2-resident).  The launch is on the caller's stream; the C
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef RIS_SMEM_LIGHTS
#define RIS_SMEM_LIGHTS 128  // area lights staged in shared memory a block
#endif

extern "C" {

// The launch's arguments, field for field radish_pt_tpu_torch/render/ris.py's
// RisArgs.
struct RisArgs {
  // the lanes: shading position, normal and view direction [N, 3], the
  // material's type, metallic and roughness [N], the sampler's scramble [N]
  const float* pos;
  const float* norm;
  const float* wo;
  const int* mtype;
  const float* metallic;
  const float* roughness;
  const long long* scramble;
  int n;
  int reservoir_size;
  // the sampler's dimension pointer (0-d), the Sobol table (NULL: hash mode)
  // and its length
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
  // material types present: MAT_LAMBERTIAN, MAT_METALLIC_WORKFLOW
  int lambertian;
  int metallic_lobe;
  // the env map: its alias table over texels, the texture atlas, its id
  const float* env_prob;
  const int* env_alias;
  const float* tex_data;
  const int* tex_offset;
  const int* tex_width;
  const int* tex_height;
  int n_env;
  int env_tex;
  // the reservoir and the advanced scramble
  float* li;
  float* wi;
  float* dist;
  float* num;
  float* weight;
  long long* scramble_out;
};

}  // extern "C"

namespace {

constexpr int kBlock = 256;
constexpr int kLightRec = 16;  // v0 v1 v2 normal radiance, one float of padding
constexpr int kMatLambertian = 0;
constexpr int kMatMetallic = 1;
// the constants as torch rounds a Python float operand: to the nearest f32
// of the double
constexpr double kPi = 3.14159265358979323846;
constexpr double kInvPi = 1.0 / kPi;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 vadd(V3 a, V3 b) { return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)}; }
__device__ __forceinline__ V3 vsub(V3 a, V3 b) { return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)}; }
__device__ __forceinline__ V3 vmul(V3 a, V3 b) { return {mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z)}; }
__device__ __forceinline__ V3 vscale(V3 a, float s) { return {mul(a.x, s), mul(a.y, s), mul(a.z, s)}; }
__device__ __forceinline__ V3 vdiv(V3 a, float s) { return {div(a.x, s), div(a.y, s), div(a.z, s)}; }

// torch.sum over the last axis of a [N, 3] tensor on the card: (x + z) + y,
// never -0 (its accumulators start at +0)
__device__ __forceinline__ float sum3(V3 p) { return add(add(add(p.x, p.z), p.y), 0.0f); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return sum3(vmul(a, b)); }
__device__ __forceinline__ float length(V3 a) { return __fsqrt_rn(clamp_min(dot(a, a), 0.0f)); }
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

// sampling/alias.py::alias_sample over a table of n buckets
__device__ __forceinline__ int alias_pick(const float* prob, const int* alias, int n, float r1,
                                          float r2) {
  const int idx = min(__float2int_rz(mul(r1, (float)n)), n - 1);
  return r2 < prob[idx] ? idx : alias[idx];
}

// utils/math.py::triangle_normal
__device__ __forceinline__ V3 triangle_normal(V3 v0, V3 v1, V3 v2) {
  return normalize(cross(vsub(v1, v0), vsub(v2, v0)));
}

// bsdf/materials.py::schlick_g
__device__ __forceinline__ float schlick_g(float c, float a, float one_minus_a) {
  return div(c, add(mul(c, one_minus_a), a));
}

// what a lane's MetallicWorkflow lobe holds across its candidates (the
// per-lane operands of _metallic_eval with a white base colour)
struct Metal {
  float alpha, alpha2, a, one_minus_a, f0, one_minus_f0, diffuse, cos_o, g_o;
};

__device__ __forceinline__ Metal metal_lane(float metallic, float roughness, V3 n, V3 wo) {
  Metal m;
  m.alpha = mul(roughness, roughness);
  m.alpha2 = mul(m.alpha, m.alpha);
  m.a = mul(m.alpha, 0.5f);
  m.one_minus_a = sub(1.0f, m.a);
  m.f0 = add((float)0.08, mul(sub(1.0f, (float)0.08), metallic));
  m.one_minus_f0 = sub(1.0f, m.f0);
  m.diffuse = mul(mul(1.0f, (float)kInvPi), sub(1.0f, metallic));
  m.cos_o = dot(n, wo);
  m.g_o = schlick_g(fabsf(m.cos_o), m.a, m.one_minus_a);
  return m;
}

// _metallic_eval (one value: the white base colour makes the three
// channels equal)
__device__ __forceinline__ float metal_eval(const Metal& m, V3 n, V3 wo, V3 wi) {
  const V3 h = normalize(vadd(wo, wi));
  const float cos_i = dot(n, wi);
  const float x = clamp_min(sub(1.0f, dot(h, wo)), 0.0f);
  const float x2 = mul(x, x);
  const float t = mul(mul(x2, x2), x);
  const float f = add(m.f0, mul(m.one_minus_f0, t));
  const float nh = dot(n, h);
  const float denom = add(mul(mul(nh, nh), sub(m.alpha2, 1.0f)), 1.0f);
  float d = div(m.alpha2, clamp_min(mul(mul(denom, denom), (float)kPi), (float)1e-12));
  if (nh < (float)1e-6) d = 0.0f;
  const float g = mul(m.g_o, schlick_g(fabsf(cos_i), m.a, m.one_minus_a));
  const float spec = div(mul(g, d), clamp_min(mul(mul(4.0f, cos_i), m.cos_o), (float)1e-12));
  const float out = add(mul(m.diffuse, sub(1.0f, f)), mul(spec, f));
  return mul(cos_i, m.cos_o) < (float)1e-7 ? 0.0f : out;
}

// an area light's record: vertices, normal, radiance
struct Light {
  V3 v0, v1, v2, normal, radiance;
};

__device__ __forceinline__ Light light_from_scene(const RisArgs& a, int l) {
  const float* v = a.tri_v + (size_t)__ldg(a.light_prim + l) * 9;
  Light L;
  L.v0 = {__ldg(v + 0), __ldg(v + 1), __ldg(v + 2)};
  L.v1 = {__ldg(v + 3), __ldg(v + 4), __ldg(v + 5)};
  L.v2 = {__ldg(v + 6), __ldg(v + 7), __ldg(v + 8)};
  L.normal = triangle_normal(L.v0, L.v1, L.v2);
  const float* r = a.light_radiance + (size_t)l * 3;
  L.radiance = {__ldg(r + 0), __ldg(r + 1), __ldg(r + 2)};
  return L;
}

__device__ __forceinline__ Light light_from_smem(const float* rec) {
  return {v3(rec), v3(rec + 3), v3(rec + 6), v3(rec + 9), v3(rec + 12)};
}

template <bool kHash, bool kSharedLights>
__global__ void __launch_bounds__(kBlock) ris_candidates_kernel(const RisArgs a) {
  extern __shared__ float smem[];
  const int draws = 5 * a.reservoir_size;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);  // a draw's Sobol word or hash salt
  float* lights = smem + ((draws + 3) & ~3);
  const float* prob = a.light_prob;
  const int* alias = a.light_alias;

  // ---- what every lane shares, staged once a block ----
  const long long ptr = *a.ptr;
  for (int j = threadIdx.x; j < draws; j += kBlock) {
    if (kHash) {  // rng.sample_1d's salt: (ptr * 0x9E3779B9) & 0xFFFFFFFF
      words[j] = (uint32_t)(unsigned long long)(ptr + j) * 0x9E3779B9u;
    } else {
      const long long p = min(max(ptr + j, 0LL), a.sobol_len - 1);
      words[j] = (uint32_t)a.sobol[p];
    }
  }
  if (kSharedLights) {
    for (int l = threadIdx.x; l < a.n_area; l += kBlock) {
      const Light L = light_from_scene(a, l);
      float* rec = lights + l * kLightRec;
      const V3 parts[5] = {L.v0, L.v1, L.v2, L.normal, L.radiance};
      for (int k = 0; k < 5; ++k) {
        rec[3 * k] = parts[k].x;
        rec[3 * k + 1] = parts[k].y;
        rec[3 * k + 2] = parts[k].z;
      }
    }
    float* sprob = lights + a.n_area * kLightRec;
    int* salias = reinterpret_cast<int*>(sprob + a.n_alias);
    for (int j = threadIdx.x; j < a.n_alias; j += kBlock) {
      sprob[j] = a.light_prob[j];
      salias[j] = a.light_alias[j];
    }
    prob = sprob;
    alias = salias;
  }
  __syncthreads();

  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;

  // ---- the lane ----
  const V3 pos = v3(a.pos + 3 * (size_t)i);
  const V3 n = v3(a.norm + 3 * (size_t)i);
  const V3 wo = v3(a.wo + 3 * (size_t)i);
  const int mtype = a.mtype[i];
  const bool lambertian = a.lambertian && mtype == kMatLambertian;
  const bool metal = a.metallic_lobe && mtype == kMatMetallic;
  Metal mt = {};
  if (metal) mt = metal_lane(a.metallic[i], a.roughness[i], n, wo);
  const bool has_lights = a.n_area > 0 || a.has_env;
  const float slpi = has_lights ? *a.sum_light_power_inv : 0.0f;
  int env_w = 1, env_off = 0;
  float env_wf = 1.0f, env_hf = 1.0f;
  if (a.has_env) {
    env_w = a.tex_width[a.env_tex];
    env_off = a.tex_offset[a.env_tex];
    env_wf = __int2float_rn(env_w);
    env_hf = __int2float_rn(a.tex_height[a.env_tex]);
  }
  uint32_t scr = (uint32_t)a.scramble[i];

  V3 r_li = {0.0f, 0.0f, 0.0f}, r_wi = {0.0f, 0.0f, 0.0f};
  float r_dist = 0.0f, r_num = 0.0f, r_weight = 0.0f;

  for (int c = 0; c < a.reservoir_size; ++c) {
    float r[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const uint32_t w = words[5 * c + k];
      r[k] = unit(kHash ? utilhash(scr ^ w) : (w ^ scr));
      scr = utilhash(scr);
    }

    // ---- one light sample without visibility ----
    V3 li = {0.0f, 0.0f, 0.0f}, wi = {0.0f, 0.0f, 0.0f};
    float dist = 0.0f, pdf = -1.0f;
    if (has_lights) {
      const int light_id = alias_pick(prob, alias, a.n_alias, r[0], r[1]);
      if (a.has_env && light_id == a.n_area) {
        // _sample_env_map: the texel's radiance, its centre through
        // to_sphere, the env pdf
        const int pix = alias_pick(a.env_prob, a.env_alias, a.n_env, r[2], r[3]);
        const int y = pix / env_w;
        const int x = pix - y * env_w;
        li = v3(a.tex_data + 3 * ((size_t)env_off + pix));
        const float phi = mul(div(add(__int2float_rn(x), 0.5f), env_wf), (float)(2.0 * kPi));
        const float theta = mul(div(add(__int2float_rn(y), 0.5f), env_hf), (float)kPi);
        const float sin_t = sinf(theta);
        wi = {mul(cosf(phi), sin_t), cosf(theta), mul(sinf(phi), sin_t)};
        dist = 1e6f;
        pdf = mul(mul(mul(mul(mul(luminance(li), slpi), env_wf), env_hf),
                      (float)(kInvPi * kInvPi)), 0.5f);
      } else if (a.n_area > 0) {
        const int lid = min(max(light_id, 0), a.n_area - 1);
        const Light L = kSharedLights ? light_from_smem(lights + lid * kLightRec)
                                      : light_from_scene(a, lid);
        // sample_triangle_uniform
        const float sq = __fsqrt_rn(r[3]);
        const float u = sub(1.0f, sq);
        const float v = mul(r[2], sq);
        const float bw = sub(sub(1.0f, u), v);
        const V3 sampled = vadd(vadd(vscale(L.v1, u), vscale(L.v2, v)), vscale(L.v0, bw));
        const V3 to = vsub(sampled, pos);
        const float d2 = dot(to, to);
        dist = __fsqrt_rn(clamp_min(d2, 0.0f));
        wi = vdiv(to, clamp_min(dist, (float)1e-12));
        li = L.radiance;
        const float pdf_area = mul(mul(luminance(li), (float)(2.0 * kPi)), slpi);
        // pdf_area_to_solid_angle(pdf_area, pos, sampled, normal): its
        // pos - sampled is -to, so its squared length is d2 and its
        // normalized direction -wi, bit for bit
        const float cos_l = dot(L.normal, {-wi.x, -wi.y, -wi.z});
        pdf = div(mul(pdf_area, d2), clamp_min(fabsf(cos_l), (float)1e-12));
        if (a.single_sided && !(cos_l > (float)1e-6)) pdf = -1.0f;
      }
    }

    // ---- the BSDF, the target function and the weight ----
    const float f = metal ? metal_eval(mt, n, wo, wi)
                          : lambertian ? mul(1.0f, (float)kInvPi) : 0.0f;
    const float sd = clamp_min(dot(n, wi), 0.0f);
    const V3 p_hat = vscale(vscale(li, f), sd);
    float w = div(length(p_hat), clamp_min(pdf, (float)1e-12));
    if (!(isfinite(w) && pdf > 0.0f)) w = 0.0f;

    // ---- the reservoir update: the candidate taken where rand * weight < w
    const float weight = add(r_weight, w);
    if (mul(r[4], weight) < w) {
      r_li = li;
      r_wi = wi;
      r_dist = dist;
    }
    r_num = add(r_num, 1.0f);
    r_weight = weight;
  }

  float* li_out = a.li + 3 * (size_t)i;
  float* wi_out = a.wi + 3 * (size_t)i;
  li_out[0] = r_li.x;
  li_out[1] = r_li.y;
  li_out[2] = r_li.z;
  wi_out[0] = r_wi.x;
  wi_out[1] = r_wi.y;
  wi_out[2] = r_wi.z;
  a.dist[i] = r_dist;
  a.num[i] = r_num;
  a.weight[i] = r_weight;
  a.scramble_out[i] = (long long)scr;
}

template <bool kHash, bool kSharedLights>
int launch(const RisArgs& a, cudaStream_t s) {
  const int draws = 5 * a.reservoir_size;
  size_t smem = sizeof(float) * ((draws + 3) & ~3);
  if (kSharedLights) smem += sizeof(float) * (a.n_area * kLightRec + 2 * a.n_alias);
  const int blocks = (a.n + kBlock - 1) / kBlock;
  ris_candidates_kernel<kHash, kSharedLights><<<blocks, kBlock, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the candidate RIS of args->n lanes on ``stream``; returns
// cudaGetLastError().  The wrapper keeps reservoir_size within the
// shared memory a block has without an opt-in (48 KB).
int ris_candidates(const RisArgs* args, void* stream) {
  const RisArgs& a = *args;
  if (a.n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool hash = a.sobol == nullptr;
  const bool shared = a.n_area <= RIS_SMEM_LIGHTS;
  if (hash) return shared ? launch<true, true>(a, s) : launch<true, false>(a, s);
  return shared ? launch<false, true>(a, s) : launch<false, false>(a, s);
}

// the number of area lights a block stages in shared memory (RIS_SMEM_LIGHTS)
int ris_smem_lights() { return RIS_SMEM_LIGHTS; }

}  // extern "C"
