// The shade stage of one bounce as one kernel, for the forward Lambert path
// (shade_bounce_kernel) and the forward Disney path (shade_disney_kernel).
//
// What they replace. No Pallas kernel: the JAX package leaves shading to
// XLA's fusions (lighthouse2_tpu/render/wavefront.py shade_bounce, with
// render/shading.py, lights.py, bsdf_lambert.py, bsdf_disney.py,
// textures.py, sky.py and core/rng.py, bluenoise.py). The port composed the
// same function from small ATen kernels (render/wavefront.py
// _shade_composed): ~2,700 a bounce for Lambert, ~4,400 for Disney, whose
// BSDF evaluates all four lobes on every lane twice a bounce (the NEE, the
// MIS sum) and builds three candidate directions to keep one. Each op cost
// about its launch-to-launch spacing and not its bytes. A kernel runs the
// whole stage, from the sanitised hit to the new path state and the shadow
// ray, in one launch; render/kernels/shade.py says when.
//
// What bounds them on this card. Lambert: bytes. A lane reads 122 B of path
// state, hit and depth, 124 B of its triangle's rows (gathered) or 47 of the
// cluster payload's 72 rows (188 B), its material's row, a few texels and
// the lights, and writes 116 B of new path state and shadow ray; a few
// hundred flops and a handful of transcendentals a lane (two sweeps over
// the lights) are far below the card's rate. At 262,144 lanes that is
// ~95-112 MB a bounce, ~28-33 us at 3.35 TB/s. Disney reads the same lane
// state and rows, plus its material's nine more fields and four texture
// ids (from the material table, or the payload's material rows), so its
// byte bound is nearly Lambert's; but a lane evaluates two four-lobe BSDFs
// and samples GGX or GTR1 (square roots, logarithms and a power in each
// microfacet term), and its warps split between the glass, the picked
// lobes and the dead lanes. On an H100 it shades a bounce of the bathroom
// at 512x512 in ~0.14 ms (gathers) / ~0.16 ms (payload), 20% / 23% of its
// byte bound: arithmetic and divergence, not bytes, set its time.
//
// What the design does about it. One lane a thread in 128-thread blocks;
// every intermediate stays in registers, so each byte of lane state is read
// once and each output written once (the composed code wrote and re-read
// hundreds of [N] intermediates). The scene's own tensors are read in place
// through const __restrict__ pointers and __ldg: no pack of triangle or
// material rows is built. The lights are walked in a loop (the composed code
// builds [L, N] matrices); a lane keeps no per-light array, it recomputes
// the picked light's potential, which rounds the same way. The kernel body
// is one template (shade_lane) on the BSDF, so the two kernels share every
// line but the BSDF's and each gets its own register allocation: the
// Lambert kernel uses 112 registers with no spills (nvcc -Xptxas -v); on an
// H100 it shades a bounce of the bathroom at 512x512 in ~0.10 ms (gathers)
// / ~0.11 ms (payload), 28% / 31% of the byte bound. Measured and not kept
// (PERF.md): register caps of 96, 80 and 64 (they spill; at most 7% faster)
// and 64- or 256-thread blocks (within 1%). The Disney kernel (126
// registers, no spills) computes a lane's lobe weights, tints, GGX and
// GTR1 alphas once (the composed code once per call of each lobe
// function), evaluates the BSDF toward the light only on lanes whose
// connection can count, samples only on lanes that may extend, builds only
// the picked lobe's direction (or the dielectric's), and still sums all
// four lobes at the sampled direction, as disney.h does. It counts the
// lobe picks (render/wavefront.py's `marks` calls) in shared memory and
// adds them to the device's counts with at most one atomic a lobe a block.
//
// Numerics. Each operation follows the composed PyTorch code in order, so
// that the RNG stream (integer, bit for bit) and the branch decisions of a
// lane agree with it: the library is built with -fmad=false, as
// csrc/trace.cu, so each float operation rounds as the one ATen op it
// replaces; a division by a Python scalar multiplies by its float
// reciprocal (ATen's div by a CPU scalar), and `c / tensor` is
// reciprocal(tensor) * c (torch.Tensor.__rtruediv__). A dot product adds
// as ATen's CUDA sum over a contiguous [N, 3] does, (x0 + x2) + x1, and a
// dot the composed code writes out (render/lights.py) left to right;
// torch.linalg.cross fuses each first product (fmaf), as ATen's kernel,
// compiled with contraction, does. Sums over the lights add in row order,
// where ATen's reduction may pair them otherwise (a last-bit difference in
// a light's pick probability).
// Transcendentals are the CUDA math library's, as ATen's.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#define BLOCK 128
#define EPS_PDF 1e-4f            // wavefront.py EPSILON
#define MAT_HASALPHA 2           // scene/host_material.py
#define DIR_LIGHT_DISTANCE 1000.0f
#define SPECULAR_TRANSMISSION 0.999f
#define SPECULAR_ROUGHNESS 0.001f
#define INV_2_32 2.3283064365387e-10f
#define INV_PI 0.31830988618379067f
#define TWO_PI 6.283185307179586f
#define TWO_OVER_PI 0.6366197723675814f
#define BN_A0 0.7548776662466927f    // core/bluenoise.py _ALPHA
#define BN_A1 0.5698402909980532f
#define BN_PAIR 0.41421356f
#define BN_N 128
#define BN_SHIFT_X 59
#define BN_SHIFT_Y 83
#define PI_F 3.141592653589793f
#define N_LOBES 5                // utils/telemetry.py LOBES

// Rows of the cluster payload (bvh/clusters.py PAY_*); the loader checks
// them against the Python constants (lh2_shade_layout).
#define PAY_V0 0
#define PAY_N0 9
#define PAY_UV0 18
#define PAY_ALPHA 24
#define PAY_MAT 28
#define PAY_LTRI 29
#define PAY_LOD 30
#define PAY_TAN 32
#define PAY_BIT 35
#define PAY_GEO_ROWS 40
#define PAY_ROWS 72

// Everything one launch reads and writes; mirrored field for field by
// render/kernels/shade.py _Args (pointers, then ints, then floats).
struct ShadeArgs {
  // path state and hit [N] / [N, 3]
  const float* o; const float* d; const float* tp; const float* pdf;
  const float* last_n; const uint8_t* prev_spec; const int* n_diffuse;
  const uint8_t* alive; const long long* pixel; const long long* sample;
  const long long* path_idx; const float* acc;
  const float* t; const int* prim; const float* u; const float* v;
  const long long* depth;       // per-lane path depth (regen) or null
  const long long* cam_seed;    // 0-d
  const float* spread;          // 0-d view.spread_angle
  const float* payload;         // [PAY_ROWS, N] (cluster) or null
  // triangles (gathers) [T, k]
  const float* n0; const float* n1; const float* n2; const float* face_n;
  const float* uv0; const float* uv1; const float* uv2; const float* alpha;
  const float* area; const float* lod; const float* tangent;
  const float* bitangent; const int* mat; const int* ltri;
  // materials [M, k]
  const float* m_color; const float* m_absorption; const float* m_rough;
  const float* m_transmission; const float* m_eta; const int* m_flags;
  const int* m_tex_diffuse; const int* m_tex_normal; const int* m_tex_rough;
  const int* m_tex_mr; const int* m_tex_absorption;
  // textures: pool [4, P], desc [NT, mips, 3]
  const float* pool; const int* desc;
  // lights
  const float* tri_v0; const float* tri_v1; const float* tri_v2;
  const float* tri_n; const float* tri_rad; const float* tri_area;
  const float* tri_energy;
  const float* pt_pos; const float* pt_rad; const float* pt_energy;
  const float* sp_pos; const float* sp_rad; const float* sp_dir;
  const float* sp_cos_in; const float* sp_cos_out; const float* sp_energy;
  const float* dl_dir; const float* dl_rad; const float* dl_energy;
  const float* sky;             // [H, W, 3]
  const float* bn_mask;         // [128, 128] or null (blue noise off)
  // outputs
  float* o_out; float* d_out; float* tp_out; float* pdf_out;
  float* last_n_out; uint8_t* prev_spec_out; int* n_diffuse_out;
  uint8_t* alive_out; float* acc_out; long long* cam_seed_out;
  float* sh_o; float* sh_d; float* sh_tmax; float* sh_pot; uint8_t* sh_conn;
  uint8_t* sh_direct;
  // the Disney fields of the materials [M] (gathers; read by the Disney
  // kernel only), and the device's lobe counts [5] or null (no count)
  const float* m_metallic; const float* m_subsurface; const float* m_specular;
  const float* m_spec_tint; const float* m_anisotropic; const float* m_sheen;
  const float* m_sheen_tint; const float* m_clearcoat;
  const float* m_clearcoat_gloss; const int* m_tex_sheen;
  const int* m_tex_clearcoat; const int* m_tex_specular;
  const int* m_tex_anisotropic;
  unsigned long long* lobes;
  // ints
  int n; int li; int lt; int lp; int ls; int ld;
  int pool_n; int desc_mips; int mip_levels; int base_maps; int param_maps;
  int sky_h; int sky_w; int width; int max_path; int max_diffuse;
  int russian_roulette; int clamp_fireflies; int consistent_normals;
  // floats
  float geo_eps; float clamp_value;
};

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 mk(float x, float y, float z) {
  V3 r; r.x = x; r.y = y; r.z = z; return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return mk(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return mk(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return mk(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 scl(V3 a, float s) {
  return mk(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return mk(-a.x, -a.y, -a.z); }
// geometry.dot, (a * b).sum(-1): ATen's CUDA sum over a contiguous last
// dimension of 3 adds the first and the third, then the second
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return (a.x * b.x + a.z * b.z) + a.y * b.y;
}
// a dot written out in the composed code (render/lights.py): left to right
__device__ __forceinline__ float dot_ltr(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
// torch.clamp(x, min=lo) / clamp(x, max=hi): NaN stays NaN
__device__ __forceinline__ float cmin(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float cmax(float x, float hi) {
  return x > hi ? hi : x;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float amax(V3 a) { return nmax(nmax(a.x, a.y), a.z); }
__device__ __forceinline__ float fixnan(float x) { return isfinite(x) ? x : 0.0f; }
__device__ __forceinline__ V3 fixnan(V3 a) {
  return mk(fixnan(a.x), fixnan(a.y), fixnan(a.z));
}
__device__ __forceinline__ V3 normalize(V3 a) {
  return scl(a, rsqrtf(cmin(dot(a, a), 1e-20f)));
}
// torch.linalg.cross: ATen's CUDA kernel fuses each first product
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk(fmaf(a.y, b.z, -(a.z * b.y)), fmaf(a.z, b.x, -(a.x * b.z)),
            fmaf(a.x, b.y, -(a.y * b.x)));
}
__device__ __forceinline__ V3 ld3(const float* __restrict__ p, long long i) {
  return mk(__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2));
}
__device__ __forceinline__ V3 ldrows(const float* __restrict__ p, int row,
                                     long long n, long long i) {
  return mk(__ldg(p + row * n + i), __ldg(p + (row + 1) * n + i),
            __ldg(p + (row + 2) * n + i));
}
__device__ __forceinline__ void st3(float* p, long long i, V3 a) {
  p[3 * i] = a.x; p[3 * i + 1] = a.y; p[3 * i + 2] = a.z;
}
// _masked_div: num / den where mask else 0
__device__ __forceinline__ float mdiv(float num, float den, bool m) {
  return m ? num / den : 0.0f;
}
__device__ __forceinline__ V3 mdiv(V3 num, float den, bool m) {
  return m ? mk(num.x / den, num.y / den, num.z / den) : mk(0.f, 0.f, 0.f);
}
// wavefront.py _clamp_intensity (clamp / vs is reciprocal(vs) * clamp)
__device__ __forceinline__ V3 clamp_intensity(V3 c, float cv) {
  const float v = amax(c);
  const float vs = cmin(v, cv);
  const float s = v > cv ? (1.0f / vs) * cv : 1.0f;
  return scl(c, s);
}

// ------------------------------------------------------------- core/rng.py
__device__ __forceinline__ uint32_t wang_hash(uint32_t s) {
  s = (s ^ 61u) ^ (s >> 16);
  s = s * 9u;
  s = s ^ (s >> 4);
  s = s * 0x27D4EB2Du;
  return s ^ (s >> 15);
}
__device__ __forceinline__ uint32_t xorshift32(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}
__device__ __forceinline__ float random_float(uint32_t& seed) {
  seed = xorshift32(seed);
  return (float)seed * INV_2_32;
}

// ------------------------------------------------------- core/bluenoise.py
__device__ __forceinline__ float bn_sample(const float* __restrict__ mask,
                                           long long x, long long y,
                                           long long sample, long long dim) {
  const float s = (float)sample;
  const float alpha = (dim % 2 == 0) ? BN_A0 : BN_A1;
  const float pair = (float)(dim / 2);
  const float seq = fmodf(alpha * (s + 1.0f) + BN_PAIR * pair, 1.0f);
  const long long mx = (x + BN_SHIFT_X * dim) & (BN_N - 1);
  const long long my = (y + BN_SHIFT_Y * dim) & (BN_N - 1);
  return fmodf(seq + __ldg(mask + mx * BN_N + my), 1.0f);
}

// ------------------------------------------------------ render/textures.py
__device__ __forceinline__ long long rem(long long a, long long b) {
  long long r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

struct Texel { float c[4]; };

__device__ Texel fetch_bilinear(const ShadeArgs& a, int tex_id, float u,
                                float v, long long level) {
  const long long tid = tex_id < 0 ? 0 : tex_id;
  const long long lvl = level < 0 ? 0 : (level > a.mip_levels - 1
                                         ? a.mip_levels - 1 : level);
  const int* di = a.desc + 3 * (tid * a.desc_mips + lvl);
  const long long off = __ldg(di), w = __ldg(di + 1), h = __ldg(di + 2);
  const float wf = (float)w, hf = (float)h;
  const float x = (u + 1000.0f) * wf - 0.5f;
  const float y = (v + 1000.0f) * hf - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const long long wm = w < 1 ? 1 : w, hm = h < 1 ? 1 : h;
  const long long xa = rem((long long)x0, wm);
  const long long xb = rem((long long)(x0 + 1.0f), wm);
  const long long ya = rem((long long)y0, hm);
  const long long yb = rem((long long)(y0 + 1.0f), hm);
  const long long i00 = off + xa + ya * w, i10 = off + xb + ya * w;
  const long long i01 = off + xa + yb * w, i11 = off + xb + yb * w;
  Texel r;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* p = a.pool + (long long)c * a.pool_n;
    const float top = __ldg(p + i00) * (1.0f - fx) + __ldg(p + i10) * fx;
    const float bot = __ldg(p + i01) * (1.0f - fx) + __ldg(p + i11) * fx;
    r.c[c] = top * (1.0f - fy) + bot * fy;
  }
  return r;
}

__device__ Texel fetch_trilinear(const ShadeArgs& a, int tex_id, float u,
                                 float v, float lam) {
  const float top = (float)a.mip_levels - 1.0f;
  lam = lam != lam ? lam : (lam < 0.0f ? 0.0f : (lam > top ? top : lam));
  const long long l0 = (long long)floorf(lam);
  const float frac = lam - (float)l0;
  const long long l1 = l0 + 1 > a.mip_levels - 1 ? a.mip_levels - 1 : l0 + 1;
  const Texel ta = fetch_bilinear(a, tex_id, u, v, l0);
  const Texel tb = fetch_bilinear(a, tex_id, u, v, l1);
  Texel r;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    r.c[c] = ta.c[c] * (1.0f - frac) + tb.c[c] * frac;
  return r;
}

// ------------------------------------------------------ core/geometry.py
__device__ __forceinline__ void onb(V3 n, V3& t, V3& b) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -(1.0f / (sign + n.z));
  const float bb = n.x * n.y * a;
  t = mk(1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x);
  b = mk(bb, sign + n.y * n.y * a, -n.y);
}

__device__ __forceinline__ V3 safe_origin(V3 o, V3 r, V3 n, float eps) {
  const float parallel = 1.0f - fabsf(dot(r, n));
  const float v = parallel * parallel;
  return add(add(o, scl(scl(n, eps), 1.0f - v)), scl(scl(r, eps), v));
}

__device__ __forceinline__ V3 consistent_normal(V3 d, V3 n, float alpha) {
  const float c = 1.0f - TWO_OVER_PI * alpha;
  const float q = (c * c) / (1.0f + 2.0f * c);
  const V3 nd = neg(d);
  const float b = dot(nd, n);
  const float g = 1.0f + q * (b - 1.0f);
  const float rho = sqrtf(cmin(q * (1.0f + g) / cmin(1.0f + b, 1e-6f),
                               1e-12f));
  const V3 r = sub(scl(n, g + rho * b), scl(nd, rho));
  return normalize(add(nd, r));
}

__device__ __forceinline__ void oriented_frame(V3 n, V3 tangent,
                                               V3 bitangent, V3& t, V3& b) {
  const V3 t_proj = sub(tangent, scl(n, dot(n, tangent)));
  const float tl = sqrtf(cmin(dot(t_proj, t_proj), 1e-20f));
  const bool has = (dot(tangent, tangent) > 0.25f) && (tl > 1e-6f);
  const V3 t_uv = mk(t_proj.x / tl, t_proj.y / tl, t_proj.z / tl);
  V3 b_uv = cross(n, t_uv);
  const float sign = dot(b_uv, bitangent) < 0.0f ? -1.0f : 1.0f;
  b_uv = scl(b_uv, sign);
  V3 t_onb, b_onb;
  onb(n, t_onb, b_onb);
  t = has ? t_uv : t_onb;
  b = has ? b_uv : b_onb;
}

// -------------------------------------------------------- render/lights.py
// _normalize3 of (x, y, z): the unit vector and the squared length
__device__ __forceinline__ V3 normalize3(V3 p, float& d2) {
  d2 = p.x * p.x + p.y * p.y + p.z * p.z;
  const float inv = d2 > 0.0f ? 1.0f / sqrtf(cmin(d2, 1e-30f)) : 0.0f;
  return scl(p, inv);
}

// potential_contributions' row k toward point `at` with normal `n`; an
// area row aims at `target`
__device__ float potential(const ShadeArgs& a, int k, V3 at, V3 n,
                           V3 target) {
  float d2;
  if (k < a.lt) {
    const V3 l = normalize3(sub(target, at), d2);
    const float att = 1.0f / cmin(d2, 1e-12f);
    const float ln_dot_l = cmin(-dot_ltr(ld3(a.tri_n, k), l), 0.0f);
    const float n_dot_l = cmin(dot_ltr(n, l), 0.0f);
    return __ldg(a.tri_energy + k) * ln_dot_l * n_dot_l * att;
  }
  k -= a.lt;
  if (k < a.lp) {
    const V3 l = normalize3(sub(ld3(a.pt_pos, k), at), d2);
    return __ldg(a.pt_energy + k) * cmin(dot_ltr(n, l), 0.0f)
           / cmin(d2, 1e-12f);
  }
  k -= a.lp;
  if (k < a.ls) {
    const V3 l = normalize3(sub(ld3(a.sp_pos, k), at), d2);
    const float co = __ldg(a.sp_cos_out + k);
    const float fall = (cmin(-dot_ltr(l, ld3(a.sp_dir, k)), 0.0f) - co)
                       / cmin(__ldg(a.sp_cos_in + k) - co, 1e-6f);
    const float f01 = fall != fall ? fall
                      : (fall < 0.0f ? 0.0f : (fall > 1.0f ? 1.0f : fall));
    return __ldg(a.sp_energy + k) * f01 * cmin(dot_ltr(n, l), 0.0f)
           / cmin(d2, 1e-12f);
  }
  k -= a.ls;
  return __ldg(a.dl_energy + k) * cmin(-dot_ltr(n, ld3(a.dl_dir, k)), 0.0f);
}

// random_barycentrics (core/sampling.py): 16 base-4 digits
__device__ __forceinline__ void random_barycentrics(float r, float& bu,
                                                    float& bv) {
  long long uf = (long long)(r * 4294967296.0f);
  uf = uf < 0 ? 0 : (uf > 0xFFFFFFFFll ? 0xFFFFFFFFll : uf);
  uint32_t w = (uint32_t)uf;
  float A = 1.f, B = 0.f, C = 0.f, D = 0.f, E = 1.f, F = 0.f;
  for (int k = 0; k < 16; ++k) {
    w = w << 2;
    const uint32_t dd = w >> 30;
    const float an = 0.5f * (B + C), bn = 0.5f * (C + A), cn = 0.5f * (A + B);
    const float dn = 0.5f * (E + F), en = 0.5f * (F + D), fn = 0.5f * (D + E);
    const float A2 = dd == 0 ? an : (dd == 1 ? A : (dd == 2 ? an : bn));
    const float B2 = dd == 0 ? bn : (dd == 1 ? bn : (dd == 2 ? B : an));
    const float C2 = dd == 3 ? C : cn;
    const float D2 = dd == 0 ? dn : (dd == 1 ? D : (dd == 2 ? dn : en));
    const float E2 = dd == 0 ? en : (dd == 1 ? en : (dd == 2 ? E : dn));
    const float F2 = dd == 3 ? F : fn;
    A = A2; B = B2; C = C2; D = D2; E = E2; F = F2;
  }
  bu = (A + B + C) * (1.0f / 3.0f);
  bv = (D + E + F) * (1.0f / 3.0f);
}

struct LightSample { V3 point; V3 color; float light_pdf; float pick_prob; };

// random_point_on_light without the sky slot
__device__ LightSample random_point_on_light(const ShadeArgs& a, float r0,
                                             float r1, V3 ip, V3 n) {
  LightSample s;
  const int L = a.lt + a.lp + a.ls + a.ld;
  if (L == 0) {
    s.point = mk(ip.x + 1.0f, ip.y + 1.0f, ip.z + 1.0f);
    s.color = mk(0.f, 0.f, 0.f);
    s.light_pdf = 0.0f;
    s.pick_prob = 0.0f;
    return s;
  }
  float bu = 0.f, bv = 0.f, bw = 0.f;
  if (a.lt) {
    random_barycentrics(r0, bu, bv);
    bw = 1.0f - bu - bv;
  }
#define AREA_POINT(k)                                                      \
  add(add(scl(ld3(a.tri_v0, k), bu), scl(ld3(a.tri_v1, k), bv)),          \
      scl(ld3(a.tri_v2, k), bw))
  float sum = 0.0f;
  for (int k = 0; k < L; ++k)
    sum += potential(a, k, ip, n, k < a.lt ? AREA_POINT(k) : ip);
  const float target = r1 * sum;
  int pick = 0;
  float cdf = 0.0f;
  for (int k = 0; k < L; ++k) {
    cdf += potential(a, k, ip, n, k < a.lt ? AREA_POINT(k) : ip);
    pick += cdf < target;
  }
  pick = pick > L - 1 ? L - 1 : pick;
  const float pot_pick = potential(a, pick, ip, n,
                                   pick < a.lt ? AREA_POINT(pick) : ip);
  s.pick_prob = sum > 0.0f ? pot_pick / sum : 0.0f;
  s.point = mk(ip.x + 1.0f, ip.y, ip.z);
  s.color = mk(0.f, 0.f, 0.f);
  s.light_pdf = 0.0f;
  float sq;
  if (pick < a.lt) {
    const V3 p = AREA_POINT(pick);
    const V3 lr = normalize3(sub(ip, p), sq);
    const float ln_dot_l = dot_ltr(lr, ld3(a.tri_n, pick));
    const float to_n = dot_ltr(lr, n);
    const bool ok = ln_dot_l > 0.0f && to_n < 0.0f;
    const float den = __ldg(a.tri_area + pick) * ln_dot_l;
    s.light_pdf = ok ? sq / cmin(den, 1e-30f) : 0.0f;
    s.point = p;
    s.color = ld3(a.tri_rad, pick);
  } else if (pick < a.lt + a.lp) {
    const int k = pick - a.lt;
    const V3 p = ld3(a.pt_pos, k);
    const V3 lr = normalize3(sub(ip, p), sq);
    s.light_pdf = dot_ltr(lr, n) < 0.0f ? sq : 0.0f;
    s.point = p;
    s.color = ld3(a.pt_rad, k);
  } else if (pick < a.lt + a.lp + a.ls) {
    const int k = pick - a.lt - a.lp;
    const V3 p = ld3(a.sp_pos, k);
    const V3 lr = normalize3(sub(ip, p), sq);
    const float co = __ldg(a.sp_cos_out + k);
    const float dfall = (cmin(dot_ltr(lr, ld3(a.sp_dir, k)), 0.0f) - co)
                        / cmin(__ldg(a.sp_cos_in + k) - co, 1e-6f);
    const float lnl = cmax(dfall, 1.0f);
    const bool ok = lnl > 0.0f && dot_ltr(lr, n) < 0.0f;
    s.light_pdf = ok ? sq / cmin(lnl, 1e-30f) : 0.0f;
    s.point = p;
    s.color = ld3(a.sp_rad, k);
  } else {
    const int k = pick - a.lt - a.lp - a.ls;
    const V3 dd = ld3(a.dl_dir, k);
    s.light_pdf = dot_ltr(dd, n) < 0.0f ? 1.0f : 0.0f;
    s.point = sub(ip, scl(dd, DIR_LIGHT_DISTANCE));
    s.color = ld3(a.dl_rad, k);
  }
#undef AREA_POINT
  if (!(sum > 0.0f)) s.light_pdf = 0.0f;
  return s;
}

// light_pick_prob without the sky: the MIS pick probability of area light
// `ltri` seen from the previous vertex (o, last_n), aimed at the hit ip
__device__ float light_pick_prob(const ShadeArgs& a, int ltri, V3 o,
                                 V3 last_n, V3 ip) {
  if (a.lt == 0) return 0.0f;
  const int L = a.lt + a.lp + a.ls + a.ld;
  float sum = 0.0f;
  for (int k = 0; k < L; ++k) sum += potential(a, k, o, last_n, ip);
  const int row = ltri < 0 ? 0 : (ltri > L - 1 ? L - 1 : ltri);
  const float p = potential(a, row, o, last_n, ip);
  return sum > 0.0f ? p / sum : 0.0f;
}

// ------------------------------------------------------- the shading data
struct Shading {
  V3 color, absorption, n_geom, n_shading;
  float roughness, transmission, eta, area, face_dir;
  int ltri;
  bool emissive, cutout;
  // the Disney path's fields (kDisney)
  V3 tangent, bitangent;
  float metallic, subsurface, specular, spec_tint, anisotropic, sheen,
      sheen_tint, clearcoat, clearcoat_gloss;
};

// get_shading_data / _shading_reattached, then _assemble_shading, for the
// fields the Lambert path reads, and with kDisney the Disney path's too
template <bool kDisney>
__device__ Shading shading_data(const ShadeArgs& a, long long i, V3 d,
                                float t, int prim, float u, float v) {
  Shading sd;
  const float w = 1.0f - u - v;
  V3 n0, n1, n2, tangent, bitangent;
  float uv0x, uv0y, uv1x, uv1y, uv2x, uv2y, al0, al1, al2, lod_base;
  float m[28];   // material_pack rows
  const long long N = a.n;
  if (a.payload) {
    const float* P = a.payload;
    const bool hit = prim >= 0;
    const V3 e1 = ldrows(P, PAY_V0 + 3, N, i), e2 = ldrows(P, PAY_V0 + 6, N, i);
    const V3 cr = cross(e1, e2);
    sd.area = hit ? 0.5f * sqrtf(cmin(dot(cr, cr), 1e-30f)) : 1.0f;
    sd.n_geom = hit ? normalize(cr) : neg(d);
    sd.ltri = hit ? (int)__ldg(P + PAY_LTRI * N + i) : -1;
    n0 = ldrows(P, PAY_N0, N, i);
    n1 = ldrows(P, PAY_N0 + 3, N, i);
    n2 = ldrows(P, PAY_N0 + 6, N, i);
    uv0x = __ldg(P + (PAY_UV0 + 0) * N + i); uv0y = __ldg(P + (PAY_UV0 + 1) * N + i);
    uv1x = __ldg(P + (PAY_UV0 + 2) * N + i); uv1y = __ldg(P + (PAY_UV0 + 3) * N + i);
    uv2x = __ldg(P + (PAY_UV0 + 4) * N + i); uv2y = __ldg(P + (PAY_UV0 + 5) * N + i);
    al0 = __ldg(P + (PAY_ALPHA + 0) * N + i);
    al1 = __ldg(P + (PAY_ALPHA + 1) * N + i);
    al2 = __ldg(P + (PAY_ALPHA + 2) * N + i);
    lod_base = __ldg(P + PAY_LOD * N + i);
    tangent = ldrows(P, PAY_TAN, N, i);
    bitangent = ldrows(P, PAY_BIT, N, i);
#pragma unroll
    for (int r = 0; r < 28; ++r) m[r] = __ldg(P + (PAY_GEO_ROWS + r) * N + i);
  } else {
    const long long p = prim < 0 ? 0 : prim;
    sd.n_geom = ld3(a.face_n, p);
    sd.area = __ldg(a.area + p);
    sd.ltri = __ldg(a.ltri + p);
    n0 = ld3(a.n0, p); n1 = ld3(a.n1, p); n2 = ld3(a.n2, p);
    uv0x = __ldg(a.uv0 + 2 * p); uv0y = __ldg(a.uv0 + 2 * p + 1);
    uv1x = __ldg(a.uv1 + 2 * p); uv1y = __ldg(a.uv1 + 2 * p + 1);
    uv2x = __ldg(a.uv2 + 2 * p); uv2y = __ldg(a.uv2 + 2 * p + 1);
    const V3 al = ld3(a.alpha, p);
    al0 = al.x; al1 = al.y; al2 = al.z;
    lod_base = __ldg(a.lod + p);
    tangent = ld3(a.tangent, p);
    bitangent = ld3(a.bitangent, p);
    const long long mi = __ldg(a.mat + p);
    const V3 col = ld3(a.m_color, mi), ab = ld3(a.m_absorption, mi);
    m[0] = col.x; m[1] = col.y; m[2] = col.z;
    m[3] = ab.x; m[4] = ab.y; m[5] = ab.z;
    m[9] = __ldg(a.m_rough + mi);
    m[16] = __ldg(a.m_transmission + mi);
    m[17] = __ldg(a.m_eta + mi);
    m[18] = (float)__ldg(a.m_flags + mi);
    m[19] = (float)__ldg(a.m_tex_diffuse + mi);
    m[20] = (float)__ldg(a.m_tex_normal + mi);
    m[21] = (float)__ldg(a.m_tex_rough + mi);
    m[22] = (float)__ldg(a.m_tex_mr + mi);
    m[27] = (float)__ldg(a.m_tex_absorption + mi);
    if (kDisney) {
      m[6] = __ldg(a.m_metallic + mi);
      m[7] = __ldg(a.m_subsurface + mi);
      m[8] = __ldg(a.m_specular + mi);
      m[10] = __ldg(a.m_spec_tint + mi);
      m[11] = __ldg(a.m_anisotropic + mi);
      m[12] = __ldg(a.m_sheen + mi);
      m[13] = __ldg(a.m_sheen_tint + mi);
      m[14] = __ldg(a.m_clearcoat + mi);
      m[15] = __ldg(a.m_clearcoat_gloss + mi);
      m[23] = (float)__ldg(a.m_tex_sheen + mi);
      m[24] = (float)__ldg(a.m_tex_clearcoat + mi);
      m[25] = (float)__ldg(a.m_tex_specular + mi);
      m[26] = (float)__ldg(a.m_tex_anisotropic + mi);
    }
  }
  const V3 n_int = normalize(add(add(scl(n0, w), scl(n1, u)), scl(n2, v)));
  const float uvx = uv0x * w + uv1x * u + uv2x * v;
  const float uvy = uv0y * w + uv1y * u + uv2y * v;
  V3 color = mk(m[0], m[1], m[2]);
  V3 absorption = mk(m[3], m[4], m[5]);
  float rough = m[9];
  const int flags = (int)m[18];
  const int tex_d = (int)m[19], tex_n = (int)m[20], tex_r = (int)m[21];
  const int tex_mr = (int)m[22], tex_ab = (int)m[27];

  // ray-cone LOD
  const float cone_width = __ldg(a.spread) * t;
  const float lam = lod_base + log2f(cmin(cone_width, 1e-20f)
                                     / cmin(fabsf(dot(d, n_int)), 1e-6f));
  sd.cutout = false;
  if ((a.base_maps & 1) && tex_d >= 0) {
    const Texel tx = fetch_trilinear(a, tex_d, uvx, uvy, lam);
    color = mk(color.x * tx.c[0], color.y * tx.c[1], color.z * tx.c[2]);
    sd.cutout = ((flags & MAT_HASALPHA) != 0) && tx.c[3] < 0.5f;
  }
  if ((a.base_maps & 4) && tex_r >= 0)
    rough = rough * fetch_trilinear(a, tex_r, uvx, uvy, lam).c[0];
  float metallic = m[6];
  if ((a.base_maps & 8) && tex_mr >= 0) {
    // glTF metallicRoughness: roughness in G, metallic in B
    const Texel mr = fetch_trilinear(a, tex_mr, uvx, uvy, lam);
    rough = m[9] * mr.c[1];
    if (kDisney) metallic = m[6] * mr.c[2];
  }
  if (((a.param_maps >> 4) & 1) && tex_ab >= 0) {
    const Texel tx = fetch_trilinear(a, tex_ab, uvx, uvy, lam);
    absorption = mk(absorption.x * tx.c[0], absorption.y * tx.c[1],
                    absorption.z * tx.c[2]);
  }

  // consistent normals, back-side flip
  const float alpha = al0 * w + al1 * u + al2 * v;
  V3 n_shading = n_int;
  if (a.consistent_normals) {
    const bool backside = dot(d, n_int) > 0.0f;
    const V3 n_c = consistent_normal(d, backside ? neg(n_int) : n_int, alpha);
    n_shading = alpha > 0.0f ? (backside ? neg(n_c) : n_c) : n_int;
  }
  if ((a.base_maps & 2) && tex_n >= 0) {
    const Texel nm = fetch_trilinear(a, tex_n, uvx, uvy, lam);
    const V3 n_tan = normalize(mk(nm.c[0] * 2.0f - 1.0f, nm.c[1] * 2.0f - 1.0f,
                                  nm.c[2] * 2.0f - 1.0f));
    V3 tb, bb;
    oriented_frame(n_shading, tangent, bitangent, tb, bb);
    n_shading = normalize(add(add(scl(tb, n_tan.x), scl(bb, n_tan.y)),
                              scl(n_shading, n_tan.z)));
  }
  sd.face_dir = dot(d, sd.n_geom) > 0.0f ? -1.0f : 1.0f;
  sd.emissive = amax(color) > 1.0f;
  sd.color = color;
  sd.absorption = absorption;
  sd.roughness = rough;
  sd.transmission = m[16];
  sd.eta = m[17];
  sd.n_shading = n_shading;
  if (kDisney) {
    // per-param texture-or-constant slots: the constant scales the texel
    float p[4] = {m[12], m[14], m[8], m[11]};   // sheen, clearcoat, specular,
#pragma unroll                                 // anisotropic: bits 0..3
    for (int k = 0; k < 4; ++k) {
      const int tid = (int)m[23 + k];
      if (((a.param_maps >> k) & 1) && tid >= 0)
        p[k] = p[k] * fetch_trilinear(a, tid, uvx, uvy, lam).c[0];
    }
    sd.metallic = metallic;
    sd.subsurface = m[7];
    sd.specular = p[2];
    sd.spec_tint = m[10];
    sd.anisotropic = p[3];
    sd.sheen = p[0];
    sd.sheen_tint = m[13];
    sd.clearcoat = p[1];
    sd.clearcoat_gloss = m[15];
    sd.tangent = tangent;
    sd.bitangent = bitangent;
  }
  return sd;
}

// ----------------------------------------------------- render/bsdf_lambert.py
__device__ __forceinline__ float sqrt0(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

__device__ __forceinline__ float fr_l(float v_dot_n, float eio) {
  if (v_dot_n < 0.0f) eio = 1.0f / eio;
  v_dot_n = fabsf(v_dot_n);
  const float sin_t2 = eio * eio * (1.0f - v_dot_n * v_dot_n);
  const float l_dot_n = sqrt0(1.0f - sin_t2);
  const float r1 = (v_dot_n - eio * l_dot_n)
                   / cmin(v_dot_n + eio * l_dot_n, 1e-20f);
  const float r2 = (l_dot_n - eio * v_dot_n)
                   / cmin(l_dot_n + eio * v_dot_n, 1e-20f);
  return sin_t2 > 1.0f ? 1.0f : 0.5f * (r1 * r1 + r2 * r2);
}

struct BsdfSample { V3 wi, bsdf; float pdf; bool specular; };

// sample (lambert.h:72-125) with wo = -d
__device__ BsdfSample lambert_sample(const Shading& sd, V3 d, float dist,
                                     float r3, float r4) {
  const V3 wo = neg(d);
  const float flip = dot(wo, sd.n_geom) < 0.0f ? -1.0f : 1.0f;
  const V3 i_n = scl(sd.n_shading, flip);
  const float eio = flip < 0.0f ? 1.0f / cmin(sd.eta, 1e-6f) : sd.eta;
  const float f = fr_l(dot(i_n, wo), eio);
  const float two_d = dist * 2.0f;
  const V3 beer = mk(expf(-sd.absorption.x * two_d),
                     expf(-sd.absorption.y * two_d),
                     expf(-sd.absorption.z * two_d));
  const V3 wi_refl = sub(neg(wo), scl(i_n, 2.0f * dot(neg(wo), i_n)));
  const V3 cb = mul(sd.color, beer);
  const float refl_cos = cmin(fabsf(dot(i_n, wi_refl)), 1e-9f);
  // _refract_l(wo, i_n, eio)
  const float cos_i = fabsf(dot(i_n, wo));
  const float sin2_i = cmin(1.0f - cos_i * cos_i, 0.0f);
  const float sin2_t = eio * eio * sin2_i;
  const bool refr_ok = sin2_t < 1.0f;
  const float cos_t = sqrt0(1.0f - sin2_t);
  const V3 wt = add(scl(neg(wo), eio), scl(i_n, eio * cos_i - cos_t));
  const float refr_cos = cmin(fabsf(dot(i_n, wt)), 1e-9f);
  const bool t_reflects = r3 < f;

  const float p_reflect = 1.0f - sd.roughness;
  const bool pure_spec = r3 < p_reflect;
  const bool transmit = r4 < sd.transmission;
  BsdfSample s;
  if (transmit) {
    s.wi = t_reflects ? wi_refl : wt;
    if (t_reflects)
      s.bsdf = mk(cb.x / refl_cos, cb.y / refl_cos, cb.z / refl_cos);
    else if (refr_ok)
      s.bsdf = mk(cb.x / refr_cos, cb.y / refr_cos, cb.z / refr_cos);
    else
      s.bsdf = mk(0.f, 0.f, 0.f);
    s.pdf = 1.0f;
  } else if (pure_spec) {
    s.wi = wi_refl;
    s.bsdf = mk(sd.color.x / refl_cos, sd.color.y / refl_cos,
                sd.color.z / refl_cos);
    s.pdf = 1.0f;
  } else {
    const float r5 = (r3 - p_reflect) / cmin(1.0f - p_reflect, 1e-9f);
    const float r6 = (r4 - sd.transmission)
                     / cmin(1.0f - sd.transmission, 1e-9f);
    // cosine_hemisphere(r5, r6), tangent_to_world about i_n
    const float term1 = TWO_PI * r5;
    const float term2 = sqrtf(cmin(1.0f - r6, 0.0f));
    const float sr = sqrtf(cmin(r6, 0.0f));
    const V3 h = mk(cosf(term1) * sr, sinf(term1) * sr, term2);
    V3 tt, bb;
    onb(i_n, tt, bb);
    s.wi = normalize(add(add(scl(tt, h.x), scl(bb, h.y)), scl(i_n, h.z)));
    s.bsdf = scl(sd.color, INV_PI);
    s.pdf = cmin(dot(s.wi, i_n), 0.0f) * INV_PI;
  }
  s.specular = transmit || pure_spec;
  if (dot(scl(sd.n_geom, flip), s.wi) <= 0.0f) s.pdf = 0.0f;
  return s;
}

// ------------------------------------------------------ render/bsdf_disney.py
__device__ __forceinline__ float clamp01(float x) {   // NaN stays NaN
  return x != x ? x : (x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x));
}
__device__ __forceinline__ float schlick(float u) {
  const float m = clamp01(1.0f - u);
  const float m2 = m * m;
  return m2 * m2 * m;
}

// GGX (ggxmdf.h) on tangent-space z-up vectors
__device__ float ggx_d(float mx, float my, float mz, float ax, float ay) {
  const float c2 = mz * mz;
  const float s = sqrt0(1.0f - c2);
  const float c4 = c2 > 1e-12f ? c2 * c2 : 1.0f;
  const float tan2 = (1.0f - c2) / cmin(c2, 1e-12f);
  const bool iso = fabsf(ax - ay) < 1e-7f || s == 0.0f;
  const float cp = mx / cmin(s * ax, 1e-12f);
  const float sp = my / cmin(s * ay, 1e-12f);
  const float aa = iso ? 1.0f / (ax * ax) : cp * cp + sp * sp;
  const float tmp = 1.0f + tan2 * aa;
  const float d = 1.0f / (PI_F * ax * ay * c4 * tmp * tmp);
  return c2 > 1e-12f ? d : ax * ax * INV_PI;
}

__device__ float ggx_lambda(float vx, float vy, float vz, float ax,
                            float ay) {
  if (!(fabsf(vz) > 1e-12f)) return 0.0f;
  const float c2 = vz * vz;
  const float s = sqrt0(1.0f - c2);
  const bool iso = fabsf(ax - ay) < 1e-7f || s == 0.0f;
  const float cp = vx / cmin(s, 1e-12f);
  const float sp = vy / cmin(s, 1e-12f);
  const float alpha = iso ? ax : sqrt0(cp * cp * ax * ax + sp * sp * ay * ay);
  const float tan2 = (s * s) / cmin(c2, 1e-12f);
  return 0.5f * (-1.0f + sqrtf(1.0f + alpha * alpha * tan2));
}

// the GGX visible-normal sample (ggxmdf.h:102-121) about local wo = v
__device__ V3 ggx_sample(float vx, float vy, float vz, float r0, float r1,
                         float ax, float ay) {
  const float sign = vz < 0.0f ? -1.0f : 1.0f;
  float sx = sign * vx * ax, sy = sign * vy * ay, sz = sign * vz;
  float inv = rsqrtf(cmin(sx * sx + sy * sy + sz * sz, 1e-20f));
  sx = sx * inv; sy = sy * inv; sz = sz * inv;
  const float denom = sqrtf(cmin(sx * sx + sy * sy, 1e-20f));
  const bool straight = vz >= 0.9999f;
  const float t1x = straight ? 1.0f : sy / denom;
  const float t1y = straight ? 0.0f : -sx / denom;
  const float t1z = 0.0f * t1x;
  const float t2x = t1y * sz - t1z * sy;
  const float t2y = t1z * sx - t1x * sz;
  const float t2z = t1x * sy - t1y * sx;
  const float a = 1.0f / (1.0f + sz);
  const float r = sqrtf(cmin(r0, 0.0f));
  const bool low = r1 < a;
  const float phi = low ? r1 / cmin(a, 1e-9f) * PI_F
                        : PI_F + (r1 - a) / cmin(1.0f - a, 1e-9f) * PI_F;
  const float p1 = r * cosf(phi);
  const float p2 = r * sinf(phi) * (low ? 1.0f : sz);
  const float p3 = sqrtf(cmin(1.0f - p1 * p1 - p2 * p2, 0.0f));
  const float hx = p1 * t1x + p2 * t2x + p3 * sx;
  const float hy = p1 * t1y + p2 * t2y + p3 * sy;
  const float hz = p1 * t1z + p2 * t2z + p3 * sz;
  const float mx = hx * ax, my = hy * ay, mz = cmin(hz, 0.0f);
  inv = rsqrtf(cmin(mx * mx + my * my + mz * mz, 1e-20f));
  return mk(mx * inv, my * inv, mz * inv);
}

// GTR1 with alpha already clamped: a2 = alpha^2, log_a2 = log(a2)
__device__ __forceinline__ float gtr1_d(float mz, float a2, float log_a2) {
  const float a = (a2 - 1.0f) / (PI_F * log_a2);
  const float b = 1.0f / (1.0f + (a2 - 1.0f) * mz * mz);
  return a * b;
}

__device__ float gtr1_lambda(float vz, float a2, float log_a2) {
  const float c2 = vz * vz;
  const float s = sqrt0(1.0f - c2);
  if (!(fabsf(vz) > 1e-9f && s > 1e-9f)) return 0.0f;
  const float cot2 = c2 / cmin(s * s, 1e-12f);
  const float cot = sqrt0(cot2);
  const float a = sqrtf(cot2 + a2);
  const float b = sqrtf(cot2 + 1.0f);
  const float c = logf(cmin(cot + b, 1e-20f));
  const float dd = logf(cmin(cot + a, 1e-20f));
  return (a - b + cot * (c - dd)) / (cot * log_a2);
}

__device__ V3 gtr1_sample(float r0, float r1, float a2) {
  const float a = 1.0f - powf(a2, 1.0f - r0);
  const float c2 = a / (1.0f - a2);
  const float cz = sqrtf(cmin(c2, 0.0f));
  const float s = sqrt0(1.0f - c2);
  const float phi = TWO_PI * r1;
  return mk(s * cosf(phi), s * sinf(phi), cz);
}

// what a lane's Disney BSDF computes once, whatever the directions:
// _lobe_weights, tint_and_luminance's tint, _spec_alphas, the clamped
// _clearcoat_alpha, and the tint mixes of _spec_fresnel and _evaluate_sheen
struct DisneyLane {
  V3 spec0, sheen0;
  float w_d, w_sh, w_sp, w_c, ax, ay, a2, log_a2, omm;
};

__device__ DisneyLane disney_lane(const Shading& sd) {
  DisneyLane L;
  const V3 c = sd.color;
  const float y = 0.212671f * c.x + 0.715160f * c.y + 0.072169f * c.z;
  const float yc = cmin(y, 1e-9f);
  const V3 tint = y > 0.0f ? mk(c.x / yc, c.y / yc, c.z / yc)
                           : mk(1.0f, 1.0f, 1.0f);
  L.omm = 1.0f - sd.metallic;
  const float w0 = y * L.omm;
  const float w1 = sd.sheen * L.omm;
  const float w2 = sd.specular + sd.metallic * (1.0f - sd.specular);
  const float w3 = sd.clearcoat * 0.25f;
  const float total = cmin(w0 + w1 + w2 + w3, 1e-9f);
  L.w_d = w0 / total;
  L.w_sh = w1 / total;
  L.w_sp = w2 / total;
  L.w_c = w3 / total;
  const float sq = sd.roughness * sd.roughness;
  const float aspect =
      sqrtf(1.0f + sd.anisotropic * (sd.anisotropic < 0.0f ? 0.9f : -0.9f));
  L.ax = cmin(sq / aspect, 0.001f);
  L.ay = cmin(sq * aspect, 0.001f);
  float alpha = 0.1f + -0.099f * sd.clearcoat_gloss;
  alpha = alpha != alpha ? alpha
          : (alpha < 0.001f ? 0.001f : (alpha > 0.999f ? 0.999f : alpha));
  L.a2 = alpha * alpha;
  L.log_a2 = logf(L.a2);
  const float st = sd.spec_tint, sp8 = sd.specular * 0.08f;
  const V3 v = mk(((1.0f - st) + st * tint.x) * sp8,
                  ((1.0f - st) + st * tint.y) * sp8,
                  ((1.0f - st) + st * tint.z) * sp8);
  L.spec0 = add(scl(v, L.omm), scl(c, sd.metallic));
  const float sh = sd.sheen_tint;
  L.sheen0 = mk((1.0f - sh) + sh * tint.x, (1.0f - sh) + sh * tint.y,
                (1.0f - sh) + sh * tint.z);
  return L;
}

// the four lobes' values and pdfs at (wo, wi) about i_n in the frame
// (t, b): _evaluate_diffuse, _evaluate_sheen, _evaluate_mf (GGX, GTR1)
struct Lobes { V3 v[4]; float p[4]; };

__device__ Lobes disney_lobes(const Shading& sd, const DisneyLane& L, V3 i_n,
                              V3 t, V3 b, V3 wo, V3 wi) {
  Lobes r;
  {   // diffuse (disney.h:137-165)
    const V3 h = normalize(add(wi, wo));
    const float cos_on = dot(i_n, wo), cos_in = dot(i_n, wi);
    const float cos_ih = dot(wi, h);
    const float fl = schlick(cos_in), fv = schlick(cos_on);
    const float fd90 = 0.5f + 2.0f * cos_ih * cos_ih * sd.roughness;
    float fd = (1.0f + (fd90 - 1.0f) * fl) * (1.0f + (fd90 - 1.0f) * fv);
    fd = sd.subsurface != 1.0f ? fd : 0.0f;
    const float fss90 = cos_ih * cos_ih * sd.roughness;
    const float fss = (1.0f + (fss90 - 1.0f) * fl)
                      * (1.0f + (fss90 - 1.0f) * fv);
    const float ss = 1.25f * (fss * (1.0f / cmin(fabsf(cos_on) + fabsf(cos_in),
                                                 1e-9f) - 0.5f) + 0.5f);
    fd = fd + sd.subsurface * (ss - fd);
    r.v[0] = scl(sd.color, fd * INV_PI * L.omm);
    r.p[0] = fabsf(cos_in) * INV_PI;
  }
  {   // sheen (disney.h:180-190; h from wo + wo, the reference's quirk)
    const float fh = schlick(dot(wi, normalize(add(wo, wo))));
    r.v[1] = scl(L.sheen0, fh * sd.sheen * L.omm);
    r.p[1] = 0.15915494309189535f;   // 1 / (2 pi)
  }
  // the microfacet lobes (disney.h:118-135) in the local frame
  const float wox = dot(wo, t), woy = dot(wo, b), woz = dot(wo, i_n);
  const float wix = dot(wi, t), wiy = dot(wi, b), wiz = dot(wi, i_n);
  const float msx = wix + wox, msy = wiy + woy, msz = wiz + woz;
  const float inv = rsqrtf(cmin(msx * msx + msy * msy + msz * msz, 1e-20f));
  const float mx = msx * inv, my = msy * inv, mz = msz * inv;
  const float cos_oh = wox * mx + woy * my + woz * mz;
  const float den4 = cmin(fabsf(4.0f * cos_oh), 1e-9f);
  const float denom = cmin(fabsf(4.0f * woz * wiz), 1e-9f);
  const bool ok = fabsf(woz) > 1e-9f && fabsf(wiz) > 1e-9f
                  && fabsf(cos_oh) > 1e-9f;
  const float f = schlick(fabsf(cos_oh));
  {   // specular: GGX
    const float d = ggx_d(mx, my, mz, L.ax, L.ay);
    const float lo = ggx_lambda(wox, woy, woz, L.ax, L.ay);
    const float g = 1.0f / (1.0f + lo + ggx_lambda(wix, wiy, wiz, L.ax, L.ay));
    const float g1 = 1.0f / (1.0f + lo);
    const float vm = fabsf(wox * mx + woy * my + woz * mz);
    const float pdf = fabsf(woz) > 1e-12f ? g1 * vm * d / fabsf(woz) : 0.0f;
    const float dg = d * g / denom;
    r.v[2] = ok ? mk(((1.0f - f) * L.spec0.x + f) * dg,
                     ((1.0f - f) * L.spec0.y + f) * dg,
                     ((1.0f - f) * L.spec0.z + f) * dg)
                : mk(0.f, 0.f, 0.f);
    r.p[2] = ok ? pdf / den4 : 0.0f;
  }
  {   // clearcoat: GTR1
    const float d = gtr1_d(mz, L.a2, L.log_a2);
    const float g = 1.0f / (1.0f + gtr1_lambda(woz, L.a2, L.log_a2)
                            + gtr1_lambda(wiz, L.a2, L.log_a2));
    const float fc = (0.04f + 0.96f * f) * 0.25f * sd.clearcoat;
    const float v = fc * (d * g / denom);
    r.v[3] = ok ? mk(v, v, v) : mk(0.f, 0.f, 0.f);
    r.p[3] = ok ? d * fabsf(mz) / den4 : 0.0f;
  }
  return r;
}

// sample_mf (disney.h:96-116): reflect wo about the sampled microfacet
// normal, then force the direction above the geometric surface
__device__ V3 disney_sample_mf(const DisneyLane& L, V3 i_n, V3 t, V3 b,
                               V3 n_flip, V3 wo, float r0, float r1,
                               bool ggx) {
  const float wox = dot(wo, t), woy = dot(wo, b), woz = dot(wo, i_n);
  const V3 m = ggx ? ggx_sample(wox, woy, woz, r0, r1, L.ax, L.ay)
                   : gtr1_sample(r0, r1, L.a2);
  const float k = 2.0f * (wox * m.x + woy * m.y + woz * m.z);
  V3 wi = add(add(scl(t, k * m.x - wox), scl(b, k * m.y - woy)),
              scl(i_n, k * m.z - woz));
  const float corr = 1e-4f - dot(wi, n_flip);
  if (corr > 0.0f) wi = normalize(add(wi, scl(n_flip, corr)));
  return wi;
}

struct Disney {
  static constexpr bool kDisney = true;
  typedef DisneyLane Lane;
  static __device__ __forceinline__ Lane prepare(const Shading& sd) {
    return disney_lane(sd);
  }

  // evaluate (disney.h:298-335) toward the light, on the lanes whose
  // connection can count (`want`; the others' potential is 0 whatever the
  // BSDF gives, and the shade stage masks it so)
  static __device__ __forceinline__ void nee(
      const Shading& sd, const Lane& L, V3 d, V3 l_dir, bool cur_spec,
      bool want, V3& e_bsdf, float& e_pdf) {
    e_bsdf = mk(0.f, 0.f, 0.f);
    e_pdf = 0.0f;
    if (!want || cur_spec) return;
    V3 t, b;
    oriented_frame(sd.n_shading, sd.tangent, sd.bitangent, t, b);
    const Lobes r = disney_lobes(sd, L, sd.n_shading, t, b, neg(d), l_dir);
    const bool u0 = L.w_d > 0.0f, u1 = L.w_sh > 0.0f;
    const bool u2 = L.w_sp > 0.0f && r.p[2] > 0.0f;
    const bool u3 = L.w_c > 0.0f && r.p[3] > 0.0f;
    const V3 z = mk(0.f, 0.f, 0.f);
    e_bsdf = add(add(add(u0 ? r.v[0] : z, u1 ? r.v[1] : z), u2 ? r.v[2] : z),
                 u3 ? r.v[3] : z);
    e_pdf = (u0 ? L.w_d * r.p[0] : 0.0f) + (u1 ? L.w_sh * r.p[1] : 0.0f)
            + (L.w_sp > 0.0f ? L.w_sp * r.p[2] : 0.0f)
            + (L.w_c > 0.0f ? L.w_c * r.p[3] : 0.0f);
  }

  // sample (disney.h:203-297) with wo = -d, on the lanes that may extend
  // (the others' sample is never read); `lobe` the pick, an index into
  // utils/telemetry.py LOBES, or -1 where none is counted
  static __device__ __forceinline__ BsdfSample sample(
      const Shading& sd, const Lane& L, V3 d, float dist, float r3, float r4,
      bool may_extend, int& lobe) {
    BsdfSample s;
    lobe = -1;
    if (!may_extend) {
      s.wi = d;
      s.bsdf = mk(0.f, 0.f, 0.f);
      s.pdf = 0.0f;
      s.specular = false;
      return s;
    }
    const V3 wo = neg(d);
    const float flip = dot(wo, sd.n_geom) < 0.0f ? -1.0f : 1.0f;
    const V3 i_n = scl(sd.n_shading, flip);
    const V3 n_flip = scl(sd.n_geom, flip);
    s.specular = r4 < sd.transmission;
    if (s.specular) {
      // the dielectric (shared with lambert; disney.h:211-234)
      lobe = 4;
      const float eio = flip < 0.0f ? 1.0f / cmin(sd.eta, 1e-6f) : sd.eta;
      const float f = fr_l(dot(i_n, wo), eio);
      const float two_d = dist * 2.0f;
      const V3 cb = mul(sd.color, mk(expf(-sd.absorption.x * two_d),
                                     expf(-sd.absorption.y * two_d),
                                     expf(-sd.absorption.z * two_d)));
      if (r3 < f) {
        s.wi = sub(neg(wo), scl(i_n, 2.0f * dot(neg(wo), i_n)));
        const float c = cmin(fabsf(dot(i_n, s.wi)), 1e-9f);
        s.bsdf = mk(cb.x / c, cb.y / c, cb.z / c);
        s.pdf = dot(n_flip, s.wi) > 0.0f ? 1.0f : 0.0f;
      } else {
        // _refract_l(wo, i_n, eio)
        const float cos_i = fabsf(dot(i_n, wo));
        const float sin2_t = eio * eio * cmin(1.0f - cos_i * cos_i, 0.0f);
        const float cos_t = sqrt0(1.0f - sin2_t);
        s.wi = add(scl(neg(wo), eio), scl(i_n, eio * cos_i - cos_t));
        const float c = cmin(fabsf(dot(i_n, s.wi)), 1e-9f);
        s.bsdf = sin2_t < 1.0f ? mk(cb.x / c, cb.y / c, cb.z / c)
                               : mk(0.f, 0.f, 0.f);
        s.pdf = 1.0f;
      }
      return s;
    }
    // the lobe CDF and the picked lobe's renormalised random
    const float r3n = (r4 - sd.transmission)
                      / cmin(1.0f - sd.transmission, 1e-9f);
    const float c0 = L.w_d, c1 = L.w_d + L.w_sh, c2 = L.w_d + L.w_sh + L.w_sp;
    const bool pick_d = r3n < c0;
    const bool pick_sh = r3n >= c0 && r3n < c1;
    const bool pick_sp = r3n >= c1 && r3n < c2;
    const bool pick_c = r3n >= c2;
    lobe = (int)!pick_d + (int)(r3n >= c1) + (int)pick_c;
    const float r2 =
        pick_d ? r3n / cmin(c0, 1e-9f)
        : pick_sh ? (r3n - c0) / cmin(c1 - c0, 1e-9f)
        : pick_sp ? (r3n - c1) / cmin(c2 - c1, 1e-9f)
                  : (r3n - c2) / cmin(1.0f - c2, 1e-9f);
    V3 t, b;
    oriented_frame(i_n, sd.tangent, sd.bitangent, t, b);
    if (pick_sp || pick_c) {
      s.wi = disney_sample_mf(L, i_n, t, b, n_flip, wo, r2, r3, pick_sp);
    } else {
      // cosine_hemisphere(r2, r3) in the frame
      const float term1 = TWO_PI * r2;
      const float term2 = sqrtf(cmin(1.0f - r3, 0.0f));
      const float sr = sqrtf(cmin(r3, 0.0f));
      s.wi = normalize(add(add(scl(t, cosf(term1) * sr),
                               scl(b, sinf(term1) * sr)), scl(i_n, term2)));
    }
    // all four lobes at the sampled direction (MIS inside the BSDF)
    const Lobes r = disney_lobes(sd, L, i_n, t, b, wo, s.wi);
    const V3 z = mk(0.f, 0.f, 0.f);
    s.bsdf = add(add(add(L.w_d > 0.0f ? r.v[0] : z, L.w_sh > 0.0f ? r.v[1] : z),
                     L.w_sp > 0.0f ? r.v[2] : z),
                 L.w_c > 0.0f ? r.v[3] : z);
    s.pdf = L.w_d * r.p[0] + L.w_sh * r.p[1] + L.w_sp * r.p[2]
            + L.w_c * r.p[3];
    // a sampled direction below the surface is a dead sample
    if (dot(s.wi, i_n) <= 0.0f && !(pick_sp || pick_c)) s.pdf = 0.0f;
    return s;
  }
};

struct Lambert {
  static constexpr bool kDisney = false;
  struct Lane {};
  static __device__ __forceinline__ Lane prepare(const Shading&) {
    return Lane();
  }
  // evaluate toward the light, scaled by the roughness
  // (BSDF_HAS_PURE_SPECULARS, lambert.h:19-30)
  static __device__ __forceinline__ void nee(
      const Shading& sd, const Lane&, V3, V3 l_dir, bool cur_spec, bool,
      V3& e_bsdf, float& e_pdf) {
    e_pdf = cur_spec ? 0.0f : fabsf(dot(l_dir, sd.n_shading)) * INV_PI;
    e_bsdf = scl(cur_spec ? mk(0.f, 0.f, 0.f) : scl(sd.color, INV_PI),
                 sd.roughness);
  }
  static __device__ __forceinline__ BsdfSample sample(
      const Shading& sd, const Lane&, V3 d, float dist, float r3, float r4,
      bool, int& lobe) {
    lobe = -1;
    return lambert_sample(sd, d, dist, r3, r4);
  }
};

// ------------------------------------------------------------- the kernels
// The shade stage of lane i (render/wavefront.py _shade_composed) under the
// BSDF B; `cam_out` is this bounce's camera seed. Returns the lobe the lane
// picked where it may extend (B = Disney), else -1.
template <class B>
__device__ __forceinline__ int shade_lane(const ShadeArgs& a, long long i,
                                          uint32_t cam_out) {
  const float geo_eps = a.geo_eps;
  const long long li = a.depth ? __ldg(a.depth + i) : (long long)a.li;
  const long long path_length = li + 1;
  const bool is_primary = li == 0;
  const V3 o = ld3(a.o, i), d = ld3(a.d, i);
  const bool alive = __ldg(a.alive + i) != 0;
  const V3 tp0 = ld3(a.tp, i);
  const float bsdf_pdf = __ldg(a.pdf + i);
  const V3 last_n = ld3(a.last_n, i);
  const bool prev_spec = __ldg(a.prev_spec + i) != 0;
  const int n_diffuse = __ldg(a.n_diffuse + i);
  const int prim = alive ? __ldg(a.prim + i) : -1;
  float t = __ldg(a.t + i);
  const float u = __ldg(a.u + i), v = __ldg(a.v + i);
  float acc_r = __ldg(a.acc + 4 * i), acc_g = __ldg(a.acc + 4 * i + 1);
  float acc_b = __ldg(a.acc + 4 * i + 2), acc_w = __ldg(a.acc + 4 * i + 3);

  // primary depth into .w; sanitise t
  const float depth = prim >= 0 ? t : 10000.0f;
  t = prim >= 0 ? t : 1.0f;
  acc_w = acc_w + ((is_primary && alive) ? depth : 0.0f);

  // sky on miss: the nearest texel (render/sky.py sample_skydome)
  const bool miss = alive && prim < 0;
  {
    const float uf = (float)a.sky_w * 0.5f
                     * (1.0f + atan2f(d.x, -d.z) * INV_PI);
    const float cy = d.y != d.y ? d.y : (d.y < -1.0f ? -1.0f
                                         : (d.y > 1.0f ? 1.0f : d.y));
    const float vf = (float)a.sky_h * acosf(cy) * INV_PI;
    long long su = (long long)uf, sv = (long long)vf;
    su = su < 0 ? 0 : (su > a.sky_w - 1 ? a.sky_w - 1 : su);
    sv = sv < 0 ? 0 : (sv > a.sky_h - 1 ? a.sky_h - 1 : sv);
    const V3 sky_rad = mul(tp0, ld3(a.sky, sv * a.sky_w + su));
    V3 sky_c = mdiv(sky_rad, bsdf_pdf, miss);
    if (a.clamp_fireflies) sky_c = clamp_intensity(sky_c, a.clamp_value);
    sky_c = fixnan(sky_c);
    acc_r = acc_r + (miss ? sky_c.x : 0.0f);
    acc_g = acc_g + (miss ? sky_c.y : 0.0f);
    acc_b = acc_b + (miss ? sky_c.z : 0.0f);
  }
  const bool to_direct = n_diffuse == 0;

  bool hit = alive && prim >= 0;
  const V3 ip = add(o, scl(d, t));
  Shading sd = shading_data<B::kDisney>(a, i, d, t, prim, u, v);

  // alpha cutout -> passthrough
  const bool cutout = hit && sd.cutout;
  const bool pass_ok = cutout && path_length < a.max_path;
  hit = hit && !cutout;

  // implicit light hit, MIS against NEE
  {
    const float ddotnl = -dot(d, sd.n_geom);
    const bool lit = hit && sd.emissive && ddotnl > 0.0f;
    const float l_pdf = (t * t) / (-dot(d, sd.n_geom) * sd.area);
    const float pick_p = light_pick_prob(a, sd.ltri, o, last_n, ip);
    const float denom_mis = bsdf_pdf + l_pdf * pick_p;
    const V3 tc = mul(tp0, sd.color);
    const V3 c_mis = mdiv(tc, denom_mis, lit && denom_mis > 0.0f);
    const V3 c_spec = mdiv(tc, bsdf_pdf, lit);
    V3 c_light = prev_spec ? c_spec : c_mis;
    if (a.clamp_fireflies) c_light = clamp_intensity(c_light, a.clamp_value);
    c_light = fixnan(c_light);
    acc_r = acc_r + (lit ? c_light.x : 0.0f);
    acc_g = acc_g + (lit ? c_light.y : 0.0f);
    acc_b = acc_b + (lit ? c_light.z : 0.0f);
  }
  a.acc_out[4 * i] = acc_r;
  a.acc_out[4 * i + 1] = acc_g;
  a.acc_out[4 * i + 2] = acc_b;
  a.acc_out[4 * i + 3] = acc_w;

  const bool active = hit && !sd.emissive;
  const bool cur_spec = sd.transmission > SPECULAR_TRANSMISSION
                        || sd.roughness <= SPECULAR_ROUGHNESS;
  const uint32_t r0_frame = cam_out + 91771u * (uint32_t)path_length;
  uint32_t seed = wang_hash((uint32_t)__ldg(a.path_idx + i) * 17u + r0_frame);
  const float face_dir = sd.face_dir;
  if (face_dir == 1.0f) sd.absorption = mk(0.f, 0.f, 0.f);
  const V3 tp = mdiv(tp0, bsdf_pdf, active);
  const V3 fn_flip = scl(sd.n_shading, face_dir);

  const long long pixel = __ldg(a.pixel + i);
  const long long bn_px = pixel % a.width, bn_py = pixel / a.width;
  const long long smp_idx = __ldg(a.sample + i);
  const long long bn_dim0 = 4 * path_length;
#define BN_OR(r, dim, cap)                                                  \
  ((a.bn_mask && smp_idx < (cap))                                           \
       ? bn_sample(a.bn_mask, bn_px, bn_py, smp_idx, bn_dim0 + (dim))       \
       : (r))

  // NEE
  float r0 = random_float(seed);
  float r1 = random_float(seed);
  r0 = BN_OR(r0, 4, 2);
  r1 = BN_OR(r1, 5, 2);
  const bool nee_mask = active && !cur_spec;
  const LightSample ls = random_point_on_light(a, r0, r1, ip, fn_flip);
  const V3 l_vec = sub(ls.point, ip);
  const float dist = sqrtf(cmin(dot(l_vec, l_vec), 1e-20f));
  const V3 l_dir = mk(l_vec.x / dist, l_vec.y / dist, l_vec.z / dist);
  const float n_dot_l = dot(l_dir, fn_flip);
  const typename B::Lane lane = B::prepare(sd);
  V3 e_bsdf;
  float e_pdf;
  B::nee(sd, lane, d, l_dir, cur_spec,
         nee_mask && n_dot_l > 0.0f && ls.light_pdf > 0.0f, e_bsdf, e_pdf);
  const bool conn_ok = nee_mask && n_dot_l > 0.0f && ls.light_pdf > 0.0f
                       && e_pdf > 0.0f;
  const float denom = ls.pick_prob * ls.light_pdf + e_pdf;
  V3 potential = fixnan(scl(mul(mul(tp, e_bsdf), ls.color),
                            mdiv(n_dot_l, denom, conn_ok)));
  if (a.clamp_fireflies) potential = clamp_intensity(potential, a.clamp_value);
  const V3 ng_face = scl(sd.n_geom, face_dir);
  st3(a.sh_o, i, safe_origin(ip, l_dir, ng_face, geo_eps));
  st3(a.sh_d, i, l_dir);
  a.sh_tmax[i] = conn_ok ? dist - 2.0f * geo_eps : 0.0f;
  st3(a.sh_pot, i, potential);
  a.sh_conn[i] = conn_ok;
  a.sh_direct[i] = to_direct;

  // bounce
  const bool may_extend = active && n_diffuse < a.max_diffuse
                          && path_length < a.max_path;
  float r3 = random_float(seed);
  float r4 = random_float(seed);
  r3 = BN_OR(r3, 6, 256);
  r4 = BN_OR(r4, 7, 256);
#undef BN_OR
  int lobe;
  const BsdfSample smp = B::sample(sd, lane, d, t, r3, r4, may_extend, lobe);
  const bool ok_pdf = smp.pdf >= EPS_PDF && isfinite(smp.pdf);

  // russian roulette
  const float r5 = random_float(seed);
  const bool bounced = n_diffuse > 0;
  const float surv = cmax(amax(smp.bsdf), 1.0f);
  const float p_surv = (!a.russian_roulette || smp.specular || !bounced)
                       ? 1.0f : surv;
  const bool extend = may_extend && ok_pdf && r5 <= p_surv;
  const V3 new_tp = fixnan(scl(mul(mdiv(tp, p_surv, extend), smp.bsdf),
                               fabsf(dot(sd.n_shading, smp.wi))));
  const V3 new_o = safe_origin(ip, smp.wi, ng_face, geo_eps);
  const V3 pass_o = add(ip, scl(d, geo_eps));

  st3(a.o_out, i, extend ? new_o : (pass_ok ? pass_o : o));
  st3(a.d_out, i, extend ? smp.wi : d);
  st3(a.tp_out, i, extend ? new_tp : (pass_ok ? tp0 : tp));
  a.pdf_out[i] = extend ? smp.pdf : (pass_ok ? bsdf_pdf : 1.0f);
  st3(a.last_n_out, i, extend ? fn_flip : last_n);
  a.prev_spec_out[i] = extend ? smp.specular : prev_spec;
  a.n_diffuse_out[i] = n_diffuse + (extend && !smp.specular ? 1 : 0);
  a.alive_out[i] = extend || pass_ok;
  return lobe;
}

__global__ void __launch_bounds__(BLOCK)
shade_bounce_kernel(const __grid_constant__ ShadeArgs a) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const uint32_t cam_in = (uint32_t)__ldg(a.cam_seed);
  const uint32_t cam_out = xorshift32(cam_in);
  if (i == 0) *a.cam_seed_out = (long long)cam_out;
  if (i >= a.n) return;
  shade_lane<Lambert>(a, i, cam_out);
}

// The Disney kernel adds the block's lobe picks to a.lobes (when given)
// from shared memory: at most one atomic a lobe a block.
__global__ void __launch_bounds__(BLOCK)
shade_disney_kernel(const __grid_constant__ ShadeArgs a) {
  __shared__ unsigned int picks[N_LOBES];
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const uint32_t cam_in = (uint32_t)__ldg(a.cam_seed);
  const uint32_t cam_out = xorshift32(cam_in);
  if (i == 0) *a.cam_seed_out = (long long)cam_out;
  if (a.lobes && threadIdx.x < N_LOBES) picks[threadIdx.x] = 0u;
  if (a.lobes) __syncthreads();
  const int lobe = i < a.n ? shade_lane<Disney>(a, i, cam_out) : -1;
  if (!a.lobes) return;
  if (lobe >= 0) atomicAdd(&picks[lobe], 1u);
  __syncthreads();
  if (threadIdx.x < N_LOBES && picks[threadIdx.x])
    atomicAdd(a.lobes + threadIdx.x, (unsigned long long)picks[threadIdx.x]);
}

// ------------------------------------------------------------- the launch
extern "C" int lh2_shade_bounce(const ShadeArgs* args, void* stream) {
  const int grid = args->n > 0 ? (args->n + BLOCK - 1) / BLOCK : 1;
  shade_bounce_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int lh2_shade_disney(const ShadeArgs* args, void* stream) {
  const int grid = args->n > 0 ? (args->n + BLOCK - 1) / BLOCK : 1;
  shade_disney_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// The layout the kernel assumes, for the loader to check against Python:
// the payload rows, MAT_HASALPHA and sizeof(ShadeArgs).
extern "C" const char* lh2_shade_layout() {
  static char buf[160];
  snprintf(buf, sizeof buf, "%d %d %d %d %d %d %d %d %d %d %d %d %d", PAY_V0,
           PAY_N0, PAY_UV0, PAY_ALPHA, PAY_MAT, PAY_LTRI, PAY_LOD, PAY_TAN,
           PAY_BIT, PAY_GEO_ROWS, PAY_ROWS, MAT_HASALPHA,
           (int)sizeof(ShadeArgs));
  return buf;
}
