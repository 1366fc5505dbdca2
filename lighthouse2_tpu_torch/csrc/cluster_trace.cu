// Cluster-tile closest-hit and any-hit trace kernels for Hopper (sm_90a).
//
// What they replace. lighthouse2_tpu/render/kernels/trace.py:
//   lh2_cluster_closest  <- _make_closest_kernel (with _make_next_leaf,
//                           _frustum_hit, _lane_slab, _sub_forms, _sub_hits)
//   lh2_cluster_occluded <- _make_anyhit_kernel
// both launched there by _trace_chunk. They take the Pallas kernels' own
// inputs: the ClusterBVH's top tree (boxes [8, M] f32, meta [4, M] int32),
// its plane + barycentric tiles (bmat [CT, 8, 768] f32) and the ray tile
// x [8, Nc] f32 (o.xyz, d.xyz, 1, tmax) of Nc = 1024 * n_blocks lanes. The
// closest kernel writes the winner code tile * 128 + lane (int32, -1 on a
// miss), the best t, and each block's tile visits and sub-packet
// intersections; the any-hit kernel whether anything lies before tmax.
//
// What bounds them on this card. Every marked (sub-packet, tile) pair is
// up to 128 x 128 (ray, triangle) pairs: six linear forms (a matrix product
// the TPU runs on its MXU) and an FP32 epilogue (t = tn / dn, u, v, five
// tests, a running minimum). A bounce-1 block of the bathroom marks ~240
// such pairs, so the products and the epilogue's instructions set the pace
// there; bytes are small beside them (a 21 KB tile a marked leaf, from L2).
// A shadow block marks ~13 but walks ~600 leaves: the walk of the top tree
// is a chain of dependent L2 loads, and each leaf costs the consumers a
// mask and a barrier. A block's steps are serial, so a launch takes as long
// as its slowest block.
//
// Design (one CTA per 1024-ray block: 8 consumer warps + 1 walker warp,
// ~113 KB of dynamic shared memory, at most 96 registers a thread, so two
// CTAs are resident an SM and the 256 blocks of a 262,144-ray batch run in
// one wave):
//   - the schedule is the Pallas kernels' own. Closest: a step fills the
//     leaf ring up to RING = 4 leaves with the current walk bound, takes
//     the two oldest (A, B), computes both sub-packet masks from the best t
//     at the step's start, processes A then B, and refreshes the bound
//     from the block's largest live best t when tail % BM_PERIOD < 2;
//     visits = tail * tpc, subs = the marked (sub-packet, tile) pairs.
//     Any-hit: the walk fetches leaf k + 1 before leaf k is processed,
//     masks before every tile against the live unoccluded lanes, refreshes
//     the bound (largest live unoccluded tmax) after leaf k when
//     k % BM_PERIOD == 0 and stops once it is <= 0;
//   - the walker warp owns the stack (shared memory) and runs that
//     schedule ahead of the consumers: the bound changes only on refresh
//     steps, so it fills later steps while the consumers work and waits
//     for them only at a refresh. Two lanes test a popped node's two
//     children in parallel (the frustum interval test of _frustum_hit,
//     with its any-sign distance bound) and push those whose interval is
//     non-empty with their entry distance and box, so a pop only compares
//     that distance with the current bound: the leaf sequence is the
//     Pallas walk's. Leaves are published with their boxes through a
//     queue of QN entries, each under an mbarrier;
//   - tiles arrive by TMA bulk copies (one per bmat row, into a slot whose
//     rows are padded and reordered so the tensor-core operand loads hit
//     32 banks) into a ring of NSLOT = 4 slots, each under an mbarrier. A
//     tile is copied only for a leaf with a marked sub-packet: the
//     consumers mask the next step's leaves early (against the current
//     best t, a superset of their final masks) and prefetch those tiles
//     while the current step runs; tiles prefetched for leaves whose final
//     mask is empty are counted (stats);
//   - consumer warp w owns the 16-ray row group w of every sub-packet
//     (rays s * 128 + w * 16 + 0..15): it tests those rays' lane slabs,
//     the block ORs the warps' marks after one barrier a step, and w
//     evaluates a marked sub-packet's tile for its row group where one of
//     its 16 rays is a candidate (the plain versions skip the same rows).
//     A ray's best t and code are written by its warp only, so no
//     cross-warp reduction is needed;
//   - the forms run on the tensor cores: mma.sync m16n8k4 TF32 with the
//     3xTF32 split (big = tf32(x), small = tf32(x - big); big * small +
//     small * big + big * big in the FP32 accumulator), the card's
//     counterpart of the MXU at Precision.HIGHEST. The origin forms take
//     A = 16 rays x (ox, oy, oz, 1), the direction forms A = (dx, dy, dz,
//     0): bmat's structurally zero rows drop out of K, which is 4, not 8
//     (wgmma needs K = 8 and 64-row tiles; the epilogue, not the product,
//     sets the pace). B = 8 triangle columns, the same 8 for all six form
//     blocks, so one thread's accumulators hold all six forms of the same
//     four (ray, triangle) pairs and the epilogue needs no shuffle;
//   - the epilogue (t, u, v from a fast division) passes a pair whose
//     values lie clear of every test's boundary, rejects one clearly
//     outside, and decides one within a band of a boundary with the plain
//     version's FP32 operations (exact_pair); a tile's winner is evaluated
//     again that way, so a ray's best t, on which the next marks and walk
//     bound depend, is the plain version's and the counters agree;
//   - tie rules as the Pallas kernel's: in a tile the lowest lane among the
//     minima wins, and a tile replaces the current hit only if strictly
//     closer;
//   - the block reductions (frustum, walk bound) are warp shuffles and a
//     shared-memory / atomic max, not a loop in one thread.
//
// Numerics. The library is built with -fmad=false, so exact_pair rounds as
// the plain version does. The products leave out what bmat holds as zeros
// (the direction forms' rows 0..2 and 6, every form's row 7): the
// direction forms' fourth operand is 0 in A and B, and x's tmax row is not
// an operand.
// Every ray value is finite, so no 0 * inf enters the accumulator; padding
// forms give -1 / 0 = -inf, which every test rejects.
#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 1024
#define SUB 128
#define NSUB 8
#define LANES 128
#define BMAT_ROWS 8
#define BMAT_COLS 768
#define TILE_FLOATS (BMAT_ROWS * BMAT_COLS)
#define NCW 8                        // consumer warps
#define NCT (NCW * 32)               // consumer threads
#define NTHREADS (NCT + 32)          // + the walker warp
#define RING 4                       // keep equal to render/kernels/cluster.py
#define BM_PERIOD 8                  // keep equal to render/kernels/cluster.py
#define NSLOT 4                      // tile slots in shared memory
#define QN 16                        // leaf queue entries
#define ROWS 7                       // bmat rows copied (row 7 is zero)
#define ROWP 776                     // padded row stride of a slot (floats)
// slot row of bmat row r: the origin forms' rows 0, 1, 2, 6 first, then the
// direction forms' rows 3, 4, 5, so that operand k of a form's m16n8k4
// product is slot row k (origin) or 4 + k (direction)
__device__ __forceinline__ int slot_row(int r) {
  return r < 3 ? r : (r == 6 ? 3 : r + 1);
}
#define SLOT_FLOATS (ROWS * ROWP)
#define ROW_BYTES (BMAT_COLS * 4)
#define TILE_TX (ROWS * ROW_BYTES)
#define MAX_STACK 128                // keep equal to render/kernels/cluster.py
#define BIG 1e30f
#define MT_EPS 1e-6f
#define FULL 0xffffffffu

// frustum slots (_block_frustum's rows)
#define FR_OMIN 0
#define FR_OMAX 3
#define FR_IMIN 6
#define FR_IMAX 9
#define FR_TLIM 12
#define FR_N 13

// per-block stats (optional output)
#define ST_TILES 0       // tiles copied
#define ST_UNUSED 1      // of them, tiles of leaves with no marked sub-packet
#define ST_PAIRS 2       // marked (sub-packet, tile) pairs evaluated
#define ST_LEAVES 3      // leaves processed
#define ST_UNITS 4       // evaluated (sub-packet, row group, tile) units of
                         // 16 rays x 128 triangles
#define ST_N 5

// A walk stack entry: node, entry distance (as int), meta[1] (the cluster,
// -1 for an interior node), right << 2 | axis; and the node's box.
struct __align__(16) Entry {
  int4 e;
  float4 b0;   // bmin.xyz, bmax.x
  float2 b1;   // bmax.yz
};

// A published leaf: node (-1: the walk's end), cluster, box.
struct __align__(16) Leaf {
  int node, cluster;
  float2 b01;
  float4 b25;
};

struct __align__(128) Smem {
  float ring[NSLOT][SLOT_FLOATS];   // first: 128-byte aligned for TMA
  float lim[BLOCK];        // closest: best t; any-hit: live unoccluded tmax
  float iv[3][BLOCK];      // inverse directions of the lane slab tests
  int code[BLOCK];
  Entry stack[MAX_STACK];
  Leaf queue[QN];
  unsigned long long qbar[QN];
  unsigned long long tbar[NSLOT];
  unsigned long long rbar; // refresh: one arrival per consumer warp
  int bmv[2];
  int ctail;               // leaves the consumers have read
  int units;               // evaluated (sub-packet, row group, tile) units
  unsigned part[2][NCW];   // per-warp sub-packet marks of a step
  float red[NCW][FR_N];
};

// ---- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* b, unsigned n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* b,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_test(unsigned long long* b,
                                          unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}

// A wait that has not ended after WAIT_LIMIT polls is a fault of the
// kernel's protocol: it traps (the launch fails) instead of hanging.
#define WAIT_LIMIT (1u << 28)

__device__ __forceinline__ void mbar_wait(unsigned long long* b,
                                          unsigned parity) {
  uint32_t ok;
  unsigned polls = 0;
  do {
    if (++polls == WAIT_LIMIT) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!ok);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// the consumer warps' own barrier (the walker never joins it)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NCT) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[2],
                                     uint32_t b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b), "f"(0.0f));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[2],
                                    uint32_t b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// ---- small helpers -------------------------------------------------------

__device__ __forceinline__ float inv_dir(float d) {
  const float mag = fmaxf(fabsf(d), 1e-18f);
  return d < 0.0f ? -1.0f / mag : 1.0f / mag;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// A consumer thread's four rays for the lane slab tests: rays
// sub * 128 + warp * 16 + (lane & 3) * 4 + 0..3 of its block, sub = lane >> 2;
// their origins (loaded for each step's tests by the closest-hit kernel,
// once by the any-hit kernel, which has the registers to keep them) and
// their inverse directions in s.iv.
struct Rays4 {
  float4 o[3];
};

__device__ __forceinline__ void load_origins(const float* __restrict__ xb,
                                             int nc, int i, Rays4& r) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    r.o[a] = __ldg(reinterpret_cast<const float4*>(xb + a * static_cast<long>(
                                                              nc) + i));
}

__device__ __forceinline__ int own_ray(int warp, int lane) {
  return (lane >> 2) * SUB + warp * 16 + (lane & 3) * 4;
}

// Loads the thread's rays, reduces the block's frustum into s.red and
// initialises s.lim / s.code. Returns whether the block has a live lane.
__device__ bool load_block(const float* __restrict__ x, long nc, Smem& s,
                           bool anyhit) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bool live_any = false;
  if (warp < NCW) {
    const long base = static_cast<long>(blockIdx.x) * BLOCK;
    const int i0 = own_ray(warp, lane);
    float v[FR_N] = {BIG, BIG, BIG, -BIG, -BIG, -BIG,
                     BIG, BIG, BIG, -BIG, -BIG, -BIG, 0.0f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long i = base + i0 + k;
      const float tmax = x[7 * nc + i];
      const bool live = tmax > 0.0f;
      live_any |= live;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float o = x[a * nc + i];
        const float iv = inv_dir(x[(3 + a) * nc + i]);
        s.iv[a][i0 + k] = iv;
        if (live) {
          v[FR_OMIN + a] = fminf(v[FR_OMIN + a], o);
          v[FR_OMAX + a] = fmaxf(v[FR_OMAX + a], o);
          v[FR_IMIN + a] = fminf(v[FR_IMIN + a], iv);
          v[FR_IMAX + a] = fmaxf(v[FR_IMAX + a], iv);
        }
      }
      if (live) v[FR_TLIM] = fmaxf(v[FR_TLIM], tmax);
      s.lim[i0 + k] = anyhit ? (live ? tmax : 0.0f) : tmax;
      s.code[i0 + k] = -1;
    }
#pragma unroll
    for (int k = 0; k < FR_N; ++k) {
      const bool is_min = (k < 3) || (k >= 6 && k < 9);
      v[k] = is_min ? warp_min(v[k]) : warp_max(v[k]);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < FR_N; ++k) s.red[warp][k] = v[k];
    }
  }
  if (tid == 0) {
    for (int q = 0; q < QN; ++q) mbar_init(&s.qbar[q], 1);
    for (int q = 0; q < NSLOT; ++q) mbar_init(&s.tbar[q], 1);
    mbar_init(&s.rbar, NCW);
    s.bmv[0] = 0;
    s.bmv[1] = 0;
    s.ctail = 0;
    s.units = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  return __syncthreads_or(live_any) != 0;
}

// _lane_slab: one ray against a leaf box, before `limit`.
__device__ __forceinline__ bool lane_slab(const float (&b)[6], const float* o,
                                          const float* iv, float limit) {
  const float t0x = (b[0] - o[0]) * iv[0];
  const float t1x = (b[3] - o[0]) * iv[0];
  const float t0y = (b[1] - o[1]) * iv[1];
  const float t1y = (b[4] - o[1]) * iv[1];
  const float t0z = (b[2] - o[2]) * iv[2];
  const float t1z = (b[5] - o[2]) * iv[2];
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fmaxf(fminf(t0z, t1z), 0.0f));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  return (tf >= tn) && (tn < limit);
}

// The warp's parts of the masks of up to four published leaves (queue
// entries seq[l], -1: none) packed 8 bits a leaf, their boxes read from the
// queue: bit s of a leaf's byte is set where the warp's row group of
// sub-packet s holds a lane whose ray passes the lane slab test. Lane l
// tests rays 4 (l & 3) .. + 3 of the row group of sub-packet l >> 2, so a
// sub-packet's four lanes are adjacent in the ballot.
__device__ __forceinline__ unsigned step_bits(const int (&seq)[4],
                                              const Rays4& r, const Smem& s,
                                              int i0) {
  __syncwarp();
  const float4 lim = *reinterpret_cast<const float4*>(&s.lim[i0]);
  const float4 ix = *reinterpret_cast<const float4*>(&s.iv[0][i0]);
  const float4 iy = *reinterpret_cast<const float4*>(&s.iv[1][i0]);
  const float4 iz = *reinterpret_cast<const float4*>(&s.iv[2][i0]);
  const float iv[4][3] = {{ix.x, iy.x, iz.x}, {ix.y, iy.y, iz.y},
                          {ix.z, iy.z, iz.z}, {ix.w, iy.w, iz.w}};
  const float o[4][3] = {{r.o[0].x, r.o[1].x, r.o[2].x},
                         {r.o[0].y, r.o[1].y, r.o[2].y},
                         {r.o[0].z, r.o[1].z, r.o[2].z},
                         {r.o[0].w, r.o[1].w, r.o[2].w}};
  const float lm[4] = {lim.x, lim.y, lim.z, lim.w};
  unsigned w = 0u;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    if (seq[l] < 0) continue;
    const Leaf& q = s.queue[seq[l] % QN];
    const float2 b01 = q.b01;
    const float4 b25 = q.b25;
    const float b[6] = {b01.x, b01.y, b25.x, b25.y, b25.z, b25.w};
    bool cand = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) cand |= lane_slab(b, o[k], iv[k], lm[k]);
    // sub-packet k's flag at bit 4k, then packed to bit k
    unsigned v = __ballot_sync(FULL, cand);
    v = (v | (v >> 1) | (v >> 2) | (v >> 3)) & 0x11111111u;
    v = (v | (v >> 3)) & 0x03030303u;
    v = (v | (v >> 6)) & 0x000F000Fu;
    v = (v | (v >> 12)) & 0xFFu;
    w |= v << (8 * l);
  }
  return w;
}

// ---- the walker ----------------------------------------------------------

struct Frustum {
  float om_lo[3], om_hi[3], i_lo[3], i_hi[3], tlim;
  int nl;  // near-left bit by split axis
};

// _frustum_hit's interval bounds of node nd: the block's rays can hit it
// before tlim where tf >= tn and tn < tlim. Fills the node's stack entry.
__device__ __forceinline__ bool node_entry(const float* __restrict__ boxes,
                                           const int* __restrict__ meta, int m,
                                           int nd, const Frustum& f,
                                           Entry& e) {
  float b[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) b[k] = __ldg(boxes + k * m + nd);
  float tn = 0.0f, tf = BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float bmin = b[a];
    const float bmax = b[3 + a];
    const float u1 = bmin - f.om_hi[a], v1 = bmin - f.om_lo[a];
    const float u2 = bmax - f.om_hi[a], v2 = bmax - f.om_lo[a];
    const float p0 = u1 * f.i_lo[a], p1 = u1 * f.i_hi[a];
    const float p2 = v1 * f.i_lo[a], p3 = v1 * f.i_hi[a];
    const float p4 = u2 * f.i_lo[a], p5 = u2 * f.i_hi[a];
    const float p6 = v2 * f.i_lo[a], p7 = v2 * f.i_hi[a];
    const float lo = fminf(fminf(fminf(p0, p1), fminf(p2, p3)),
                           fminf(fminf(p4, p5), fminf(p6, p7)));
    const float hi = fmaxf(fmaxf(fmaxf(p0, p1), fmaxf(p2, p3)),
                           fmaxf(fmaxf(p4, p5), fmaxf(p6, p7)));
    tn = fmaxf(tn, fmaxf(lo, fmaxf(u1, -v2)));
    tf = fminf(tf, hi);
  }
  const int m1 = __ldg(meta + m + nd);
  const int info = m1 >= 0 ? 0
                           : (__ldg(meta + 2 * m + nd) << 2) |
                                 (__ldg(meta + 3 * m + nd) & 3);
  e.e = make_int4(nd, __float_as_int(tn), m1, info);
  e.b0 = make_float4(b[0], b[1], b[2], b[3]);
  e.b1 = make_float2(b[4], b[5]);
  return tf >= tn;
}

// _make_next_leaf: pop until a leaf hit before bm (node, cluster) or an
// empty stack (-1, -1). Children are pushed far first so the near child
// pops first. Called by the whole walker warp; the result is warp-uniform.
__device__ int next_leaf(const float* __restrict__ boxes,
                         const int* __restrict__ meta, int m, Smem& s,
                         int& sp, float bm, const Frustum& f, int lane) {
  while (sp > 0) {
    const int4 e = s.stack[--sp].e;
    if (!(__int_as_float(e.y) < bm)) continue;
    if (e.z >= 0) return sp;
    const int right = e.w >> 2;
    const bool near_left = ((f.nl >> (e.w & 3)) & 1) != 0;
    const int far = near_left ? right : e.x + 1;
    const int near = near_left ? e.x + 1 : right;
    Entry ce;
    bool pass = false;
    if (lane < 2) pass = node_entry(boxes, meta, m, lane == 0 ? far : near,
                                    f, ce);
    const unsigned p = __ballot_sync(FULL, pass);
    if (lane == 0 && (p & 1u)) s.stack[sp] = ce;
    if (lane == 1 && (p & 2u)) s.stack[sp + (p & 1u)] = ce;
    sp += __popc(p);
    __syncwarp();
  }
  return -1;
}

// Publishes leaf entry `seq` (the leaf of stack entry `at`, or the walk's
// end where at < 0) once the consumers have read the entry QN places back.
__device__ __forceinline__ void publish(Smem& s, int seq, int at, int lane) {
  if (lane == 0) {
    unsigned polls = 0;
    while (seq - *reinterpret_cast<volatile int*>(&s.ctail) >= QN) {
      if (++polls == WAIT_LIMIT) __trap();
      __nanosleep(64);
    }
    Leaf& q = s.queue[seq % QN];
    if (at >= 0) {
      const Entry& e = s.stack[at];
      q.node = e.e.x;
      q.cluster = e.e.z;
      q.b01 = make_float2(e.b0.x, e.b0.y);
      q.b25 = make_float4(e.b0.z, e.b0.w, e.b1.x, e.b1.y);
    } else {
      q.node = -1;
      q.cluster = -1;
    }
    mbar_arrive(&s.qbar[seq % QN]);
  }
  __syncwarp();
}

// The walker warp's set-up: the block frustum from the consumer warps'
// partial reductions, and the root's stack entry. Returns the stack depth.
__device__ int walker_start(const float* __restrict__ boxes,
                            const int* __restrict__ meta, int m, Smem& s,
                            Frustum& f, int lane) {
  float v = 0.0f;
  if (lane < FR_N) {
    const bool is_min = (lane < 3) || (lane >= 6 && lane < 9);
    v = s.red[0][lane];
    for (int w = 1; w < NCW; ++w)
      v = is_min ? fminf(v, s.red[w][lane]) : fmaxf(v, s.red[w][lane]);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    f.om_lo[a] = __shfl_sync(FULL, v, FR_OMIN + a);
    f.om_hi[a] = __shfl_sync(FULL, v, FR_OMAX + a);
    f.i_lo[a] = __shfl_sync(FULL, v, FR_IMIN + a);
    f.i_hi[a] = __shfl_sync(FULL, v, FR_IMAX + a);
  }
  f.tlim = __shfl_sync(FULL, v, FR_TLIM);
  f.nl = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    f.nl |= (f.i_lo[a] + f.i_hi[a] >= 0.0f ? 1 : 0) << a;
  bool pass = false;
  if (lane == 0) {
    Entry e;
    pass = node_entry(boxes, meta, m, 0, f, e);
    if (pass) s.stack[0] = e;
  }
  __syncwarp();
  return __shfl_sync(FULL, pass ? 1 : 0, 0);
}

// The bound the consumers refreshed (refresh number r), once all NCW warps
// have added theirs.
__device__ __forceinline__ float walker_refresh(Smem& s, int r) {
  mbar_wait(&s.rbar, r & 1);
  const float bm = __int_as_float(
      *reinterpret_cast<volatile int*>(&s.bmv[r & 1]));
  __syncwarp();
  if ((threadIdx.x & 31) == 0) s.bmv[r & 1] = 0;
  __syncwarp();
  return bm;
}

// Closest-hit walk: the Pallas kernel's fill schedule (fill to RING leaves,
// two leaves a step, the bound refreshed when tail % BM_PERIOD < 2).
__device__ void walker_closest(const float* __restrict__ boxes,
                               const int* __restrict__ meta, int m, Smem& s) {
  const int lane = threadIdx.x & 31;
  Frustum f;
  int sp = walker_start(boxes, meta, m, s, f, lane);
  float bm = f.tlim;
  int head = 0, tail = 0, refresh = 0;
  for (;;) {
    bool wd = false;
    while (head - tail < RING) {
      const int at = next_leaf(boxes, meta, m, s, sp, bm, f, lane);
      if (at < 0) {
        wd = true;
        break;
      }
      publish(s, head++, at, lane);
    }
    if (wd) break;
    tail += 2;   // the ring holds RING >= 2 leaves
    if (tail % BM_PERIOD < 2) bm = walker_refresh(s, refresh++);
  }
  publish(s, head, -1, lane);
}

// Any-hit walk: leaf k + 1 is fetched before leaf k is processed, with the
// bound refreshed after leaf k - 1 when (k - 1) % BM_PERIOD == 0; the walk
// stops once the bound is <= 0 (every live lane occluded).
__device__ void walker_anyhit(const float* __restrict__ boxes,
                              const int* __restrict__ meta, int m, Smem& s) {
  const int lane = threadIdx.x & 31;
  Frustum f;
  int sp = walker_start(boxes, meta, m, s, f, lane);
  float bm = f.tlim;
  int k = 0, refresh = 0;
  int at = next_leaf(boxes, meta, m, s, sp, bm, f, lane);
  if (at >= 0) {
    publish(s, 0, at, lane);
    for (;;) {
      if (k >= 1 && (k - 1) % BM_PERIOD == 0)
        bm = walker_refresh(s, refresh++);
      if (!(bm > 0.0f)) break;
      at = next_leaf(boxes, meta, m, s, sp, bm, f, lane);
      if (at < 0) break;
      publish(s, ++k, at, lane);
    }
    ++k;
  }
  publish(s, k, -1, lane);
}

// ---- the consumers -------------------------------------------------------

// Waits for leaf entry `seq` and reads its (node, cluster).
__device__ __forceinline__ int2 read_leaf(Smem& s, int seq) {
  mbar_wait(&s.qbar[seq % QN], (seq / QN) & 1);
  const Leaf& q = s.queue[seq % QN];
  return make_int2(q.node, q.cluster);
}

// Leaf entry `seq`'s (node, cluster) if the walker has published it (a
// peek, decided by lane 0 and made warp-uniform), else (-1, -1).
__device__ __forceinline__ int2 peek_leaf(Smem& s, int seq, int lane) {
  int2 e = make_int2(-1, -1);
  if (lane == 0 && mbar_test(&s.qbar[seq % QN], (seq / QN) & 1)) {
    const Leaf& q = s.queue[seq % QN];
    e = make_int2(q.node, q.cluster);
  }
  e.x = __shfl_sync(FULL, e.x, 0);
  e.y = __shfl_sync(FULL, e.y, 0);
  return e;
}

// Issues the copy of tile `t` into the slot of issue number `seq`, once the
// slot's previous copy has landed (thread 0 of the consumers only).
__device__ __forceinline__ void issue_tile(Smem& s,
                                           const float* __restrict__ bmat,
                                           long t, int seq) {
  const int slot = seq % NSLOT;
  if (seq >= NSLOT) mbar_wait(&s.tbar[slot], ((seq - NSLOT) / NSLOT) & 1);
  mbar_expect_tx(&s.tbar[slot], TILE_TX);
  const float* src = bmat + t * TILE_FLOATS;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    bulk_copy(&s.ring[slot][slot_row(r) * ROWP], src + r * BMAT_COLS,
              ROW_BYTES, &s.tbar[slot]);
}

// Waits until every copy issued so far has landed (before the block exits).
__device__ __forceinline__ void drain(Smem& s, int nissued) {
  for (int q = nissued > NSLOT ? nissued - NSLOT : 0; q < nissued; ++q)
    mbar_wait(&s.tbar[q % NSLOT], (q / NSLOT) & 1);
}

// The A fragments of rays r0 = row g, r1 = row g + 8 of a 16-ray row group,
// split for 3xTF32: column q of (ox, oy, oz, 1) for the origin forms (ao)
// and of (dx, dy, dz, 0) for the direction forms (ad). xb: the block's ray
// tile (x + the block's first lane), nc its row stride.
struct AFrag {
  uint32_t ob[2], os[2], db[2], ds[2];
};

__device__ __forceinline__ void load_a(const float* __restrict__ xb, int nc,
                                       int r0, int r1, int q, AFrag& a) {
  const float* xo = xb + static_cast<long>(q) * nc;
  const float* xd = xo + 3L * nc;
  const float c = q == 3 ? 1.0f : 0.0f;
  split(q < 3 ? __ldg(xo + r0) : c, a.ob[0], a.os[0]);
  split(q < 3 ? __ldg(xo + r1) : c, a.ob[1], a.os[1]);
  split(q < 3 ? __ldg(xd + r0) : 0.0f, a.db[0], a.ds[0]);
  split(q < 3 ? __ldg(xd + r1) : 0.0f, a.db[1], a.ds[1]);
}

// The six forms of column group c (triangles c * 8 .. c * 8 + 7) for the
// row group, one m16n8k4 product of each split pair a form: acc[f][i] holds
// form f of (ray g, triangle c * 8 + 2q) for i = 0, (g, 2q + 1) for 1,
// (g + 8, 2q) for 2, (g + 8, 2q + 1) for 3.
__device__ __forceinline__ void forms(const float* tile, int c, int g, int q,
                                      const AFrag& a, float (&acc)[6][4]) {
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const float* col = tile + f * LANES + c * 8 + g;
    float b;
    if (f % 2 == 0) b = col[q * ROWP];
    else b = q < 3 ? col[(4 + q) * ROWP] : 0.0f;
    uint32_t bb, bs;
    split(b, bb, bs);
    if (f % 2 == 0) {
      mma0(acc[f], a.ob, bs);
      mma(acc[f], a.os, bb);
      mma(acc[f], a.ob, bb);
    } else {
      mma0(acc[f], a.db, bs);
      mma(acc[f], a.ds, bb);
      mma(acc[f], a.db, bb);
    }
  }
}

// _tile_forms for one (ray r, triangle k) pair in FP32 term by term, with
// the plain version's operations: whether it is a hit before `limit`, and
// its t.
__device__ __forceinline__ bool exact_pair(const float* tile, int k,
                                        const float* __restrict__ xb, int nc,
                                        int r, float limit, float& t) {
  const float* o = xb + r;
  const float ox = __ldg(o), oy = __ldg(o + nc), oz = __ldg(o + 2L * nc);
  const float dx = __ldg(o + 3L * nc), dy = __ldg(o + 4L * nc);
  const float dz = __ldg(o + 5L * nc);
  const float* c = tile + k;
  float f[6];
#pragma unroll
  for (int blk = 0; blk < 6; blk += 2) {
    const float* a = c + blk * LANES;         // an origin form's block
    const float* b = a + LANES;               // the direction form's
    f[blk] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a[0], ox),
                                           __fmul_rn(a[ROWP], oy)),
                                 __fmul_rn(a[2 * ROWP], oz)),
                       a[3 * ROWP]);
    f[blk + 1] = __fadd_rn(__fadd_rn(__fmul_rn(b[4 * ROWP], dx),
                                     __fmul_rn(b[5 * ROWP], dy)),
                           __fmul_rn(b[6 * ROWP], dz));
  }
  t = __fdiv_rn(f[0], f[1]);
  const float u = __fadd_rn(f[2], __fmul_rn(t, f[3]));
  const float v = __fadd_rn(f[4], __fmul_rn(t, f[5]));
  return u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f && t > MT_EPS &&
         t < limit;
}

// _sub_hits for pair i of the accumulators, from the 3xTF32 forms with a
// fast division: 1 where (t, u, v) lie clear of every test's boundary and
// pass (t is then this approximation), 2 where they lie within a band of a
// boundary (UV_BAND on u, v and u + v, T_REL_BAND on t against the limit,
// T_ABS_BAND on t near 0), to be decided by exact_pair as the plain
// version decides it, 0 where they clearly fail. lo / hi: the limit times
// (1 -+ T_REL_BAND).
#define UV_BAND 1e-2f
#define T_REL_BAND 1e-3f
#define T_ABS_BAND 1e-4f

__device__ __forceinline__ int pair_class(const float (&acc)[6][4], int i,
                                          float lo, float hi, float& t) {
  t = __fdividef(acc[0][i], acc[1][i]);
  const float u = __fadd_rn(acc[2][i], __fmul_rn(t, acc[3][i]));
  const float v = __fadd_rn(acc[4][i], __fmul_rn(t, acc[5][i]));
  const float mn = fminf(u, v), w = __fadd_rn(u, v);
  if (mn >= UV_BAND && w <= 1.0f - UV_BAND && t > T_ABS_BAND && t < lo)
    return 1;
  return (mn >= -UV_BAND && w <= 1.0f + UV_BAND && t > -T_ABS_BAND && t < hi)
             ? 2 : 0;
}

// The t of triangle k of the tile for ray r, as exact_pair computes it: a
// tile's winner is evaluated again, so that a ray's best t, on which the
// sub-packet marks and the walk bound depend, is the plain version's
// wherever the winner is.
__device__ __forceinline__ float exact_t(const float* tile, int k,
                                         const float* __restrict__ xb, int nc,
                                         int r) {
  float t;
  exact_pair(tile, k, xb, nc, r, BIG, t);
  return t;
}

__device__ __forceinline__ void better(float& t, int& l, float ot, int ol) {
  if (ot < t || (ot == t && ol < l)) {
    t = ot;
    l = ol;
  }
}

// One (sub-packet sp, this warp's row group) x tile unit of the closest-hit
// kernel: the lowest (t, lane) hit of each of the 16 rays in the tile,
// taken where strictly closer than its best t.
__device__ void closest_unit(const float* tile, const float* __restrict__ xb,
                             int nc, int sp, int warp, int lane, int t_idx,
                             Smem& s) {
  const int g = lane >> 2, q = lane & 3;
  const int r0 = sp * SUB + warp * 16 + g, r1 = r0 + 8;
  AFrag a;
  load_a(xb, nc, r0, r1, q, a);
  __syncwarp();
  const float l0 = s.lim[r0], l1 = s.lim[r1];
  const float lo0 = l0 * (1.0f - T_REL_BAND), hi0 = l0 * (1.0f + T_REL_BAND);
  const float lo1 = l1 * (1.0f - T_REL_BAND), hi1 = l1 * (1.0f + T_REL_BAND);
  float tb0 = BIG, tb1 = BIG;
  int lb0 = LANES, lb1 = LANES;
#pragma unroll 1
  for (int c = 0; c < LANES / 8; ++c) {
    float acc[6][4];
    forms(tile, c, g, q, a, acc);
    unsigned border = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tri = c * 8 + 2 * q + (i & 1);
      float t;
      const int k = pair_class(acc, i, i < 2 ? lo0 : lo1, i < 2 ? hi0 : hi1,
                               t);
      if (k == 1) {
        if (i < 2) better(tb0, lb0, t, tri);
        else better(tb1, lb1, t, tri);
      }
      border |= (k == 2 ? 1u : 0u) << i;
    }
    for (; border; border &= border - 1) {
      const int i = __ffs(border) - 1;
      const int tri = c * 8 + 2 * q + (i & 1);
      float t;
      if (exact_pair(tile, tri, xb, nc, i < 2 ? r0 : r1, i < 2 ? l0 : l1, t)) {
        if (i < 2) better(tb0, lb0, t, tri);
        else better(tb1, lb1, t, tri);
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    better(tb0, lb0, __shfl_xor_sync(FULL, tb0, o),
           __shfl_xor_sync(FULL, lb0, o));
    better(tb1, lb1, __shfl_xor_sync(FULL, tb1, o),
           __shfl_xor_sync(FULL, lb1, o));
  }
  if (q == 0) {
    if (lb0 < LANES) {
      const float t = exact_t(tile, lb0, xb, nc, r0);
      if (t > MT_EPS && t < l0) {
        s.lim[r0] = t;
        s.code[r0] = t_idx * LANES + lb0;
      }
    }
    if (lb1 < LANES) {
      const float t = exact_t(tile, lb1, xb, nc, r1);
      if (t > MT_EPS && t < l1) {
        s.lim[r1] = t;
        s.code[r1] = t_idx * LANES + lb1;
      }
    }
  }
}

// One unit of the any-hit kernel: the rays with a hit before tmax are
// marked occluded (their limit set to 0). Rows whose 16 rays are all
// occluded or dead are skipped (their result cannot change).
__device__ void anyhit_unit(const float* tile, const float* __restrict__ xb,
                            int nc, int sp, int warp, int lane, Smem& s) {
  const int g = lane >> 2, q = lane & 3;
  const int r0 = sp * SUB + warp * 16 + g, r1 = r0 + 8;
  __syncwarp();
  if (!__any_sync(FULL, s.lim[r0] > 0.0f || s.lim[r1] > 0.0f)) return;
  AFrag a;
  load_a(xb, nc, r0, r1, q, a);
  const float m0 = __ldg(xb + 7L * nc + r0);
  const float m1 = __ldg(xb + 7L * nc + r1);
  const float lo0 = m0 * (1.0f - T_REL_BAND), hi0 = m0 * (1.0f + T_REL_BAND);
  const float lo1 = m1 * (1.0f - T_REL_BAND), hi1 = m1 * (1.0f + T_REL_BAND);
  bool h0 = false, h1 = false;
#pragma unroll 1
  for (int c = 0; c < LANES / 8; ++c) {
    float acc[6][4];
    forms(tile, c, g, q, a, acc);
    unsigned border = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float t;
      const int k = pair_class(acc, i, i < 2 ? lo0 : lo1, i < 2 ? hi0 : hi1,
                               t);
      if (i < 2) h0 |= k == 1;
      else h1 |= k == 1;
      border |= (k == 2 ? 1u : 0u) << i;
    }
    for (; border; border &= border - 1) {
      const int i = __ffs(border) - 1;
      float t;
      if (exact_pair(tile, c * 8 + 2 * q + (i & 1), xb, nc,
                     i < 2 ? r0 : r1, i < 2 ? m0 : m1, t)) {
        if (i < 2) h0 = true;
        else h1 = true;
      }
    }
  }
  const unsigned v0 = __ballot_sync(FULL, h0), v1 = __ballot_sync(FULL, h1);
  if (q == 0) {
    if ((v0 >> lane) & 0xFu) s.lim[r0] = 0.0f;
    if ((v1 >> lane) & 0xFu) s.lim[r1] = 0.0f;
  }
}

// Adds this warp's part of a walk-bound refresh: the largest limit over its
// rays (best t of live lanes; tmax of live unoccluded lanes), then arrives.
__device__ __forceinline__ void refresh_arrive(Smem& s, int r, int warp,
                                               int lane) {
  __syncwarp();
  const float4 lm = *reinterpret_cast<const float4*>(&s.lim[own_ray(warp,
                                                                    lane)]);
  const float v = warp_max(fmaxf(fmaxf(fmaxf(lm.x, 0.0f), fmaxf(lm.y, 0.0f)),
                                 fmaxf(fmaxf(lm.z, 0.0f), fmaxf(lm.w, 0.0f))));
  if (lane == 0) {
    atomicMax(&s.bmv[r & 1], __float_as_int(v));
    mbar_arrive(&s.rbar);
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
cluster_closest_kernel(const float* __restrict__ boxes,
                       const int* __restrict__ meta,
                       const float* __restrict__ bmat,
                       const float* __restrict__ x, int m, int tpc, int nc_,
                       int* __restrict__ out_code, float* __restrict__ out_t,
                       int* __restrict__ out_visits,
                       int* __restrict__ out_subs,
                       int* __restrict__ out_stats) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long nc = nc_, base = static_cast<long>(blockIdx.x) * BLOCK;
  const float* xb = x + base;
  const int i0 = own_ray(warp, lane);
  const bool live = load_block(x, nc, s, false);
  if (!live || warp == NCW) {
    if (live) walker_closest(boxes, meta, m, s);
    if (!live && warp < NCW) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        out_code[base + i0 + k] = -1;
        out_t[base + i0 + k] = 0.0f;
      }
    }
    if (!live && tid == 0) {
      out_visits[blockIdx.x] = 0;
      out_subs[blockIdx.x] = 0;
      if (out_stats)
        for (int k = 0; k < ST_N; ++k) out_stats[blockIdx.x * ST_N + k] = 0;
    }
    return;
  }
  int tail = 0, step = 0, refresh = 0, nissued = 0;
  int seq_a = -1, seq_b = -1;      // prefetched first-tile issue numbers
  int subs = 0, unused = 0, units = 0;
  for (;;) {
    const int2 ea = read_leaf(s, tail);
    if (ea.x < 0) break;
    const int2 eb = read_leaf(s, tail + 1);
    const int na = eb.x < 0 ? 1 : 2;
    int2 ec = make_int2(-1, -1), ed = make_int2(-1, -1);
    if (tpc == 1 && na == 2) {
      ec = peek_leaf(s, tail + 2, lane);
      if (ec.x >= 0) ed = peek_leaf(s, tail + 3, lane);
    }
    const int seqs[4] = {tail, na == 2 ? tail + 1 : -1,
                         ec.x >= 0 ? tail + 2 : -1, ed.x >= 0 ? tail + 3 : -1};
    Rays4 r;
    load_origins(xb, nc_, i0, r);
    const unsigned w = step_bits(seqs, r, s, i0);
    if (lane == 0) s.part[step & 1][warp] = w;
    consumer_sync();
    unsigned all = 0u;
#pragma unroll
    for (int k = 0; k < NCW; ++k) all |= s.part[step & 1][k];
    ++step;
    if (tid == 0) *reinterpret_cast<volatile int*>(&s.ctail) = tail + na;
    const unsigned bits_a = all & 0xFFu, bits_b = na == 2 ? (all >> 8) & 0xFFu : 0u;
    // tiles prefetched for leaves that have no marked sub-packet
    unused += (!bits_a && seq_a >= 0) + (!bits_b && seq_b >= 0);
    if (tpc == 1) {
      // A and B (unless prefetched), then the next step's C and D
      int qa = seq_a, qb = seq_b;
      if (bits_a && qa < 0) {
        if (tid == 0) issue_tile(s, bmat, ea.y, nissued);
        qa = nissued++;
      }
      if (bits_b && qb < 0) {
        if (tid == 0) issue_tile(s, bmat, eb.y, nissued);
        qb = nissued++;
      }
      seq_a = seq_b = -1;
      if ((all >> 16) & 0xFFu) {
        if (tid == 0) issue_tile(s, bmat, read_leaf(s, tail + 2).y, nissued);
        seq_a = nissued++;
      }
      if ((all >> 24) & 0xFFu) {
        if (tid == 0) issue_tile(s, bmat, read_leaf(s, tail + 3).y, nissued);
        seq_b = nissued++;
      }
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const unsigned bl = l == 0 ? bits_a : bits_b;
        if (!bl) continue;
        const int q = l == 0 ? qa : qb;
        mbar_wait(&s.tbar[q % NSLOT], (q / NSLOT) & 1);
        for (unsigned b = bl & (w >> (8 * l)); b; b &= b - 1, ++units)
          closest_unit(s.ring[q % NSLOT], xb, nc_, __ffs(b) - 1, warp,
                       lane, l == 0 ? ea.y : eb.y, s);
        subs += __popc(bl);
      }
    } else {
      // tpc > 1: A's tiles then B's, NSLOT copies in flight at a time
      const int nj = tpc * ((bits_a ? 1 : 0) + (bits_b ? 1 : 0));
      for (int j0 = 0; j0 < nj; j0 += NSLOT) {
        const int j1 = min(nj, j0 + NSLOT);
        if (j0 > 0) consumer_sync();   // the previous group's slots are free
        const int first = nissued;
        for (int j = j0; j < j1; ++j) {
          const bool on_a = j < tpc && bits_a;
          const long t = static_cast<long>(on_a ? ea.y : eb.y) * tpc + j % tpc;
          if (tid == 0) issue_tile(s, bmat, t, nissued);
          ++nissued;
        }
        for (int j = j0; j < j1; ++j) {
          const bool on_a = j < tpc && bits_a;
          const long t = static_cast<long>(on_a ? ea.y : eb.y) * tpc + j % tpc;
          const unsigned bl = on_a ? bits_a : bits_b;
          const int q = first + (j - j0);
          mbar_wait(&s.tbar[q % NSLOT], (q / NSLOT) & 1);
          for (unsigned b = bl & (w >> (on_a ? 0 : 8)); b; b &= b - 1, ++units)
            closest_unit(s.ring[q % NSLOT], xb, nc_, __ffs(b) - 1, warp,
                         lane, static_cast<int>(t), s);
          subs += __popc(bl);
        }
      }
    }
    tail += na;
    if (tail % BM_PERIOD < 2) refresh_arrive(s, refresh++, warp, lane);
  }
  __syncwarp();
  {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out_code[base + i0 + k] = s.code[i0 + k];
      out_t[base + i0 + k] = s.lim[i0 + k];
    }
  }
  if (out_stats) {
    if (lane == 0) atomicAdd(&s.units, units);
    consumer_sync();
  }
  if (tid == 0) {
    drain(s, nissued);
    out_visits[blockIdx.x] = tail * tpc;
    out_subs[blockIdx.x] = subs;
    if (out_stats) {
      int* st = out_stats + blockIdx.x * ST_N;
      st[ST_TILES] = nissued;
      st[ST_UNUSED] = unused;
      st[ST_PAIRS] = subs;
      st[ST_LEAVES] = tail;
      st[ST_UNITS] = s.units;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
cluster_occluded_kernel(const float* __restrict__ boxes,
                        const int* __restrict__ meta,
                        const float* __restrict__ bmat,
                        const float* __restrict__ x, int m, int tpc, int nc_,
                        unsigned char* __restrict__ out_occ,
                        int* __restrict__ out_stats) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long nc = nc_, base = static_cast<long>(blockIdx.x) * BLOCK;
  const float* xb = x + base;
  const int i0 = own_ray(warp, lane);
  const bool live = load_block(x, nc, s, true);
  if (!live || warp == NCW) {
    if (live) walker_anyhit(boxes, meta, m, s);
    if (!live && warp < NCW) {
#pragma unroll
      for (int k = 0; k < 4; ++k) out_occ[base + i0 + k] = 0;
    }
    if (!live && tid == 0 && out_stats)
      for (int k = 0; k < ST_N; ++k) out_stats[blockIdx.x * ST_N + k] = 0;
    return;
  }
  int k = 0, step = 0, refresh = 0, nissued = 0, seq_n = -1;
  int pairs = 0, unused = 0, units = 0;
  Rays4 r;   // the any-hit kernel has the registers to keep the origins
  load_origins(xb, nc_, i0, r);
  for (;;) {
    const int2 e = read_leaf(s, k);
    if (e.x < 0) break;
    const int2 en = tpc == 1 ? peek_leaf(s, k + 1, lane) : make_int2(-1, -1);
    int seq = seq_n;
    seq_n = -1;
    for (int j = 0; j < tpc; ++j) {
      const int seqs[4] = {k, j == 0 && en.x >= 0 ? k + 1 : -1, -1, -1};
      const unsigned w = step_bits(seqs, r, s, i0);
      if (lane == 0) s.part[step & 1][warp] = w;
      consumer_sync();
      unsigned all = 0u;
#pragma unroll
      for (int q = 0; q < NCW; ++q) all |= s.part[step & 1][q];
      ++step;
      if (tid == 0 && j == 0) *reinterpret_cast<volatile int*>(&s.ctail) = k + 1;
      const unsigned bits = all & 0xFFu;
      const long t = static_cast<long>(e.y) * tpc + j;
      if (j > 0 || seq < 0) {
        seq = -1;
        if (bits) {
          if (tid == 0) issue_tile(s, bmat, t, nissued);
          seq = nissued++;
        }
      } else if (!bits) {
        ++unused;
      }
      if (j == 0 && ((all >> 8) & 0xFFu)) {
        if (tid == 0) issue_tile(s, bmat, read_leaf(s, k + 1).y, nissued);
        seq_n = nissued++;
      }
      if (bits) {
        mbar_wait(&s.tbar[seq % NSLOT], (seq / NSLOT) & 1);
        for (unsigned b = bits & w; b; b &= b - 1, ++units)
          anyhit_unit(s.ring[seq % NSLOT], xb, nc_, __ffs(b) - 1, warp,
                      lane, s);
        pairs += __popc(bits);
      }
    }
    if (k % BM_PERIOD == 0) refresh_arrive(s, refresh++, warp, lane);
    ++k;
  }
  __syncwarp();
  {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float tmax = __ldg(x + 7 * nc + base + i0 + q);
      out_occ[base + i0 + q] = (tmax > 0.0f && !(s.lim[i0 + q] > 0.0f)) ? 1 : 0;
    }
  }
  if (out_stats) {
    if (lane == 0) atomicAdd(&s.units, units);
    consumer_sync();
  }
  if (tid == 0) {
    drain(s, nissued);
    if (out_stats) {
      int* st = out_stats + blockIdx.x * ST_N;
      st[ST_TILES] = nissued;
      st[ST_UNUSED] = unused;
      st[ST_PAIRS] = pairs;
      st[ST_LEAVES] = k;
      st[ST_UNITS] = s.units;
    }
  }
}

// C entry points (bound with ctypes by render/kernels/cluster.py). Each
// launches n_blocks CTAs of NTHREADS threads with sizeof(Smem) bytes of
// dynamic shared memory on `stream` without synchronising and returns
// cudaGetLastError(). boxes [8, m] f32, meta [4, m] int32, bmat [CT, 8,
// 768] f32 (16-byte aligned), x [8, 1024 * n_blocks] f32, all contiguous;
// out_stats, when not null, int32 [n_blocks, ST_N] (ST_*). The wrapper checks
// that the top tree's stack needs at most MAX_STACK entries.
static int set_smem(const void* kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem))));
}

extern "C" int lh2_cluster_closest(const float* boxes, const int* meta,
                                   const float* bmat, const float* x, int m,
                                   int tpc, int n_blocks, int* out_code,
                                   float* out_t, int* out_visits,
                                   int* out_subs, int* out_stats,
                                   void* stream) {
  static const int attr = set_smem(
      reinterpret_cast<const void*>(cluster_closest_kernel));
  if (attr != 0) return attr;
  if (n_blocks > 0) {
    cluster_closest_kernel<<<n_blocks, NTHREADS, sizeof(Smem),
                             static_cast<cudaStream_t>(stream)>>>(
        boxes, meta, bmat, x, m, tpc, n_blocks * BLOCK, out_code, out_t,
        out_visits, out_subs, out_stats);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lh2_cluster_occluded(const float* boxes, const int* meta,
                                    const float* bmat, const float* x, int m,
                                    int tpc, int n_blocks,
                                    unsigned char* out_occ, int* out_stats,
                                    void* stream) {
  static const int attr = set_smem(
      reinterpret_cast<const void*>(cluster_occluded_kernel));
  if (attr != 0) return attr;
  if (n_blocks > 0) {
    cluster_occluded_kernel<<<n_blocks, NTHREADS, sizeof(Smem),
                              static_cast<cudaStream_t>(stream)>>>(
        boxes, meta, bmat, x, m, tpc, n_blocks * BLOCK, out_occ, out_stats);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the closest (anyhit = 0) or any-hit kernel resident on one SM
// at the launch configuration above (negative: a CUDA error code).
extern "C" int lh2_cluster_ctas_per_sm(int anyhit) {
  const void* k = anyhit ? reinterpret_cast<const void*>(cluster_occluded_kernel)
                         : reinterpret_cast<const void*>(cluster_closest_kernel);
  const int attr = set_smem(k);
  if (attr != 0) return -attr;
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, k, NTHREADS, sizeof(Smem));
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}
