// Path trace of a scene of spheres and triangle chunks on Hopper (sm_90a):
// one thread per pixel.
//
// Replaces the TPU kernel
//   ray_tracing_extended_tpu/kernels/megakernel.py::_render_kernel
// in its exact-spp, adaptive-refill and fast-scatter modes. It computes
// what that kernel computes: per pixel and frame, the PCG stream seeded
// pix + frame * 719393, the thin-lens camera ray (4 draws), the bounce loop
// (closest hit over spheres, then triangles; checker / invisible-light
// flags, the specular-lottery scatter with the dielectric extension,
// 7 draws, and Russian roulette, 1 draw; the environment light on a miss),
// the mean over the pixel's samples, and the fold into a running average
// with weight 1 / (f32(frame) + 1). It also counts each pixel's live path
// segments and, on request, the live paths per bounce index. The
// arithmetic follows the plain PyTorch version (ops/*.py and
// kernels/megakernel.py) operation for operation; built with -fmad=false,
// no multiply and add fuse, so the two differ only where the sphere and
// triangle tests' forms do (this kernel tests in the direct o - c and
// o - a forms, as the TPU kernel does; the plain version in the expanded
// forms) and where the device's transcendentals round differently.
//
// Two kernels, each instantiated for three scene geometries: kSpheres
// (spheres only); kChunks (the chunk table, each chunk's AABB and triangle
// range, beside the sphere tables; the triangles of the chunks that pass the
// gate below run the backface-culled Moller-Trumbore test on 12-float rows
// read through the read-only cache); kBvh (the triangles through the
// scene's LBVH in global memory, below). For the scatter sampler
// (kBoxMuller: the reference's three Box-Muller Gaussians, 6 draws;
// kFastScatter: the TPU kernel's 2-draw (z, phi) map, cfg.fast_scatter).
// And for where the sphere and chunk tables live (Tables): kStaged, copied
// into each block's shared memory; kGlobal, read in place through the
// read-only path, for a scene whose tables pass a block's 227 KB (about
// 9,000 spheres; the TPU kernel's counterpart falls back to the XLA path,
// render.py _use_megakernel). The two routes run the same operations in the
// same order, so their outputs are equal bit for bit; the global route pays
// a warp's divergent reads (lanes in different clusters read up to 32 rows
// where the staged route broadcasts one).
//   render_kernel<kGeom, kScatter>: exactly spp samples a pixel.
//   render_adaptive<kGeom, kScatter>: the adaptive sample refill
//   (cfg.adaptive_spp).
// Both run one slot loop (render_slots), the TPU kernel's persistent-lane
// scheduling with sample re-seeding (megakernel.py:30-41, :1709-1760):
// each slot, a dead lane that the schedule re-seeds starts its next camera
// sample, then every live lane traces one segment. The quota is n_frames *
// spp; a lane folds a frame after spp completed samples. The schedule
// (Schedule) says which dead lanes start a sample:
//   kExact (render_kernel): a lane that owes one itself, at once, so it
//   never waits for its warp-mates' longer paths. Each lane draws, sums
//   and folds exactly as a nested loop over frames, samples and bounces
//   would, so the images are that loop's bit for bit, without its idle
//   lanes (under it a warp ran each sample for as long as its longest
//   path).
//   kLockstep (render_kernel<kBvh>): such a lane once no lane of its warp
//   is live: the nested loop's schedule, bit for bit the same images,
//   faster on the mesh than kExact (see kBvh below).
//   kRefill (render_adaptive): also a lane of whose TS x TS tile a lane
//   still owes samples, the TPU kernel's vote over its tile
//   (megakernel.py:1813-1839; TS is kernels/megakernel.py
//   refill_tile_size's, 128, or 64 for a scene of its winner fetch). The
//   extra samples continue the last frame, whose mean divides by what it
//   completed. At most quota * (max_bounce + 1) slots; a sample in flight
//   at the bound is dropped. A 128 x 128 tile is 128 blocks, and a frame's
//   blocks are never all resident at once, so no launch can take that vote
//   slot by slot. It needs none: a lane that owes samples re-seeds the
//   moment its path ends, so until its quota is done it runs as under
//   kExact, live every slot, and it is done after exactly its exact-spp
//   segment count E; its tile's vote is true at slot s iff s < T, the
//   tile's largest E. So refill is two launches of render_adaptive. Phase
//   1 runs the kExact loop without the last frame's fold, keeps each lane
//   (its RNG state and the last frame's light in a scratch row, E in the
//   segment map, the running average of the earlier frames in an image)
//   and takes T, one atomicMax a warp. Phase 2 resumes each lane at its
//   slot E: a lane live every slot until it idles has its slot in its
//   segment count, so a dead lane re-seeds while that count is below T.
//   Then the fold. That is the slot machine over the tiles bit for bit
//   (kernels/megakernel.py _refill_two_phase). Phase 2's lanes resume at
//   different slots, and a warp runs until its last lane's path ends.
//   The TPU kernel's two lane knobs (Args.refill_ppl, refill_phases;
//   megakernel.py:473-482, :1808-1843): with ppl pixels a lane, a TPU lane
//   traces ppl pixels of its tile in turn and only the last takes extra
//   samples; with two phases a lane starts a sample on even slots only and
//   traces a bounce on odd ones, and the bound grows by both factors.
//   render_adaptive<..., kKnobs> runs them (kKnobRefill). A thread still
//   traces one pixel. Its slot is then no segment count: it keeps one
//   (lane_slot), and a lane that would wait for its phase's slot takes it
//   at once, which changes nothing else. Phase 1 writes each
//   pixel's E to a slot map; with one pixel a lane it also takes T, with
//   more the lane pass (refill_lanes, a third launch between the two) sums
//   each TPU lane's pixels, takes T and lists each lane's last pixel, and
//   phase 2 resumes a lane's last pixel at that sum, its other pixels not
//   at all. Then phase 1 writes every pixel's image without extra samples,
//   and phase 2 runs over the list, one thread a listed pixel: a launch
//   over the band would leave each 16 x 2 warp about 1 / ppl owed lanes.
//   That launch is render_listed<...> (kKnobList), an instantiation of its
//   own: a listed pixel is a loaded value live through the slot loop, where
//   a pixel of the grid is recomputed from the thread's index, and read at
//   run time in render_adaptive<..., kKnobs> it raised the spills of all
//   twelve and slowed phase 1 (PERF.md).
// Lanes outside the image stay in the loop with nothing owed: a full-mask
// vote needs all 32, and the loop's exit is decided by a vote, so it is
// warp-uniform.
//
// The two scans of a segment, both behind the TPU kernel's t-bounded slab
// test (megakernel.py tile_hits: a box is entered iff t_far >= 0 and
// t_near <= min(t_far, best t so far)):
//   spheres, through the clustered tables of kernels/pack.py (the TPU
//   kernel's pack_scene): the hoisted spheres (RTIOW's ground and heroes)
//   first, so their hit bounds every later test; then each sub-cluster of
//   up to 32 spheres behind its box, nearest box first: the launch takes
//   the cluster rows in its camera's front-to-back order (the TPU kernel's
//   _f2b, megakernel.py:2512-2533; kernels/megakernel.py front_to_back), so
//   an early near hit culls the boxes behind it. Over more than 32
//   clusters, in the kSpheres instantiations, a second level, the TPU
//   kernel's hierarchical cull
//   (megakernel.py:998-1019): one super box over each run of 32 clusters of
//   the table's Morton order, the supers nearest first and the clusters
//   within each nearest first (_f2b_within), a run skipped whole when its
//   super fails the gate. Without it the flat loop slab-tested every
//   cluster box on every segment: 450 a segment on 14,401 spheres, 3,121
//   on 99,857, 80% and 96% of the scan's operations (a CPU count on
//   RTIOW's camera rays). The TPU kernel votes a cluster in or out for
//   a whole tile of rays, then tests the cluster's spheres across the
//   tile's rays. A cluster holds at most 32 spheres, a warp's width, so
//   the kSpheres instantiations do the same on a warp (closest_sphere_warp,
//   scan_cluster_warp): the vote is a __ballot_sync of the live lanes'
//   gates; lane j holds the cluster's slot first + j (one 16-byte row; on
//   the global route one coalesced 512-byte read a visit, where a lane
//   walking the cluster alone read 32 rows one after another); then, for
//   each lane r in the ballot, the warp takes r's ray and best t from
//   lane r by shuffle, every lane runs the pair test on its own sphere,
//   and lane r adopts the candidates' nearest: a __reduce_min_sync over the
//   t bits (t >= 0, so they order as the floats do once -0 reads as +0),
//   and on an exact tie a second one over the scene index. A visit of k
//   lanes costs k such ray steps, where a lane-by-lane loop cost the
//   cluster's 32 sphere steps whatever k (a warp's camera rays are
//   neighbours and pass the same few clusters; in the slot loop its lanes
//   sit at different bounces and pass different ones). The scan runs on
//   every lane of the warp, before the slot loop's `if (live)`: a lane
//   that is not live casts false in every vote and holds a sphere for the
//   others. A visit of at least kWarpScanMax lanes runs the per-lane loop
//   instead (see its note). The triangle instantiations keep a per-lane
//   loop over a flat cluster list (closest_hit): each lane branches on its
//   own gate, so a warp pays for the union of its live lanes' clusters.
//   Only real spheres have a slot; the square root only
//   where disc >= 0. (Skipping it also where b > 0, whose root -b -
//   sqrt(disc) is negative whatever the square root, gave the same images
//   and cost 1.5-3% of a RTIOW 1080p frame on an NVIDIA H100 80GB HBM3 at
//   700 W: the second condition's branch outweighs the roots it saves.)
//   The nearest sphere wins and, on an exact tie, the one of lower index
//   in the scene: a lexicographic minimum of (t, scene index), which
//   neither the clustered order nor the order of a ballot's rays decides.
//   Each lane's best is updated before the next cluster's gate, so every
//   gate sees the best t of the lane-by-lane scan and the two give the
//   same tests and the same images, bit for bit.
//   chunks (kChunks), in index order behind the same test, two 16-byte
//   loads a chunk: a chunk behind the origin, or beyond the best hit so
//   far (spheres are tested first), is skipped. The reference's gate
//   (RayTracing.shader:177-187 at :279-281) passes every chunk the ray's
//   line meets. A scene of more than one run of 32 chunks gets a second
//   level, the TPU kernel's super-cluster: one box over each run, behind
//   the same test, and a run that fails it is skipped whole (Chess, 440
//   chunks in 14 runs, 1280x720, 3 spp, 15 bounces: 5.1 ms a frame with
//   it, 7.7 without, on an NVIDIA H100 80GB HBM3 at 700 W). The TPU kernel
//   votes a triangle sub-cluster in or out for its tile and tests it
//   across the tile's rays (megakernel.py:1333-1365); the chunk
//   instantiations do so on a warp, as the sphere ones do with clusters
//   (closest_triangle_warp, scan_chunk_warp): a chunk's gate is a ballot
//   of the live lanes', lane j holds triangles first + j, first + j + 32,
//   ... (a chunk holds up to 48, more where the split stops at its depth),
//   a ray a step by shuffles; a visit of many lanes for its size keeps the
//   per-lane loop (kChunkScanMax). A lane-by-lane loop cost a warp the
//   chunk's every triangle whether one lane or 32 entered it, each lane
//   reading each 48-byte row on its own.
// In both tests an axis whose t0 or t1 is NaN (a zero direction component,
// the origin on that face's plane) never rejects, the reference's rule: no
// primitive a scan without boxes would hit is skipped for it. A sphere
// cluster's box is one ulp wider each way than its spheres' c -+ r
// (kernels/megakernel.py sphere_tables), so it holds them after rounding.
// The winner's t is computed as without the culls; a cull decides only a
// near-tie that rounding puts on the other side of a box's entry.
//
// What bounds it on this card: FP32 ALU throughput of the tests that pass
// their gates plus the gates themselves, about pixels x samples x segments
// x (boxes + gated spheres + gated triangles), and warp divergence: lanes
// of one warp in different clusters and chunks, and long and short paths;
// past the shared-memory limit the latency of those lanes' divergent L2
// reads of cluster rows. What this version does about it: the tables in
// shared memory where they fit, loaded once per block and read as
// warp-wide broadcasts; the culls above, whose two levels and visit order
// keep the box tests a segment near the gated spheres' count rather than
// the cluster count (and the rows read with them); in the sphere
// instantiations the warp-cooperative cluster scan, in the chunk ones the
// chunk scan, whose steps follow the lanes that entered a cluster or chunk
// rather than its size; the slot loop, in which a lane whose path ended
// starts its next sample at once instead of idling behind a warp-mate's
// long path (kExact; with refill it also traces extra samples once its own
// are done). The order is the camera's, as the TPU kernel's: a bounce ray
// starts elsewhere. No path is handed to another lane or warp: a warp's
// live lanes stay its own, and only their rays are lent to the cooperative
// scans' steps.
// How pixels reach threads: as the TPU grid's tiles did, one 16x8 block per
// 128 pixels and one pixel a thread for the launch, in every kernel. A
// pixel queue was measured against it (tools/scan_ab.py, 10 pairs, on an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md): resident blocks, as many as
// the SMs hold, whose warps take 16x2 tiles from a counter in global
// memory, a lane whose pixel is done taking the tile's next pixel. Bit for
// bit the same images, 0.90x the warp-slots of an exact RTIOW 1080p
// launch of 4 frames, and 1.034x its frame time; Chess 1.128x, Cornell
// 1.138x, the wide sphere scenes 1.022-1.039x. The closest hit took the
// loss (RTIOW 4.88 -> 5.89 ms a frame) while the rest fell (1.72 -> 0.97):
// lanes of other pixels in a slot, above all of another tile, enter more
// clusters and chunks, and a slot costs what its live lanes' scans cost
// together, so the lanes that idle at the end of a tile were the cheaper
// waste. Whole tiles a warp (its lanes start the next tile together) were
// within 2% on RTIOW and 3-5% slower on Chess. The BVH kernels start a
// warp's samples together on purpose (kLockstep, below).
// How a sphere cluster's rays reach lanes: the warp's own, as above. The
// TPU kernel's tile vote with the entering rays packed
// (megakernel.py:838-863, on a block's four warps) was measured against
// it (tools/scan_ab.py, 10 pairs, on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md): the block's rays in a table in shared memory (8.7 KB a block),
// each live lane's gate in the rows' order, a ballot a warp and the warps'
// counts placing the entering rays in a list, the list tested 32 rays a
// warp step, each warp a quarter of the cluster's spheres and the owner
// taking the parts' lexicographic minimum of (t, scene index), the slot
// loop's exit block-uniform. Bit for bit the same images, and counted on
// RTIOW's band 0.72x the per-lane loop's sphere steps and 0.94-0.98x this
// scan's (kernels/megakernel.py schedule_counts, "block"); on the card
// 1.23x this kernel's frame on RTIOW 1080p exact (8.334 against 6.783 ms),
// 1.31x with refill, 1.39-1.54x on the wide sphere scenes, no pair of 10
// won; its closest hit took 6.80 ms a frame where this one takes 4.88. A
// visit costs three barriers and a cluster no lane entered one, some
// twenty a slot; at each the block's warps wait for the slowest, and the
// seven blocks an SM holds leave too few warps to hide the pair tests'
// latency: the list's batches dealt round-robin to the warps were 8.54 ms,
// and with five blocks an SM and no spills 9.83.
//
// kBvh, for big meshes (mesh_scene's 70,016 triangles in one chunk, which
// the chunk scan would test in full every segment). It replaces the TPU
// kernel's big-scene mode, the winner post-pass fetch (megakernel.py
// :1258-1430) with the per-row drain of culled sub-clusters (:92-135,
// :896-1250): those exist because a TPU lane cannot branch on its own. A
// Hopper thread can walk its own stack, so each thread traverses the LBVH
// of accel/bvh.py and visits the nodes and triangles that the JAX
// package's _traverse (bvh.py:269-340) visits, in its order: at an
// internal node slab-test both children against the best t so far (a NaN
// slab rejects, as jnp.minimum / maximum propagate NaN) and push the
// survivors, the far one first; at a leaf test its triangles in order with
// a strict <; at most 4 x nodes pops. The triangle test is
// chunk_triangle_hit's direct form. As in closest_hit_bvh the traversal
// starts from t = inf and its winner replaces the sphere scan's only if
// strictly nearer, so the kernel and its plain version (accel/bvh.py
// _traverse, which makes the same steps) test the same triangles in the
// same order and agree on ties.
// What bounds it on this card: the latency of dependent, divergent reads
// (a thread cannot test a node before its row arrives; mesh_scene's
// 24,871 internal rows take 1.6 MB, its triangle rows and normals 5.9 MB:
// L2-resident), not its operations (37.4 slab and 5.3 triangle tests a
// segment are 1/68 of the frame). So the traversal reads as little, and
// as few times in a row, as it can:
//   - children in the parent: an internal node's row holds both children's
//     boxes and references, one 64-byte read (two sectors) whose address
//     the stack entry holds, with no second, dependent read; a reference
//     to a leaf names its leaf row and real slot count, so a leaf costs
//     its row of slots and no node read. The root's box is tested once,
//     from row 0.
//   - t_near on the stack: a push stores the child's reference with the
//     t_near of its slab test; a pop drops an entry whose t_near is beyond
//     the best t without reading memory. (A pushed child passed t_far >= 0
//     and t_near <= min(t_far, best at the push); the best only falls; a
//     NaN slab is never pushed: the JAX package's test at the pop is then
//     exactly t_near <= best.)
//   - real slots only: the build puts a leaf's real triangles first, and
//     the sentinel padding triangle never hits.
// The stack: 8 bytes an entry (reference, t_near) in a local array of
// kStackDepth entries a thread (L1-cached; its top entries are the ones
// in use). The traversal is inlined into the kernels, and the kBvh
// instantiations are compiled for 8 blocks of 128 threads an SM (64
// registers). On an NVIDIA H100 80GB HBM3 at 700 W, mesh_scene at
// 1280x720, K=4 frames a launch, A/B in one call each against this
// version: the stack in shared memory, [slot][thread] and sized from the
// tree's depth + 1 (23.5 KB a block), was 5-8% slower exact; the
// traversal as a __noinline__ function 4-6% slower; without the 8-block
// bound up to 10% slower with refill and fast scatter (PERF.md).
// The exact kBvh kernels start a warp's samples together (kLockstep). A
// lane re-seeded at once (kExact) walks a camera ray's path beside its
// warp-mates' bounce rays, and the warp pays the longer walk of the two
// each slot. mesh_scene 1280x720, 1 spp, 4 bounces, K = 4 frames a
// launch, tools/scan_ab.py on an NVIDIA H100 80GB HBM3 at 700 W: kExact
// 1.68-1.80 ms a frame (six runs), the nested loop 1.61-1.75, kLockstep
// 1.54-1.63 (ten pairs with the nested loop; PERF.md).
//
// A launch renders a band of the frame's rows, y0 .. y1 - 1 (the whole
// frame is the band 0 .. height): the grid covers the band only, and a
// thread's row y is the frame's, so its seed (pix = y * width + x), its
// camera ray and its tests are the whole-frame launch's; the image, the
// segment map and the accumulator it reads hold the band's rows. The
// multi-GPU split (parallel/sharding.py) launches one band a device and
// stitches the bands into the whole-frame launch's image bit for bit.
// With refill a band starts and ends on a row of refill tiles (y0, and y1
// unless it is height, multiples of the tile's side), so it holds whole
// tiles, the whole frame's, and their last finishes are the same.
//
// C interface, loaded with ctypes (kernels/megakernel.py):
//   rtx_render(geometry, ...) launches on the given stream and returns
//   cudaGetLastError(); rtx_shared_bytes(geometry, ...) is a launch's
//   dynamic shared memory; rtx_occupancy(geometry, ...) the blocks of an
//   instantiation one SM holds; rtx_error_string(code) names an error.
//   Built with -DRTX_PROBES, the same source is a probe library: the
//   profiling instantiations (Probe, below) behind rtx_render_probe in
//   place of the production ones behind rtx_render, one library for each
//   Probe, sampler and route (-DRTX_PROBE, -DRTX_FAST_SCATTER,
//   -DRTX_TABLES), each with every production kernel under its knob, so a
//   launch builds only the library it needs (kernels/megakernel.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

// params layout (f32, kParams):
//   0-2 camera position   3-11 camera rotation, row-major (columns are
//   right, up, forward)   12 plane_w  13 plane_h  14 focus distance
//   15 defocus disc radius  16 diverge disc radius  17 environment on
//   18-20 ground  21-23 horizon  24-26 zenith  27 sun focus
//   28 sun intensity  29-31 sun direction
constexpr int kParams = 32;
// sphere table row, one float4: cx, cy, cz, r^2
// sphere cluster row, two float4s: (box min, first slot), (box max, live
// slots), the two counts as int32 bits
// material table row: colour 0-2, emission colour 3-5, specular colour
// 6-8, emission strength 9, smoothness 10, specular probability 11,
// ior 12, flag 13, pad 14-15
constexpr int kMat = 16;
// chunk table row, two float4s: (box min, first triangle), (box max,
// triangle count), the two counts as int32 bits
// triangle row: a 0-2, b - a 3-5, c - a 6-8, cross(b - a, c - a) 9-11
constexpr int kTri = 12;
constexpr int kTri4 = kTri / 4;  // the row in float4s
// vertex-normal row: the normal at a 0-2, at b 3-5, at c 6-8
constexpr int kTriNrm = 9;
// BVH node table (kernels/megakernel.py bvh_node_table), rows of four
// float4s (64 bytes): row 0 (root min xyz, root ref), (root max xyz, 0),
// then zeros; row 1 + k, the k-th internal node of the BVH: (left min
// xyz, left ref), (left max xyz, 0), (right min xyz, right ref), (right
// max xyz, 0). A ref, int32 bits: an internal node's row (>= 1), or for a
// leaf ~(leaf row << kLeafCountBits | real slots) < 0.
constexpr int kNodeRow4 = 4;  // a row in float4s
constexpr int kLeafCountBits = 3;
// Leaf row: kLeafWidth primitive indices, one int4, the real ones first,
// then the sentinel (the scene's first padding triangle).
constexpr int kLeafWidth = 4;
// The traversal stack (accel/bvh.py STACK_DEPTH): pushes clamp to its last
// slot, as in the reference; build_lbvh refuses deeper trees.
constexpr int kStackDepth = 48;

constexpr int kFlagChecker = 1;
constexpr int kFlagInvisibleLight = 2;
constexpr int kFlagDielectric = 3;

// Moller-Trumbore backface cull / degeneracy threshold
// (RayTracing.shader:169).
constexpr float kDetEps = 1e-6f;

// f32(1) / f32(2^32 - 1): the f32 literal rounds to 2^32, as in HLSL.
constexpr float kInvU32Max = 1.0f / 4294967296.0f;
constexpr uint32_t kFrameSeedStride = 719393u;
// The fast sampler's angle scale, f32(2 * 3.14159265), as the TPU kernel's
// _rand_unit3_fast spells it.
constexpr float kTwoPiFast = static_cast<float>(2.0 * 3.14159265);

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;
// The TPU kernel's lanes: its tile is rows of 128 pixels, a lane a column.
constexpr int kLanes = 128;

// The scatter's unit-vector sampler.
enum Scatter : bool { kBoxMuller = false, kFastScatter = true };

// How a scene's triangles are found (the C interface's `geometry`).
enum Geometry : int { kSpheres = 0, kChunks = 1, kBvh = 2 };

// Where a launch reads the scene's float4 tables (sphere rows, sphere
// clusters, chunks, the boxes over runs of chunks) and the spheres' scene and
// material indices (the C interface's `tables`): kStaged, copied into the
// block's shared memory; kGlobal, read in place through the read-only path
// (__ldg), for a scene whose tables do not fit a block's shared memory
// (kernels/megakernel.py picks the route by shared_bytes). The parameters and
// the block's bounce histogram are staged on both routes.
enum Tables : int { kStaged = 0, kGlobal = 1 };

// A read of one of those tables: a plain load where the block staged it
// (LDS), a read-only global load where it did not (LDG).
template <Tables kTab, typename T>
__device__ __forceinline__ T table_load(const T* p) {
  if constexpr (kTab == kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 add(Vec3 a, Vec3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ Vec3 sub(Vec3 a, Vec3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ Vec3 scale(Vec3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ float dot(Vec3 a, Vec3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ Vec3 normalize(Vec3 v) {
  return scale(v, rsqrtf(dot(v, v)));
}
// HLSL reflect: i - (2 dot(i, n)) n
__device__ __forceinline__ Vec3 reflect(Vec3 i, Vec3 n) {
  return sub(i, scale(n, 2.0f * dot(i, n)));
}
// HLSL lerp: a + t (b - a)
__device__ __forceinline__ Vec3 lerp(Vec3 a, Vec3 b, float t) {
  return add(a, scale(sub(b, a), t));
}
__device__ __forceinline__ Vec3 mul(Vec3 a, Vec3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// ---- PCG (RayTracing.shader:193-230) ----

__device__ __forceinline__ uint32_t next_random(uint32_t& state) {
  state = state * 747796405u + 2891336453u;
  const uint32_t shift = (state >> 28) + 4u;
  const uint32_t r = ((state >> shift) ^ state) * 277803737u;
  return (r >> 22) ^ r;
}

// u32 -> f32 rounds to nearest, like XLA's and PyTorch's conversions.
__device__ __forceinline__ float random_value(uint32_t& state) {
  return __uint2float_rn(next_random(state)) * kInvU32Max;
}

// Box-Muller, cos branch; log(0) = -inf is kept, as in the reference.
__device__ __forceinline__ float random_normal(uint32_t& state) {
  const float r1 = random_value(state);
  const float r2 = random_value(state);
  const float theta = (2.0f * 3.1415926f) * r1;
  const float rho = sqrtf(-2.0f * logf(r2));
  return rho * cosf(theta);
}

__device__ __forceinline__ Vec3 random_direction(uint32_t& state) {
  const float x = random_normal(state);
  const float y = random_normal(state);
  const float z = random_normal(state);
  const float inv = rsqrtf(x * x + y * y + z * z);
  return {x * inv, y * inv, z * inv};
}

// Uniform unit vector by the area-preserving (z, phi) map, 2 draws
// (ops/rng.py random_direction_fast).
__device__ __forceinline__ Vec3 random_direction_fast(uint32_t& state) {
  const float u = random_value(state);
  const float v = random_value(state);
  const float z = u * 2.0f - 1.0f;
  const float phi = v * kTwoPiFast;
  const float s = sqrtf(fmaxf(1.0f - z * z, 0.0f));
  return {s * cosf(phi), s * sinf(phi), z};
}

// Uniform point in the unit disc, scaled by `radius_scale`.
__device__ __forceinline__ void random_point_in_circle(
    uint32_t& state, float radius_scale, float& cx, float& cy) {
  const float r1 = random_value(state);
  const float angle = r1 * 2.0f * 3.1415f;
  const float r2 = random_value(state);
  const float radius = sqrtf(r2);
  cx = cosf(angle) * radius * radius_scale;
  cy = sinf(angle) * radius * radius_scale;
}

// ---- environment (RayTracing.shader:238-251) ----

__device__ __forceinline__ float smoothstep01(float t) {
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  return t * t * (3.0f - 2.0f * t);
}

__device__ Vec3 environment(const float* p, Vec3 d) {
  const float sky_t = powf(smoothstep01((d.y - 0.0f) / 0.4f), 0.35f);
  const float ground_t = smoothstep01((d.y - (-0.01f)) / 0.01f);
  const Vec3 ground = {p[18], p[19], p[20]};
  const Vec3 horizon = {p[21], p[22], p[23]};
  const Vec3 zenith = {p[24], p[25], p[26]};
  const Vec3 sun_dir = {p[29], p[30], p[31]};
  const Vec3 sky = lerp(horizon, zenith, sky_t);
  const float sun = powf(fmaxf(dot(d, sun_dir), 0.0f), p[27]) * p[28];
  Vec3 c = lerp(ground, sky, ground_t);
  const float sun_on = sun * (ground_t >= 1.0f ? 1.0f : 0.0f);
  c = {c.x + sun_on, c.y + sun_on, c.z + sun_on};
  return scale(c, p[17]);
}

// RTIOW dielectric direction (ops/materials.py _refract_dir).
__device__ Vec3 refract_dir(Vec3 d, Vec3 n, float ior, float u_fresnel) {
  const bool entering = dot(d, n) < 0.0f;
  const Vec3 ne = entering ? n : Vec3{-n.x, -n.y, -n.z};
  const float eta = entering ? 1.0f / ior : ior;
  const float cos_t = fminf(-dot(d, ne), 1.0f);
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const bool cannot_refract = eta * sin_t > 1.0f;
  float r0 = (1.0f - eta) / (1.0f + eta);
  r0 = r0 * r0;
  const float schlick = r0 + (1.0f - r0) * powf(1.0f - cos_t, 5.0f);
  if (cannot_refract || schlick > u_fresnel) return reflect(d, ne);
  const Vec3 r_perp = scale(add(d, scale(ne, cos_t)), eta);
  const float k = fmaxf(1.0f - dot(r_perp, r_perp), 0.0f);
  return sub(r_perp, scale(ne, sqrtf(k)));
}

// ---- triangles (kChunks and kBvh) ----

// The scene's triangles in global memory, and the chunk table the kernel
// stages in shared memory (kChunks; in global memory on the kGlobal route)
// or the BVH in global memory (kBvh).
template <Tables kTab>
struct Triangles {
  const float4* __restrict__ rows;  // kTri floats (kTri4 float4s) a triangle
  const float* __restrict__ normals;  // kTriNrm floats a triangle
  const int* __restrict__ mat;  // material index a triangle
  const float4* chunks;  // two float4s a chunk
  int n_chunks;
  // two float4s (box min, box max) over each run of super_size chunks;
  // n_supers == 0: no second level
  const float4* supers;
  int n_supers, super_size;
  const float4* __restrict__ nodes;  // kNodeRow4 float4s a row
  const int4* __restrict__ leaves;  // kLeafWidth indices a leaf
  int n_nodes;  // the BVH's nodes
  // kChunks: whether a chunk visit can go across the warp (a chunk holds
  // enough triangles for one lane; see kChunkScanMax)
  int warp_scan;
#ifdef RTX_PROBES
  int n_tris;  // the triangle rows, every one that kNoCull tests under kBvh
#endif
};

// One axis of a slab test. An axis whose t0 or t1 is NaN (a zero direction
// component, the origin on the box's face) leaves t_near and t_far as they
// are, so it never rejects the box: the ray's line lies in that face's
// plane (the reference's RayBoundingBox, RayTracing.shader:177-187, whose
// min and max drop a NaN operand).
__device__ __forceinline__ void slab(float lo, float hi, float o, float inv_d,
                                     float& t_near, float& t_far) {
  const float t0 = (lo - o) * inv_d;
  const float t1 = (hi - o) * inv_d;
  if (t0 == t0 && t1 == t1) {
    t_near = fmaxf(t_near, fminf(t0, t1));
    t_far = fminf(t_far, fmaxf(t0, t1));
  }
}

// The t-bounded gate of a sphere cluster or a chunk (the TPU kernel's
// tile_hits): the box's slab interval reaches in front of the origin and
// starts no later than the best hit so far.
__device__ __forceinline__ bool box_gate(float4 lo, float4 hi, Vec3 o,
                                         Vec3 inv_d, float best_t) {
  float t_near = -__int_as_float(0x7f800000);
  float t_far = __int_as_float(0x7f800000);
  slab(lo.x, hi.x, o.x, inv_d.x, t_near, t_far);
  slab(lo.y, hi.y, o.y, inv_d.y, t_near, t_far);
  slab(lo.z, hi.z, o.z, inv_d.z, t_near, t_far);
  return t_far >= 0.0f && t_near <= fminf(t_far, best_t);
}

// The backface-culled Moller-Trumbore test of the triangle whose row is
// r0, r1, r2 against the ray (o, d), in the direct form: a hit iff det >=
// 1e-6 and t, u, v, w >= 0, at t = t_det / det. The chunk scans' one
// test, per lane and across the warp.
//   r0 = a.x a.y a.z ab.x   r1 = ab.y ab.z ac.x ac.y   r2 = ac.z n.x n.y n.z
__device__ __forceinline__ bool chunk_triangle_hit(float4 r0, float4 r1,
                                                   float4 r2, Vec3 o, Vec3 d,
                                                   float& t) {
  const Vec3 ao = {o.x - r0.x, o.y - r0.y, o.z - r0.z};
  const Vec3 dao = cross(ao, d);
  const float det = -(d.x * r2.y + d.y * r2.z + d.z * r2.w);
  const float t_det = ao.x * r2.y + ao.y * r2.z + ao.z * r2.w;
  const float u_det = r1.z * dao.x + r1.w * dao.y + r2.x * dao.z;
  const float v_det = -(r0.w * dao.x + r1.x * dao.y + r1.y * dao.z);
  const float w_det = det - u_det - v_det;
  if (det >= kDetEps && t_det >= 0.0f && u_det >= 0.0f && v_det >= 0.0f &&
      w_det >= 0.0f) {
    t = t_det / det;
    return true;
  }
  return false;
}

// A chunk visit of at least this many lanes a full run of 32 triangles
// runs the per-lane loop (each lane of the ballot tests the chunk's
// triangles in index order), a smaller one the warp-cooperative scan (a
// ray a step, a triangle a lane): a visit of k lanes to a chunk of n
// triangles goes across the warp iff k * 32 * ceil(n / 32) < kChunkScanMax
// * n, so a chunk that fills a part of its runs of 32 needs fewer lanes
// (see scan_chunk_warp). Mirrored by kernels/megakernel.py
// CHUNK_SCAN_MAX; chosen on the card (PERF.md).
constexpr int kChunkScanMax = 12;

// One chunk, triangles [first, first + count), for the rays of the lanes
// set in `m`, the ballot of its gate; every lane of the warp calls it. The
// per-lane loop for a visit of many lanes (kChunkScanMax). Else, for each
// run of 32 of the chunk's triangles, lane j holds triangle first + base +
// j (three 16-byte rows, read once a run; lanes past the chunk's end hold
// none), then, a ray a step, the owner lane's ray and best t come by
// shuffle, every lane runs chunk_triangle_hit on its triangle, and a lane
// proposes a hit strictly nearer than the ray's best; the owner takes the
// candidates' lexicographic minimum of (t, triangle index) (t >= 0, so its
// bits order as the floats do once -0 reads as +0; the lower lane is the
// lower index) and adopts it if strictly nearer than its best. The per-lane
// loop tests in index order and keeps the first of equal nearest hits, so
// the ray's best after the chunk is the same, and a sphere keeps a tie.
template <Tables kTab>
__device__ __forceinline__ void scan_chunk_warp(Triangles<kTab> tri,
                                                unsigned m, int first,
                                                int count, Vec3 o, Vec3 d,
                                                float& best_t, int& best_tri) {
  const int lane = (threadIdx.y * kBlockX + threadIdx.x) & (kWarp - 1);
  const int runs = (count + kWarp - 1) / kWarp;
  if (__popc(m) * kWarp * runs >= kChunkScanMax * count) {
    if ((m >> lane) & 1u) {
      for (int i = first; i < first + count; ++i) {
        float t;
        if (chunk_triangle_hit(__ldg(tri.rows + kTri4 * i),
                               __ldg(tri.rows + kTri4 * i + 1),
                               __ldg(tri.rows + kTri4 * i + 2), o, d, t) &&
            t < best_t) {
          best_t = t;
          best_tri = i;
        }
      }
    }
    return;
  }
  for (int base = first; base < first + count; base += kWarp) {
    const int i = base + lane;
    const bool holds = i < first + count;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 r0 = holds ? __ldg(tri.rows + kTri4 * i) : zero;
    const float4 r1 = holds ? __ldg(tri.rows + kTri4 * i + 1) : zero;
    const float4 r2 = holds ? __ldg(tri.rows + kTri4 * i + 2) : zero;
    unsigned rays = m;
    do {
      const int r = __ffs(rays) - 1;
      rays &= rays - 1u;
      const Vec3 ro = {__shfl_sync(kFullMask, o.x, r),
                       __shfl_sync(kFullMask, o.y, r),
                       __shfl_sync(kFullMask, o.z, r)};
      const Vec3 rd = {__shfl_sync(kFullMask, d.x, r),
                       __shfl_sync(kFullMask, d.y, r),
                       __shfl_sync(kFullMask, d.z, r)};
      const float r_best = __shfl_sync(kFullMask, best_t, r);
      float t = 0.0f;
      const bool candidate =
          holds && chunk_triangle_hit(r0, r1, r2, ro, rd, t) && t < r_best;
      const unsigned hits = __ballot_sync(kFullMask, candidate);
      if (hits == 0u) continue;
      const unsigned key =
          candidate ? __float_as_uint(t) & 0x7fffffffu : 0xffffffffu;
      const unsigned nearest = __reduce_min_sync(kFullMask, key);
      const int w = __ffs(__ballot_sync(kFullMask, key == nearest)) - 1;
      const float t_w = __shfl_sync(kFullMask, t, w);
      if (lane == r && t_w < best_t) {
        best_t = t_w;
        best_tri = base + w;
      }
    } while (rays != 0u);
  }
}

// Closest triangle of the chunks that pass the gate, in index order, each
// lane on its own; a strictly nearer hit wins, so the lower index wins a
// tie and a triangle never takes a tie from a sphere (tested before). With
// a second level, a run of chunks is entered only if the box over it
// passes the same gate.
template <Tables kTab>
__device__ __forceinline__ void closest_triangle(Triangles<kTab> tri, Vec3 o,
                                                 Vec3 d, Vec3 inv_d,
                                                 float& best_t,
                                                 int& best_tri) {
  const int n_outer = tri.n_supers > 0 ? tri.n_supers : 1;
  for (int s = 0; s < n_outer; ++s) {
    int c = 0, c_end = tri.n_chunks;
    if (tri.n_supers > 0) {
      if (!box_gate(table_load<kTab>(tri.supers + 2 * s),
                    table_load<kTab>(tri.supers + 2 * s + 1), o, inv_d,
                    best_t)) {
        continue;
      }
      c = tri.super_size * s;
      c_end = min(c + tri.super_size, tri.n_chunks);
    }
    for (; c < c_end; ++c) {
      const float4 lo = table_load<kTab>(tri.chunks + 2 * c);
      const float4 hi = table_load<kTab>(tri.chunks + 2 * c + 1);
      if (!box_gate(lo, hi, o, inv_d, best_t)) continue;
      const int first = __float_as_int(lo.w);
      const int end = first + __float_as_int(hi.w);
      for (int i = first; i < end; ++i) {
        float t;
        if (chunk_triangle_hit(__ldg(tri.rows + kTri4 * i),
                               __ldg(tri.rows + kTri4 * i + 1),
                               __ldg(tri.rows + kTri4 * i + 2), o, d, t) &&
            t < best_t) {
          best_t = t;
          best_tri = i;
        }
      }
    }
  }
}

// The chunk geometry's closest triangle, run by every lane of the warp
// (`live` lanes hold a ray; the others cast false in every vote and take
// part in the shuffles): the chunks in index order, each behind the ballot
// of its gate, with a second level each run of chunks behind the gate of
// the box over it (a lane whose run box failed casts false for the run's
// chunks), scan_chunk_warp for a chunk that any lane entered. A lane's
// best is updated before the next gate, so each gate sees the best t of
// the per-lane scan: a lane tests the chunks, and the triangles, that a
// lane alone would. In a scene none of whose chunks could go across the
// warp (tri.warp_scan: Cornell's six chunks of two triangles), the votes
// would only cost: each live lane scans alone (closest_triangle). Cornell
// 512x512, K = 4, ran 7-15% slower with the votes (tools/scan_ab.py on an
// NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
template <Tables kTab>
__device__ __forceinline__ void closest_triangle_warp(Triangles<kTab> tri,
                                                      bool live, Vec3 o,
                                                      Vec3 d, Vec3 inv_d,
                                                      float& best_t,
                                                      int& best_tri) {
  if (!tri.warp_scan) {
    if (live) closest_triangle(tri, o, d, inv_d, best_t, best_tri);
    return;
  }
  const int n_outer = tri.n_supers > 0 ? tri.n_supers : 1;
  for (int s = 0; s < n_outer; ++s) {
    int c = 0, c_end = tri.n_chunks;
    bool entered = live;
    if (tri.n_supers > 0) {
      entered = live && box_gate(table_load<kTab>(tri.supers + 2 * s),
                                 table_load<kTab>(tri.supers + 2 * s + 1), o,
                                 inv_d, best_t);
      if (!__any_sync(kFullMask, entered)) continue;
      c = tri.super_size * s;
      c_end = min(c + tri.super_size, tri.n_chunks);
    }
    for (; c < c_end; ++c) {
      const float4 lo = table_load<kTab>(tri.chunks + 2 * c);
      const float4 hi = table_load<kTab>(tri.chunks + 2 * c + 1);
      const unsigned m = __ballot_sync(
          kFullMask, entered && box_gate(lo, hi, o, inv_d, best_t));
      if (m != 0u) {
        scan_chunk_warp(tri, m, __float_as_int(lo.w), __float_as_int(hi.w), o,
                        d, best_t, best_tri);
      }
    }
  }
}

// The BVH's slab test (accel/bvh.py _slab and its visit rule): true iff
// t_far >= 0 and t_near <= min(t_far, best_t). Unlike the chunk gate, an
// axis whose t0 or t1 is NaN rejects the node: the reference's
// jnp.minimum / maximum propagate the NaN and every comparison fails.
__device__ __forceinline__ bool bvh_box(float4 lo, float4 hi, Vec3 o,
                                        Vec3 inv_d, float best_t,
                                        float& t_near) {
  const float t0x = (lo.x - o.x) * inv_d.x, t1x = (hi.x - o.x) * inv_d.x;
  const float t0y = (lo.y - o.y) * inv_d.y, t1y = (hi.y - o.y) * inv_d.y;
  const float t0z = (lo.z - o.z) * inv_d.z, t1z = (hi.z - o.z) * inv_d.z;
  if (isnan(t0x) || isnan(t1x) || isnan(t0y) || isnan(t1y) || isnan(t0z) ||
      isnan(t1z)) {
    return false;
  }
  t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float t_far =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return t_far >= 0.0f && t_near <= fminf(t_far, best_t);
}

// Hit distance of triangle i, +inf on a miss (accel/bvh.py
// _triangle_t_one): chunk_triangle_hit's test, in a copy of its own, which
// keeps the BVH instantiations' code as it was.
template <Tables kTab>
__device__ __forceinline__ float triangle_t(Triangles<kTab> tri, int i, Vec3 o,
                                            Vec3 d) {
  const float4 r0 = __ldg(tri.rows + kTri4 * i);
  const float4 r1 = __ldg(tri.rows + kTri4 * i + 1);
  const float4 r2 = __ldg(tri.rows + kTri4 * i + 2);
  const Vec3 ao = {o.x - r0.x, o.y - r0.y, o.z - r0.z};
  const Vec3 dao = cross(ao, d);
  const float det = -(d.x * r2.y + d.y * r2.z + d.z * r2.w);
  const float t_det = ao.x * r2.y + ao.y * r2.z + ao.z * r2.w;
  const float u_det = r1.z * dao.x + r1.w * dao.y + r2.x * dao.z;
  const float v_det = -(r0.w * dao.x + r1.x * dao.y + r1.y * dao.z);
  const float w_det = det - u_det - v_det;
  if (det >= kDetEps && t_det >= 0.0f && u_det >= 0.0f && v_det >= 0.0f &&
      w_det >= 0.0f) {
    return t_det / det;
  }
  return __int_as_float(0x7f800000);
}

struct TriangleHit {
  float t;  // +inf on a miss
  int i;
};

// One traversal stack entry: a node reference and its t_near's bits.
__device__ __forceinline__ int2 entry(int ref, float t_near) {
  return make_int2(ref, __float_as_int(t_near));
}

// Closest triangle through the BVH (accel/bvh.py _traverse): the
// traversal's own best starts at +inf.
template <Tables kTab>
__device__ __forceinline__ TriangleHit closest_triangle_bvh(
    Triangles<kTab> tri, Vec3 o, Vec3 d) {
  const Vec3 inv_d = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  float t_best = __int_as_float(0x7f800000);
  int i_best = 0;
  // the root's box, tested once: the first of at most 4 x nodes pops
  const float4 root_lo = __ldg(tri.nodes);
  const float4 root_hi = __ldg(tri.nodes + 1);
  float t_root;
  if (!bvh_box(root_lo, root_hi, o, inv_d, t_best, t_root)) {
    return {t_best, i_best};
  }
  int2 stack[kStackDepth];
  constexpr int last = kStackDepth - 1;
  stack[0] = entry(__float_as_int(root_lo.w), t_root);
  int ptr = 1;
  const int max_pops = 4 * tri.n_nodes;
  for (int it = 1; ptr > 0 && it < max_pops; ++it) {
    const int2 e = stack[--ptr];
    if (__int_as_float(e.y) > t_best) continue;
    if (e.x < 0) {
      const int leaf = ~e.x;
      const int n = leaf & ((1 << kLeafCountBits) - 1);
      const int4 prims = __ldg(tri.leaves + (leaf >> kLeafCountBits));
      const int slot[kLeafWidth] = {prims.x, prims.y, prims.z, prims.w};
#pragma unroll
      for (int j = 0; j < kLeafWidth; ++j) {
        if (j < n) {
          const float t = triangle_t(tri, slot[j], o, d);
          if (t < t_best) {
            t_best = t;
            i_best = slot[j];
          }
        }
      }
      continue;
    }
    const float4* row = tri.nodes + kNodeRow4 * e.x;
    const float4 l_lo = __ldg(row), l_hi = __ldg(row + 1);
    const float4 r_lo = __ldg(row + 2), r_hi = __ldg(row + 3);
    float tn_l, tn_r;
    const bool hit_l = bvh_box(l_lo, l_hi, o, inv_d, t_best, tn_l);
    const bool hit_r = bvh_box(r_lo, r_hi, o, inv_d, t_best, tn_r);
    const int2 left = entry(__float_as_int(l_lo.w), tn_l);
    const int2 right = entry(__float_as_int(r_lo.w), tn_r);
    if (hit_l && hit_r) {
      const bool l_near = tn_l <= tn_r;
      stack[min(ptr, last)] = l_near ? right : left;  // far
      stack[min(ptr + 1, last)] = l_near ? left : right;  // near
      ptr += 2;
    } else if (hit_l || hit_r) {
      stack[min(ptr, last)] = hit_l ? left : right;
      ptr += 1;
    }
  }
  return {t_best, i_best};
}

// Shading normal of triangle i where the ray hits it (ops/intersect.py
// _triangle_normal_at): barycentrics in the direct form, the vertex normals
// interpolated and normalised.
template <Tables kTab>
__device__ __forceinline__ Vec3 triangle_normal(Triangles<kTab> tri, int i,
                                                Vec3 o, Vec3 d) {
  const float4 r0 = __ldg(tri.rows + kTri4 * i);
  const float4 r1 = __ldg(tri.rows + kTri4 * i + 1);
  const float4 r2 = __ldg(tri.rows + kTri4 * i + 2);
  const Vec3 ao = {o.x - r0.x, o.y - r0.y, o.z - r0.z};
  const Vec3 dao = cross(ao, d);
  const float det = -(d.x * r2.y + d.y * r2.z + d.z * r2.w);
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float u = (r1.z * dao.x + r1.w * dao.y + r2.x * dao.z) * inv_det;
  const float v = -(r0.w * dao.x + r1.x * dao.y + r1.y * dao.z) * inv_det;
  const float w = 1.0f - u - v;
  const float* n = tri.normals + kTriNrm * i;
  const Vec3 raw = {
      __ldg(n + 0) * w + __ldg(n + 3) * u + __ldg(n + 6) * v,
      __ldg(n + 1) * w + __ldg(n + 4) * u + __ldg(n + 7) * v,
      __ldg(n + 2) * w + __ldg(n + 5) * u + __ldg(n + 8) * v,
  };
  return normalize(raw);
}

// The sphere tables, in clustered order: the hoisted spheres in slots
// [0, n_hoist), then each cluster's spheres; in the block's shared memory
// (kStaged) or in global memory (kGlobal). The cluster rows come in the
// launch camera's visit order; the super rows, in global memory on both
// routes, too.
template <Tables kTab>
struct Spheres {
  const float4* rows;  // cx, cy, cz, r^2
  const float4* clusters;  // two float4s a cluster
  const int* orig;  // the slot's sphere index in the scene
  const int* mat;  // the slot's material index
  int n_hoist, n_clusters;
  // two float4s a super: (box min, first cluster row), (box max, cluster
  // count); n_supers == 0: no second level
  const float4* __restrict__ supers;
  int n_supers;
  __device__ __forceinline__ float4 row(int i) const {
    return table_load<kTab>(rows + i);
  }
  __device__ __forceinline__ float4 cluster(int i) const {
    return table_load<kTab>(clusters + i);
  }
  __device__ __forceinline__ int orig_of(int i) const {
    return table_load<kTab>(orig + i);
  }
  __device__ __forceinline__ int mat_of(int i) const {
    return table_load<kTab>(mat + i);
  }
};

// Spheres [first, end) against the ray: the nearest root t >= 0 wins, and
// on an exact tie the sphere of lower scene index. Two slots a loop step
// (4 and 1 were slower on RTIOW, see the header's card).
template <Tables kTab>
__device__ __forceinline__ void test_spheres(Spheres<kTab> sph, int first,
                                             int end,
                                             Vec3 o, Vec3 d, float& best_t,
                                             int& best) {
#pragma unroll 2
  for (int i = first; i < end; ++i) {
    const float4 s = sph.row(i);
    const Vec3 oc = {o.x - s.x, o.y - s.y, o.z - s.z};
    const float b = dot(oc, d);
    const float cc = dot(oc, oc) - s.w;
    const float disc = b * b - cc;
    if (disc >= 0.0f) {
      const float t = -b - sqrtf(disc);
      if (t >= 0.0f &&
          (t < best_t ||
           (t == best_t && sph.orig_of(i) < sph.orig_of(best)))) {
        best_t = t;
        best = i;
      }
    }
  }
}

// Profiling instantiations (tools/profile_mega.py; the TPU kernel's knobs,
// megakernel.py:461-466). kDupIntersect and kDupFetch (dup_intersect,
// dup_fetch) do one part of a segment's work twice and fold the second
// result so that it cannot change the image, so the frame-time delta
// against the production instantiation (kNone) is that part's cost;
// kNoCull (use_cull=False) runs the closest hit with every gate open
// (closest_hit_uncull), the same image, at the cost of a scan without
// culls. kStubIntersect (stub_intersect) skips the closest hit: every
// segment hits the JAX tables' slot 0 at t = 2; kStubFetch (stub_fetch)
// keeps it, and a hit's fields are constants. Both take the winner's
// fields from a stub row (stub_surface; with stub_fetch's constants both
// knobs at once) and change the rays' paths, so a frame-time difference
// against kNone is the part's cost on other paths: report its segments
// beside it. Only a probe library (-DRTX_PROBES) compiles them.
enum Probe : int {
  kNone = 0,
  kDupIntersect = 1,
  kDupFetch = 2,
  kStubIntersect = 3,
  kStubFetch = 4,
  kNoCull = 5
};

// Whether a probe shades from the stub row.
__host__ __device__ constexpr bool stubbed(Probe p) {
  return p == kStubIntersect || p == kStubFetch;
}

// The stub row (kernels/megakernel.py stub_row, STUB_ROW floats): 0-2 a
// sphere's centre, 3 its r^2; a triangle's a 4-6, b - a 7-9, c - a 10-12,
// geometric normal 13-15, vertex normals at a, b, c 16-24; 25 the TPU
// kernel's is_sph field (the sphere's forms above 0.5); 26 whether the
// scene has vertex normals; a material row (kMat floats) from kStubMat.
constexpr int kStubMat = 32;

// A cluster visit of at least this many lanes runs the per-lane loop
// (test_spheres, a sphere a step on the lanes whose gate passed), a
// smaller one the warp-cooperative scan (a ray a step, one sphere a lane;
// see the header). A ray step costs two to three sphere steps (seven
// shuffles, a vote and the loop's control beside the same pair test), so
// the cooperative scan pays only for visits of few lanes. RTIOW 1080p
// exact, K = 4, frame ms on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/scan_ab.py, two runs each, the parent 7.09-7.22): every visit
// cooperative 8.24-8.35; from 24 lanes 6.86-6.90, 16 6.72-6.77, 12
// 6.67-6.80, 8 6.70-6.78 (PERF.md). Two rays a step spilled 56 / 100
// bytes and was no faster.
constexpr int kWarpScanMax = 12;

// One sphere cluster, slots [first, first + count) (count <= kWarp), for
// the rays of the lanes set in `m`, the ballot of its gate; every lane of
// the warp calls it. Lane j holds slot first + j (lanes j >= count hold
// none and never propose a hit); then, a ray a step, the owner lane's ray
// and best t come by shuffle, every lane runs test_spheres' pair test on
// its sphere, and a lane proposes its t if it is a root t >= 0 no farther
// than the ray's best. The owner takes the candidates' lexicographic
// minimum of (t, scene index) by test_spheres' rule, so the ray's best is
// what test_spheres would leave, whatever the order of the slots.
template <Tables kTab>
__device__ __forceinline__ void scan_cluster_warp(Spheres<kTab> sph,
                                                  unsigned m, int first,
                                                  int count, Vec3 o, Vec3 d,
                                                  float& best_t, int& best) {
  const int lane = (threadIdx.y * kBlockX + threadIdx.x) & (kWarp - 1);
  if (__popc(m) >= kWarpScanMax) {
    if ((m >> lane) & 1u) {
      test_spheres(sph, first, first + count, o, d, best_t, best);
    }
    return;
  }
  const bool holds = lane < count;
  const float4 s =
      holds ? sph.row(first + lane) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  do {
    const int r = __ffs(m) - 1;
    m &= m - 1u;
    const Vec3 ro = {__shfl_sync(kFullMask, o.x, r),
                     __shfl_sync(kFullMask, o.y, r),
                     __shfl_sync(kFullMask, o.z, r)};
    const Vec3 rd = {__shfl_sync(kFullMask, d.x, r),
                     __shfl_sync(kFullMask, d.y, r),
                     __shfl_sync(kFullMask, d.z, r)};
    const float r_best = __shfl_sync(kFullMask, best_t, r);
    // test_spheres' pair test, operand for operand
    const Vec3 oc = {ro.x - s.x, ro.y - s.y, ro.z - s.z};
    const float b = dot(oc, rd);
    const float cc = dot(oc, oc) - s.w;
    const float disc = b * b - cc;
    float t = 0.0f;
    bool candidate = false;
    if (holds && disc >= 0.0f) {
      t = -b - sqrtf(disc);
      candidate = t >= 0.0f && t <= r_best;
    }
    if (__ballot_sync(kFullMask, candidate) == 0u) continue;
    // t >= 0, so its bits order as the floats do once -0 is +0; a lane
    // without a candidate keys above every float
    const unsigned key =
        candidate ? __float_as_uint(t) & 0x7fffffffu : 0xffffffffu;
    const unsigned nearest = __reduce_min_sync(kFullMask, key);
    unsigned at = __ballot_sync(kFullMask, key == nearest);
    if (at & (at - 1u)) {
      // an exact tie in t: the lower scene index
      const int orig =
          key == nearest ? sph.orig_of(first + lane) : 0x7fffffff;
      const int lowest = __reduce_min_sync(kFullMask, orig);
      at = __ballot_sync(kFullMask, key == nearest && orig == lowest);
    }
    const int w = __ffs(at) - 1;
    const float t_w = __shfl_sync(kFullMask, t, w);
    if (lane == r) {
      const int i = first + w;
      if (t_w < best_t ||
          (t_w == best_t && sph.orig_of(i) < sph.orig_of(best))) {
        best_t = t_w;
        best = i;
      }
    }
  } while (m != 0u);
}

// The sphere instantiations' closest hit, run by every lane of the warp
// (`live` lanes hold a ray; the others cast false in every vote and take
// part in the shuffles): the hoisted spheres on each lane, then each
// cluster in the rows' (visit) order behind the ballot of its gate, with a
// second level each run of clusters behind its super's gate (a lane whose
// super failed casts false for the run's clusters), scan_cluster_warp for
// a cluster that any lane entered. A lane's best is updated before the
// next gate, so each gate sees the best t of the per-lane scan.
template <Tables kTab>
__device__ __forceinline__ void closest_sphere_warp(Spheres<kTab> sph,
                                                    bool live, Vec3 o, Vec3 d,
                                                    Vec3 inv_d, float& best_t,
                                                    int& best) {
  test_spheres(sph, 0, sph.n_hoist, o, d, best_t, best);
  const int n_outer = sph.n_supers > 0 ? sph.n_supers : 1;
  for (int s = 0; s < n_outer; ++s) {
    int k = 0, k_end = sph.n_clusters;
    bool entered = live;
    if (sph.n_supers > 0) {
      const float4 lo = __ldg(sph.supers + 2 * s);
      const float4 hi = __ldg(sph.supers + 2 * s + 1);
      entered = live && box_gate(lo, hi, o, inv_d, best_t);
      if (!__any_sync(kFullMask, entered)) continue;
      k = __float_as_int(lo.w);
      k_end = k + __float_as_int(hi.w);
    }
    for (; k < k_end; ++k) {
      const float4 lo = sph.cluster(2 * k);
      const float4 hi = sph.cluster(2 * k + 1);
      const unsigned m = __ballot_sync(
          kFullMask, entered && box_gate(lo, hi, o, inv_d, best_t));
      if (m != 0u) {
        scan_cluster_warp(sph, m, __float_as_int(lo.w), __float_as_int(hi.w),
                          o, d, best_t, best);
      }
    }
  }
}

// The closest hit of a ray. kSpheres: closest_sphere_warp, on every lane
// of the warp. The triangle geometries, on a live lane: the hoisted
// spheres, then each cluster behind its gate in the rows' (visit) order,
// one level, each lane on its own; then the triangles: kChunks
// closest_triangle_warp on every lane of the warp, kBvh the traversal on a
// live lane. The sphere clusters keep that flat loop: with the second
// level in them as well (inline, or a __noinline__ helper), Chess, which
// has no sphere, took 3-6% longer a frame and their ptxas -v moved (PERF.md
// section 6). best_t starts at +inf, best and best_tri at -1.
template <Geometry kGeom, Tables kTab>
__device__ __forceinline__ void closest_hit(Spheres<kTab> sph,
                                            Triangles<kTab> tri, bool live,
                                            Vec3 o, Vec3 d, Vec3 inv_d,
                                            float& best_t, int& best,
                                            int& best_tri) {
  if constexpr (kGeom == kSpheres) {
    closest_sphere_warp(sph, live, o, d, inv_d, best_t, best);
  } else if constexpr (kGeom == kChunks) {
    if (live) {
      test_spheres(sph, 0, sph.n_hoist, o, d, best_t, best);
      for (int k = 0; k < sph.n_clusters; ++k) {
        const float4 lo = sph.cluster(2 * k);
        const float4 hi = sph.cluster(2 * k + 1);
        if (!box_gate(lo, hi, o, inv_d, best_t)) continue;
        const int first = __float_as_int(lo.w);
        test_spheres(sph, first, first + __float_as_int(hi.w), o, d, best_t,
                     best);
      }
    }
    closest_triangle_warp(tri, live, o, d, inv_d, best_t, best_tri);
  } else {
    test_spheres(sph, 0, sph.n_hoist, o, d, best_t, best);
    for (int k = 0; k < sph.n_clusters; ++k) {
      const float4 lo = sph.cluster(2 * k);
      const float4 hi = sph.cluster(2 * k + 1);
      if (!box_gate(lo, hi, o, inv_d, best_t)) continue;
      const int first = __float_as_int(lo.w);
      test_spheres(sph, first, first + __float_as_int(hi.w), o, d, best_t,
                   best);
    }
    if constexpr (kGeom == kBvh) {
      // closest_hit_bvh's merge: strictly nearer, so a sphere keeps a tie
      const TriangleHit h = closest_triangle_bvh(tri, o, d);
      if (h.t < best_t) {
        best_t = h.t;
        best_tri = h.i;
      }
    }
  }
}

// kNoCull's closest hit, the TPU kernel's use_cull=False (its hit masks
// and gates, megakernel.py:845-1205, all open): closest_hit's scans with
// no box tested, each live lane on its own. The hoisted spheres and every
// cluster's spheres (its row read for its slots only); then kChunks every
// chunk's triangles in index order, a strictly nearer one winning, kBvh
// every triangle row in index order with the traversal's test from +inf,
// its winner taken if strictly nearer (closest_hit_bvh's merge). Each scan
// keeps the lexicographic minimum of (t, index) that its culled form
// keeps, so the image is the culled one's (through the BVH, but for two
// triangles of one t, which the traversal takes in its own order).
template <Geometry kGeom, Tables kTab>
__device__ __forceinline__ void closest_hit_uncull(Spheres<kTab> sph,
                                                   Triangles<kTab> tri,
                                                   Vec3 o, Vec3 d,
                                                   float& best_t, int& best,
                                                   int& best_tri) {
  test_spheres(sph, 0, sph.n_hoist, o, d, best_t, best);
  for (int k = 0; k < sph.n_clusters; ++k) {
    const int first = __float_as_int(sph.cluster(2 * k).w);
    test_spheres(sph, first, first + __float_as_int(sph.cluster(2 * k + 1).w),
                 o, d, best_t, best);
  }
  if constexpr (kGeom == kChunks) {
    for (int c = 0; c < tri.n_chunks; ++c) {
      const int first = __float_as_int(table_load<kTab>(tri.chunks + 2 * c).w);
      const int end =
          first + __float_as_int(table_load<kTab>(tri.chunks + 2 * c + 1).w);
      for (int i = first; i < end; ++i) {
        float t;
        if (chunk_triangle_hit(__ldg(tri.rows + kTri4 * i),
                               __ldg(tri.rows + kTri4 * i + 1),
                               __ldg(tri.rows + kTri4 * i + 2), o, d, t) &&
            t < best_t) {
          best_t = t;
          best_tri = i;
        }
      }
    }
  } else if constexpr (kGeom == kBvh) {
#ifdef RTX_PROBES
    float t_best = __int_as_float(0x7f800000);
    int i_best = 0;
    for (int i = 0; i < tri.n_tris; ++i) {
      const float t = triangle_t(tri, i, o, d);
      if (t < t_best) {
        t_best = t;
        i_best = i;
      }
    }
    if (t_best < best_t) {
      best_t = t_best;
      best_tri = i_best;
    }
#endif
  }
}

// The hit point and shading normal of a stubbed segment from the stub row
// `s` (kernels/megakernel.py stub_surface): what the TPU kernel's segment
// body derives from a winner's fetched fields (megakernel.py:1487-1530).
// The distance is recomputed from the fields, a sphere's root in the o - c
// form (its discriminant clamped at 0) or, where is_sph is at most 0.5, a
// triangle's dot(o - a, n) * (1 / det); the normal is the sphere's at that
// point, or the triangle's vertex normals interpolated there (with vertex
// normals; else the one at a), normalised.
__device__ __forceinline__ void stub_surface(const float* __restrict__ s,
                                             Vec3 o, Vec3 d, Vec3& point,
                                             Vec3& normal) {
  const Vec3 sc = {__ldg(s + 0), __ldg(s + 1), __ldg(s + 2)};
  const Vec3 oc = sub(o, sc);
  const float b = dot(oc, d);
  const float cc = dot(oc, oc) - __ldg(s + 3);
  float t = -b - sqrtf(fmaxf(b * b - cc, 0.0f));
  const bool is_sph = __ldg(s + 25) > 0.5f;
  Vec3 ao = {0.0f, 0.0f, 0.0f};
  float inv_det = 0.0f;
  if (!is_sph) {
    const Vec3 gn = {__ldg(s + 13), __ldg(s + 14), __ldg(s + 15)};
    ao = sub(o, Vec3{__ldg(s + 4), __ldg(s + 5), __ldg(s + 6)});
    const float det = -dot(d, gn);
    inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
    t = dot(ao, gn) * inv_det;
  }
  point = add(o, scale(d, t));
  if (is_sph) {
    normal = normalize(sub(point, sc));
    return;
  }
  const Vec3 na = {__ldg(s + 16), __ldg(s + 17), __ldg(s + 18)};
  if (__ldg(s + 26) == 0.0f) {
    normal = normalize(na);
    return;
  }
  const Vec3 dao = cross(ao, d);
  const float u =
      dot(Vec3{__ldg(s + 10), __ldg(s + 11), __ldg(s + 12)}, dao) * inv_det;
  const float v =
      -dot(Vec3{__ldg(s + 7), __ldg(s + 8), __ldg(s + 9)}, dao) * inv_det;
  const float w = 1.0f - u - v;
  normal = normalize(Vec3{
      na.x * w + __ldg(s + 19) * u + __ldg(s + 22) * v,
      na.y * w + __ldg(s + 20) * u + __ldg(s + 23) * v,
      na.z * w + __ldg(s + 21) * u + __ldg(s + 24) * v,
  });
}

// `idx` again, as an index the compiler cannot prove equal to it (the TPU
// kernel's where(code < -1, code + 1, code), megakernel.py:1467). Where the
// fetch reads it, idx >= 0 is known and the select alone would fold, so
// idx first passes through an empty asm statement the optimizer cannot see
// through.
__device__ __forceinline__ int unproven(int idx) {
  asm volatile("" : "+r"(idx));
  return idx < -1 ? idx + 1 : idx;
}

// kDupFetch's second fetch: everything the winner's fetch reads (the
// sphere's row and material index, or the triangle's rows, vertex normals
// and material index; then the 14 floats of the material row), through
// unproven indices, summed into one value. Every load feeds the sum: one
// left out would be dead code and its cost not measured.
template <Geometry kGeom, Tables kTab>
__device__ __forceinline__ float fetch_again(Spheres<kTab> sph,
                                             Triangles<kTab> tri,
                                             const float* __restrict__ mats,
                                             int best, int best_tri) {
  float sum;
  int mat_idx;
  if (kGeom != kSpheres && best_tri >= 0) {
    const int i = unproven(best_tri);
    const float4 r0 = __ldg(tri.rows + kTri4 * i);
    const float4 r1 = __ldg(tri.rows + kTri4 * i + 1);
    const float4 r2 = __ldg(tri.rows + kTri4 * i + 2);
    sum = r0.x + r0.y + r0.z + r0.w + r1.x + r1.y + r1.z + r1.w + r2.x +
          r2.y + r2.z + r2.w;
    const float* n = tri.normals + kTriNrm * i;
#pragma unroll
    for (int j = 0; j < kTriNrm; ++j) sum += __ldg(n + j);
    mat_idx = __ldg(tri.mat + i);
  } else {
    const int i = unproven(best);
    const float4 s = sph.row(i);
    sum = s.x + s.y + s.z + s.w;
    mat_idx = sph.mat_of(i);
  }
  const float* m = mats + kMat * mat_idx;
#pragma unroll
  for (int j = 0; j < 14; ++j) sum += __ldg(m + j);
  return sum;
}

// A segment's closest hit (ops/trace.py trace_segment's first half), from
// best_t = +inf and best = best_tri = -1; `live` as closest_hit takes it.
template <Geometry kGeom, Probe kProbe, Tables kTab>
__device__ __forceinline__ void segment_hit(Spheres<kTab> sph,
                                            Triangles<kTab> tri, bool live,
                                            Vec3 o, Vec3 d, float& best_t,
                                            int& best, int& best_tri) {
  if constexpr (kProbe == kStubIntersect) {
    // the TPU kernel's stub_intersect (megakernel.py:2030-2031): no closest
    // hit, every segment hits slot 0 at t = 2 (shade_segment reads its
    // fields from the stub row)
    best_t = 2.0f;
    best = 0;
    return;
  }
  if constexpr (kProbe == kNoCull) {
    if (live) closest_hit_uncull<kGeom>(sph, tri, o, d, best_t, best, best_tri);
    return;
  }
  const Vec3 inv_d = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  closest_hit<kGeom>(sph, tri, live, o, d, inv_d, best_t, best, best_tri);
  if constexpr (kProbe == kDupIntersect) {
    // the TPU kernel's dup_intersect (megakernel.py:2030-2043): the whole
    // closest hit again from an origin the compiler cannot prove equal,
    // folded so that it cannot change t (t2 + 1e30 is beyond any hit); the
    // first pass's winner stays
    float best_t2 = __int_as_float(0x7f800000);
    int best2 = -1, best_tri2 = -1;
    closest_hit<kGeom>(sph, tri, live, Vec3{o.x + 1e-30f, o.y, o.z}, d,
                       inv_d, best_t2, best2, best_tri2);
    best_t = fminf(best_t, best_t2 + 1e30f);
  }
}

// The rest of a segment after its closest hit (ops/trace.py
// trace_segment): the flags, the scatter, emission and roulette; or the
// environment light on a miss. Updates the ray, throughput and incoming
// light and returns whether the path goes on. `camera_ray` is bounce
// index 0. Under a stub probe `mats` is the stub row, whose surface and
// material the hit takes (stub_surface).
template <Geometry kGeom, Scatter kScatter, Probe kProbe, Tables kTab>
__device__ __forceinline__ bool shade_segment(
    const float* p, Spheres<kTab> sph, Triangles<kTab> tri,
    const float* __restrict__ mats, bool camera_ray, uint32_t& state, Vec3& o,
    Vec3& d, Vec3& colour, Vec3& incoming, float best_t, int best,
    int best_tri) {
  if (best < 0 && best_tri < 0) {
    incoming = add(incoming, mul(environment(p, d), colour));
    return false;
  }

  Vec3 point, normal;
  const float* m;
  if constexpr (stubbed(kProbe)) {
    stub_surface(mats, o, d, point, normal);
    m = mats + kStubMat;
  } else {
    point = add(o, scale(d, best_t));
    int mat_idx;
    if (kGeom != kSpheres && best_tri >= 0) {
      normal = triangle_normal(tri, best_tri, o, d);
      mat_idx = __ldg(tri.mat + best_tri);
    } else {
      const float4 s = sph.row(best);
      normal = normalize(sub(point, Vec3{s.x, s.y, s.z}));
      mat_idx = sph.mat_of(best);
    }
    m = mats + kMat * mat_idx;
  }
  const int flag = static_cast<int>(__ldg(m + 13));

  if (flag == kFlagInvisibleLight && camera_ray) {
    o = add(point, scale(d, 0.001f));  // camera rays pass through
    return true;
  }

  Vec3 base = {__ldg(m + 0), __ldg(m + 1), __ldg(m + 2)};
  if (flag == kFlagChecker) {
    const float fx = floorf(point.x);
    const float fz = floorf(point.z);
    const float cx = fx - 2.0f * floorf(fx / 2.0f);
    const float cz = fz - 2.0f * floorf(fz / 2.0f);
    if (cx != cz) base = {__ldg(m + 3), __ldg(m + 4), __ldg(m + 5)};
  }
  if constexpr (kProbe == kDupFetch) {
    // the TPU kernel's dup_fetch (megakernel.py:1463-1469), folded so that
    // it cannot change the colour (|sum| + 1e30 is above any colour; fminf
    // drops a NaN operand)
    base.x = fminf(base.x, fabsf(fetch_again<kGeom>(sph, tri, mats, best,
                                                    best_tri)) + 1e30f);
  }

  // scatter (RayTracing.shader:325-330): 1 lottery draw + 6 direction
  // draws (2 with the fast sampler)
  const float u_spec = random_value(state);
  float is_spec = (__ldg(m + 11) >= u_spec) ? 1.0f : 0.0f;
  Vec3 unit;
  if constexpr (kScatter == kFastScatter) {
    unit = random_direction_fast(state);
  } else {
    unit = random_direction(state);
  }
  const Vec3 diffuse = normalize(add(normal, unit));
  const Vec3 specular = reflect(d, normal);
  const Vec3 surface = normalize(lerp(diffuse, specular, __ldg(m + 10) * is_spec));
  Vec3 new_d, new_o;
  if (flag == kFlagDielectric) {
    new_d = refract_dir(d, normal, __ldg(m + 12), u_spec);
    new_o = add(point, scale(new_d, 1e-4f));
    is_spec = 0.0f;  // dielectrics are tinted by colour only
  } else {
    new_d = surface;
    new_o = add(point, Vec3{0.0f, 0.0f, 0.0f});
  }

  // emission and throughput (RayTracing.shader:333-335)
  const Vec3 em = scale(Vec3{__ldg(m + 3), __ldg(m + 4), __ldg(m + 5)}, __ldg(m + 9));
  incoming = add(incoming, mul(em, colour));
  const Vec3 spec_c = {__ldg(m + 6), __ldg(m + 7), __ldg(m + 8)};
  const Vec3 col_hit = mul(colour, lerp(base, spec_c, is_spec));

  // Russian roulette (RayTracing.shader:337-342)
  const float prob = fmaxf(fmaxf(col_hit.x, col_hit.y), col_hit.z);
  const float u_rr = random_value(state);
  if (!(u_rr < prob)) return false;
  colour = scale(col_hit, 1.0f / fmaxf(prob, 1e-30f));
  o = new_o;
  d = new_d;
  return true;
}

// One segment of a path (ops/trace.py trace_segment) on a live lane, for
// the BVH geometry: its closest hit, then the rest. (The sphere and chunk
// instantiations call the two halves apart, the hit on every lane.) With
// the hit's locals declared here, inside the slot loop's `if (live)`, their
// SASS is the one before the sphere scan went across the warp; declared
// before that branch, as the sphere instantiations need them, it was not.
template <Geometry kGeom, Scatter kScatter, Probe kProbe, Tables kTab>
__device__ __forceinline__ bool trace_segment(
    const float* p, Spheres<kTab> sph, Triangles<kTab> tri,
    const float* __restrict__ mats, bool camera_ray, uint32_t& state, Vec3& o,
    Vec3& d, Vec3& colour, Vec3& incoming) {
  float best_t = __int_as_float(0x7f800000);
  int best = -1;
  int best_tri = -1;
  segment_hit<kGeom, kProbe>(sph, tri, true, o, d, best_t, best, best_tri);
  return shade_segment<kGeom, kScatter, kProbe, kTab>(
      p, sph, tri, mats, camera_ray, state, o, d, colour, incoming, best_t,
      best, best_tri);
}

// Adds the block's histogram to the launch's; every thread takes part.
__device__ __forceinline__ void flush_hist(const int* s_hist, int* hist,
                                           int max_bounce) {
  if (hist != nullptr) {
    __syncthreads();
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int n_threads = blockDim.x * blockDim.y;
    for (int i = tid; i <= max_bounce; i += n_threads) {
      if (s_hist[i] != 0) atomicAdd(&hist[i], s_hist[i]);
    }
  }
}

// One launch's arguments: the scene's tables in global memory, the image
// and what to render. The pointers a geometry does not read are null.
struct Args {
  const float4* __restrict__ sph;  // n_sph rows
  const int* __restrict__ sph_orig;
  const int* __restrict__ sph_mat;
  int n_sph;
  const float4* __restrict__ clusters;  // two float4s a cluster
  int n_clusters, n_hoist;
  const float4* __restrict__ sph_supers;  // two float4s a run of clusters
  int n_sph_supers;
  const float4* __restrict__ tri_rows;
  const float* __restrict__ tri_normals;
  const int* __restrict__ tri_mat;
  const float4* __restrict__ chunks;  // two float4s a chunk
  int n_chunks;
  const float4* __restrict__ supers;  // two float4s a run of chunks
  int n_supers, super_size;
  const float4* __restrict__ bvh_nodes;
  const int4* __restrict__ bvh_leaves;
  int n_nodes;
  const float* __restrict__ mats;
  const float* __restrict__ params;
  // the frame's size; the band's rows y0 .. y1 - 1 (0 and height for the
  // whole frame), which the grid covers and the image arrays hold
  int width, height, y0, y1, spp, max_bounce;
  uint32_t frame0;
  int n_frames;
  const float* __restrict__ accum_in;
  int clamp_accum;
  float* __restrict__ out;
  int* __restrict__ segs;
  int* __restrict__ hist;
  // refill (render_adaptive) in two launches: its phase, 1 or 2; a pixel's
  // RNG state and last frame's banked light between them; the last finish
  // of each tile_size x tile_size tile of the band, tiles row-major from
  // row y0 (see render_slots); a lane's pixels and phases (the TPU kernel's
  // ppl and phases), and with either above 1 a pixel's slot: phase 1 writes
  // it at its quota's end, phase 2 resumes from it (the lane pass's, with
  // more than one pixel a lane; -1 for no extra samples)
  int refill_phase;
  float4* __restrict__ scratch;
  int* __restrict__ tile_max;
  int tile_size;
  int* __restrict__ slot_map;
  int refill_ppl, refill_phases;
  int chunk_warp_scan;  // Triangles::warp_scan
  // with more than one pixel a lane (kKnobRefill): phase 1 also writes each
  // pixel's image as it is without extra samples (`image`), and phase 2
  // (kKnobList) runs one thread a lane's last pixel, the lane pass's list
  // (`lane_list`: frame indices, -1 past a tile's last), overwriting those
  // pixels' images
  float* __restrict__ image;
  const int* __restrict__ lane_list;
#ifdef RTX_PROBES
  // the stub row (kStubIntersect, kStubFetch), null for the other probes;
  // the triangle rows (Triangles::n_tris)
  const float* __restrict__ stub;
  int n_tris;
#endif
};

// Dynamic shared memory, in bytes. kStaged: the float4 tables first (super
// boxes, chunks, sphere clusters, spheres), then the parameters, the
// spheres' scene and material indices and the block's bounce histogram.
// kGlobal: the parameters and the histogram only.
size_t shared_bytes(Tables tables, int n_sph, int n_clusters, int n_chunks,
                    int n_supers, int max_bounce) {
  if (tables == kGlobal) {
    return 4 * (kParams + static_cast<size_t>(max_bounce) + 1);
  }
  const size_t float4s = 2 * (static_cast<size_t>(n_supers) + n_chunks +
                              n_clusters) + n_sph;
  return 16 * float4s +
         4 * (kParams + 2 * static_cast<size_t>(n_sph) + max_bounce + 1);
}

// The block's view of the scene after staging it.
template <Tables kTab>
struct Staged {
  const float* p;  // parameters
  Spheres<kTab> sph;
  int* s_hist;  // the block's bounce histogram
  Triangles<kTab> tri;
};

// Every thread of the block takes part: stages the tables (kStaged) or only
// the parameters (kGlobal, whose tables stay where Args points), zeroes the
// histogram and waits for the block. rtx_render passes n_chunks and
// n_supers as 0 unless the geometry is kChunks.
template <Tables kTab>
__device__ __forceinline__ Staged<kTab> stage_scene(float4* smem4,
                                                    const Args& a) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  if constexpr (kTab == kGlobal) {
    float* p = reinterpret_cast<float*>(smem4);
    int* s_hist = reinterpret_cast<int*>(p + kParams);
    for (int i = tid; i < kParams; i += n_threads) p[i] = a.params[i];
    for (int i = tid; i <= a.max_bounce; i += n_threads) s_hist[i] = 0;
    __syncthreads();
    return {p,
            {a.sph, a.clusters, a.sph_orig, a.sph_mat, a.n_hoist,
             a.n_clusters, a.sph_supers, a.n_sph_supers},
            s_hist,
            {a.tri_rows, a.tri_normals, a.tri_mat, a.chunks, a.n_chunks,
             a.supers, a.n_supers, a.super_size, a.bvh_nodes, a.bvh_leaves,
             a.n_nodes, a.chunk_warp_scan
#ifdef RTX_PROBES
             , a.n_tris
#endif
            }};
  }
  float4* supers = smem4;
  float4* chunks = supers + 2 * a.n_supers;
  float4* clusters = chunks + 2 * a.n_chunks;
  float4* rows = clusters + 2 * a.n_clusters;
  float* p = reinterpret_cast<float*>(rows + a.n_sph);
  int* orig = reinterpret_cast<int*>(p + kParams);
  int* mat = orig + a.n_sph;
  int* s_hist = mat + a.n_sph;

  for (int i = tid; i < 2 * a.n_supers; i += n_threads) supers[i] = a.supers[i];
  for (int i = tid; i < 2 * a.n_chunks; i += n_threads) chunks[i] = a.chunks[i];
  for (int i = tid; i < 2 * a.n_clusters; i += n_threads) {
    clusters[i] = a.clusters[i];
  }
  for (int i = tid; i < a.n_sph; i += n_threads) {
    rows[i] = a.sph[i];
    orig[i] = a.sph_orig[i];
    mat[i] = a.sph_mat[i];
  }
  for (int i = tid; i < kParams; i += n_threads) p[i] = a.params[i];
  for (int i = tid; i <= a.max_bounce; i += n_threads) s_hist[i] = 0;
  __syncthreads();
  return {p,
          {rows, clusters, orig, mat, a.n_hoist, a.n_clusters, a.sph_supers,
           a.n_sph_supers},
          s_hist,
          {a.tri_rows, a.tri_normals, a.tri_mat, chunks, a.n_chunks, supers,
           a.n_supers, a.super_size, a.bvh_nodes, a.bvh_leaves, a.n_nodes,
           a.chunk_warp_scan
#ifdef RTX_PROBES
           , a.n_tris
#endif
          }};
}

// The pixel's point on the focus plane: position + rotation @ (lx, ly,
// focus) (ops/camera.py focus_points).
__device__ __forceinline__ Vec3 focus_point(const float* p, int x, int y,
                                            int width, int height) {
  const float u = (static_cast<float>(x) + 0.5f) / static_cast<float>(width);
  const float v = (static_cast<float>(y) + 0.5f) / static_cast<float>(height);
  const float lx = (u - 0.5f) * p[12];
  const float ly = (v - 0.5f) * p[13];
  const float focus = p[14];
  return {
      p[0] + (lx * p[3] + ly * p[4] + focus * p[5]),
      p[1] + (lx * p[6] + ly * p[7] + focus * p[8]),
      p[2] + (lx * p[9] + ly * p[10] + focus * p[11]),
  };
}

// A camera sample's ray (RayTracing.shader:377-382), 4 draws: the defocus
// disc on the origin, the diverge disc on the target.
__device__ __forceinline__ void camera_ray(const float* p, Vec3 pos,
                                           Vec3 right, Vec3 up, Vec3 fp,
                                           uint32_t& state, Vec3& origin,
                                           Vec3& dir) {
  float cx, cy, jx, jy;
  random_point_in_circle(state, p[15], cx, cy);
  origin = add(add(pos, scale(right, cx)), scale(up, cy));
  random_point_in_circle(state, p[16], jx, jy);
  const Vec3 target = add(add(fp, scale(right, jx)), scale(up, jy));
  dir = normalize(sub(target, origin));
}

// Folds frame `frame`'s mean into the running average (ops/accumulate.py:
// prev (1 - w) + cur w, w = 1 / (frame + 1)); without an accumulator the
// mean is the result.
__device__ __forceinline__ Vec3 fold(Vec3 acc, Vec3 mean, uint32_t frame,
                                     bool with_accum, int clamp_accum) {
  if (!with_accum) return mean;
  const float w = 1.0f / (__uint2float_rn(frame) + 1.0f);
  const float keep = 1.0f - w;
  acc = {acc.x * keep + mean.x * w, acc.y * keep + mean.y * w,
         acc.z * keep + mean.z * w};
  if (clamp_accum) {
    acc = {fminf(fmaxf(acc.x, 0.0f), 1.0f), fminf(fmaxf(acc.y, 0.0f), 1.0f),
           fminf(fmaxf(acc.z, 0.0f), 1.0f)};
  }
  return acc;
}

__device__ __forceinline__ Vec3 div(Vec3 v, float n) {
  return {v.x / n, v.y / n, v.z / n};
}

// Which dead lanes a slot loop re-seeds (see the header): kExact, a lane
// that owes samples itself; kLockstep, such a lane once no lane of its warp
// is live, so a warp's lanes start their samples together (the nested
// loop's schedule); kRefill, also a lane whose slot is before its tile's
// last finish; kKnobRefill, kRefill under the TPU kernel's lane knobs, a
// lane's pixels and phases (Args.refill_ppl, refill_phases), whose slot is
// then no segment count (a template value of its own: read at run time
// under kRefill they cost render_adaptive<kSpheres> 8 bytes of spill
// stores and 20 of loads, ptxas -v of nvcc 12.9); kKnobList, kKnobRefill's
// phase 2 over the lane pass's list (Args.lane_list), a 1-D grid.
enum Schedule : int {
  kExact = 0,
  kLockstep = 1,
  kRefill = 2,
  kKnobRefill = 3,
  kKnobList = 4
};

// Whether a schedule is refill under the lane knobs.
__host__ __device__ constexpr bool under_knobs(Schedule s) {
  return s == kKnobRefill || s == kKnobList;
}

// The refill tile of the band's column x and row yb (row 0 the band's
// first): tiles of ts x ts pixels, row-major.
__device__ __forceinline__ int refill_tile(int x, int yb, int width, int ts) {
  return (yb / ts) * ((width + ts - 1) / ts) + x / ts;
}

// The table a segment's shading reads: the materials, or a stub probe's
// stub row (shade_segment).
#ifdef RTX_PROBES
#define RTX_SHADING_TABLE(a) (stubbed(kProbe) ? (a).stub : (a).mats)
#else
#define RTX_SHADING_TABLE(a) (a).mats
#endif

// The slot loop of both kernels: each slot, the dead lanes the schedule
// re-seeds start their next camera sample, and every live lane traces one
// segment. Per-lane state lives in registers: the RNG state, the ray,
// throughput, incoming and banked light, the running average, the
// completed-sample count, frame and bounce index.
//
// A lane's draws, sums and folds are the nested loop's (for frame, for
// sample, for bounce) in the same order, whatever its warp-mates do: its
// stream restarts at pix + frame * 719393 at each frame's first sample;
// sample k's 4 camera draws follow sample k - 1's last scatter or
// roulette draw; `total` adds each sample's light in sample order, and a
// frame is folded before the next frame's seed. So kExact and kLockstep
// render what that loop rendered, bit for bit, and count the same segments
// and bounces.
//
// The loop's bound is quota * (max_bounce + 1) slots. An exact warp never
// reaches it: under kExact a lane traces one of its own segments a slot,
// and it has at most that many; under kLockstep each of the warp's
// samples takes at most max_bounce + 1 slots. A refill lane may reach it
// (its extra samples); a sample in flight there is dropped. The exit is
// one vote a slot, so it is warp-uniform and every lane of the warp, those
// outside the image too, stays in the loop until its warp leaves.
template <Schedule kSched, Geometry kGeom, Scatter kScatter, Probe kProbe,
          Tables kTab>
__device__ __forceinline__ void render_slots(float4* smem4, const Args& a) {
  const Staged<kTab> sc = stage_scene<kTab>(smem4, a);
  int* s_hist = a.hist != nullptr ? sc.s_hist : nullptr;
  const int width = a.width, height = a.height, spp = a.spp;
  const int max_bounce = a.max_bounce, n_frames = a.n_frames;
  const uint32_t frame0 = a.frame0;
  const int clamp_accum = a.clamp_accum;

  // y is the frame's row: the seed, the camera and the tests are the
  // whole-frame launch's; the image arrays hold the band's rows, at
  // pix - y0 * width, worked out where they are read and written (kept in
  // a variable of its own, it cost render_adaptive<kChunks> 8 registers,
  // ptxas -v of nvcc 12.9). Lanes outside the image (or the band) stay in
  // the loop, owing nothing.
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = a.y0 + static_cast<int>(blockIdx.y * blockDim.y + threadIdx.y);
  bool in_image = x < width && y < a.y1;
  if constexpr (kSched == kKnobList) {
    // phase 2 over the lane pass's list, a 1-D grid: the thread's entry,
    // -1 a lane outside the image
    const int at = a.lane_list[blockIdx.x * (kBlockX * kBlockY) +
                               threadIdx.y * kBlockX + threadIdx.x];
    in_image = at >= 0;
    x = in_image ? at % width : 0;
    y = in_image ? at / width : a.y0;
  }
  const int pix = in_image ? y * width + x : 0;
  const Vec3 pos = {sc.p[0], sc.p[1], sc.p[2]};
  const Vec3 right = {sc.p[3], sc.p[6], sc.p[9]};
  const Vec3 up = {sc.p[4], sc.p[7], sc.p[10]};
  const Vec3 fp = focus_point(sc.p, x, y, width, height);
  const bool with_accum = a.accum_in != nullptr;
  Vec3 acc = {0.0f, 0.0f, 0.0f};
  if (in_image && with_accum) {
    acc = {a.accum_in[3 * (pix - a.y0 * width)],
           a.accum_in[3 * (pix - a.y0 * width) + 1],
           a.accum_in[3 * (pix - a.y0 * width) + 2]};
  }

  const int quota = n_frames * spp;
  // with refill a lane may trace ppl pixels, and with two phases it waits for
  // its phase's slots (the TPU kernel's bound, megakernel.py:2119-2121)
  const int n_slots =
      quota * (max_bounce + 1) *
      (under_knobs(kSched) ? a.refill_ppl * a.refill_phases : 1);
  uint32_t state = 0;
  Vec3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
  Vec3 colour = {0.0f, 0.0f, 0.0f}, incoming = {0.0f, 0.0f, 0.0f};
  Vec3 total = {0.0f, 0.0f, 0.0f};
  bool live = false;
  int ns = 0, fk = 0, bounce = 0, segs = 0;
  // kRefill: the slot before which a dead lane starts extra samples, its
  // tile's last finish in phase 2 (0 in phase 1); under the knobs also the
  // lane's own slot (under kRefill its segment count)
  [[maybe_unused]] int extra_until = 0;
  [[maybe_unused]] int lane_slot = 0;
  if constexpr (kSched == kRefill || under_knobs(kSched)) {
    if ((kSched == kKnobList || a.refill_phase == 2) && in_image) {
      // the lane as phase 1 left it: its quota done, idle since
      const int at = pix - a.y0 * width;
      const float4 kept = a.scratch[at];
      total = {kept.x, kept.y, kept.z};
      state = __float_as_uint(kept.w);
      segs = a.segs[at];
      ns = quota;
      fk = n_frames - 1;
      extra_until = a.tile_max[refill_tile(x, y - a.y0, width, a.tile_size)];
      if constexpr (under_knobs(kSched)) {
        // the slot its lane is done at; -1, a pixel before its lane's
        // last: no extra samples
        const int resume = a.slot_map[at];
        lane_slot = resume < 0 ? n_slots : resume;
      }
    }
  }
  for (int slot = 0; slot < n_slots; ++slot) {
    // the votes: every lane of the warp casts each, every slot (none may
    // sit behind a short-circuit)
    const bool undone = in_image && ns < quota;
    bool need;
    if constexpr (kSched == kRefill) {
      // a lane's own slot is its segment count (see the header): a sample
      // still in flight at the bound is dropped
      if (segs >= n_slots) live = false;
      need = !live && (undone || segs < extra_until);
    } else if constexpr (under_knobs(kSched)) {
      if (a.refill_phases == 2) {
        // a live lane traces on odd slots, a dead one starts a sample on
        // even ones: a lane that would wait for its slot takes it now (the
        // wait changes nothing but its slot)
        const bool odd = (lane_slot & 1) != 0;
        if (live ? !odd : odd && (undone || lane_slot + 1 < extra_until)) {
          ++lane_slot;
        }
      }
      // a sample still in flight at the bound is dropped
      if (lane_slot >= n_slots) live = false;
      need = !live && (undone || lane_slot < extra_until) &&
             (a.refill_phases == 1 || (lane_slot & 1) == 0);
    } else if constexpr (kSched == kLockstep) {
      const bool warp_live = __any_sync(kFullMask, live);
      need = undone && !warp_live;
    } else {
      need = !live && undone;
    }
    if (!__any_sync(kFullMask, live || need)) break;

    if (need) {
      if (ns - fk * spp >= spp && fk < n_frames - 1) {
        // the frame is done: fold it and move to the next
        acc = fold(acc, div(total, static_cast<float>(spp)),
                   frame0 + static_cast<uint32_t>(fk), with_accum,
                   clamp_accum);
        total = {0.0f, 0.0f, 0.0f};
        ++fk;
      }
      if (ns - fk * spp == 0) {
        state = static_cast<uint32_t>(pix) +
                (frame0 + static_cast<uint32_t>(fk)) * kFrameSeedStride;
      }
      camera_ray(sc.p, pos, right, up, fp, state, o, d);
      colour = {1.0f, 1.0f, 1.0f};
      bounce = 0;
      live = true;
    }
    float best_t = __int_as_float(0x7f800000);
    int best = -1, best_tri = -1;
    if constexpr (kGeom != kBvh) {
      // the sphere and chunk scans' votes and shuffles take every lane of
      // the warp, so the closest hit comes before `if (live)`
      segment_hit<kGeom, kProbe>(sc.sph, sc.tri, live, o, d, best_t, best,
                                 best_tri);
    }
    if (live) {
      ++segs;
      if constexpr (under_knobs(kSched)) ++lane_slot;
      if (s_hist != nullptr) atomicAdd(&s_hist[bounce], 1);
      bool goes_on;
      if constexpr (kGeom != kBvh) {
        goes_on = shade_segment<kGeom, kScatter, kProbe, kTab>(
            sc.p, sc.sph, sc.tri, RTX_SHADING_TABLE(a), bounce == 0, state, o,
            d, colour, incoming, best_t, best, best_tri);
      } else {
        goes_on = trace_segment<kGeom, kScatter, kProbe, kTab>(
            sc.p, sc.sph, sc.tri, RTX_SHADING_TABLE(a), bounce == 0, state, o,
            d, colour, incoming);
      }
      if (!goes_on || bounce >= max_bounce) {
        // the sample is complete: bank its light
        total = add(total, incoming);
        incoming = {0.0f, 0.0f, 0.0f};
        ++ns;
        live = false;
      }
      ++bounce;
    }
  }

  if constexpr (kSched == kRefill || kSched == kKnobRefill) {
    if (a.refill_phase == 1) {
      // keep the lane for phase 2, the running average of the frames
      // before the last in `out` (with an accumulator), its slot in the
      // slot map where there is one; and with one pixel a lane its tile's
      // last finish, one atomicMax a warp (a warp's 16 x 2 pixels lie in
      // one tile: its side is a multiple of 16, and a band starts on a tile
      // row; lane 0 is in the image if any lane is). With more, the lane
      // pass (refill_lanes) takes it from the slot map.
      const int warp_max =
          __reduce_max_sync(kFullMask, kSched == kRefill ? segs : lane_slot);
      if (in_image) {
        const int at = pix - a.y0 * width;
        a.scratch[at] =
            make_float4(total.x, total.y, total.z, __uint_as_float(state));
        a.segs[at] = segs;
        if constexpr (kSched == kKnobRefill) {
          a.slot_map[at] = lane_slot;
          if (a.image != nullptr) {
            // each pixel's image without extra samples, the last fold
            // below of its spp samples: phase 2 visits only a lane's last
            // pixel, whose image it overwrites
            const Vec3 done =
                fold(acc, div(total, static_cast<float>(
                                         max(ns - (n_frames - 1) * spp, 1))),
                     frame0 + static_cast<uint32_t>(n_frames - 1), with_accum,
                     clamp_accum);
            a.image[3 * at] = done.x;
            a.image[3 * at + 1] = done.y;
            a.image[3 * at + 2] = done.z;
          }
        }
        if (with_accum) {
          a.out[3 * at] = acc.x;
          a.out[3 * at + 1] = acc.y;
          a.out[3 * at + 2] = acc.z;
        }
        if ((kSched == kRefill || a.refill_ppl == 1) &&
            ((threadIdx.y * kBlockX + threadIdx.x) & (kWarp - 1)) == 0) {
          atomicMax(&a.tile_max[refill_tile(x, y - a.y0, width, a.tile_size)],
                    warp_max);
        }
      }
      flush_hist(sc.s_hist, a.hist, max_bounce);
      return;
    }
  }
  if (in_image) {
    // the last frame's mean over the samples it completed (spp with exact
    // spp, at least spp with kRefill)
    const int n_last = max(ns - (n_frames - 1) * spp, 1);
    acc = fold(acc, div(total, static_cast<float>(n_last)),
               frame0 + static_cast<uint32_t>(n_frames - 1), with_accum,
               clamp_accum);
    a.out[3 * (pix - a.y0 * width)] = acc.x;
    a.out[3 * (pix - a.y0 * width) + 1] = acc.y;
    a.out[3 * (pix - a.y0 * width) + 2] = acc.z;
    a.segs[pix - a.y0 * width] = segs;
  }
  flush_hist(sc.s_hist, a.hist, max_bounce);
}

// Both kernels' launch bounds: 128 threads a block, and for kChunks and
// kBvh 8 blocks an SM (at most 64 registers a thread); a minimum of 0, none
// given, for kSpheres, which ptxas then compiles as before (a minimum of 1
// moves their registers and spills). The kSpheres ones with a minimum of 7
// (72 registers, no spill where ptxas otherwise takes 64 and stores 16-20
// bytes of spills) were as fast on RTIOW exact, 2-4% slower with fast
// scatter and 2% slower past the shared-memory limit (PERF.md). The
// kChunks ones without it took 72 registers once their chunk scan went
// across the warp, and Cornell 512x512 ran 5-10% slower than with it
// (tools/scan_ab.py on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
//
// Exactly spp samples a pixel; kBvh starts a warp's samples together (see
// the header).
template <Geometry kGeom, Scatter kScatter, Probe kProbe = kNone,
          Tables kTab = kStaged>
__global__ void __launch_bounds__(kBlockX * kBlockY, kGeom == kSpheres ? 0 : 8)
render_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  constexpr Schedule kSched = kGeom == kBvh ? kLockstep : kExact;
  render_slots<kSched, kGeom, kScatter, kProbe, kTab>(smem4, a);
}

// The adaptive sample refill (cfg.adaptive_spp); kKnobs, under the TPU
// kernel's lane knobs (kKnobRefill).
template <Geometry kGeom, Scatter kScatter, Probe kProbe = kNone,
          Tables kTab = kStaged, bool kKnobs = false>
__global__ void __launch_bounds__(kBlockX * kBlockY, kGeom == kSpheres ? 0 : 8)
render_adaptive(const Args a) {
  extern __shared__ float4 smem4[];
  render_slots<kKnobs ? kKnobRefill : kRefill, kGeom, kScatter, kProbe, kTab>(
      smem4, a);
}

// Phase 2 of render_adaptive<..., kKnobs> with more than one pixel a lane:
// one thread a lane's last pixel, over the lane pass's list (kKnobList).
template <Geometry kGeom, Scatter kScatter, Probe kProbe = kNone,
          Tables kTab = kStaged>
__global__ void __launch_bounds__(kBlockX * kBlockY, kGeom == kSpheres ? 0 : 8)
render_listed(const Args a) {
  extern __shared__ float4 smem4[];
  render_slots<kKnobList, kGeom, kScatter, kProbe, kTab>(smem4, a);
}

// The lane pass's block: one a tile, a warp's worth of warps (its list's
// scan adds the warps' counts across one warp).
constexpr int kLanePassThreads = 1024;
constexpr int kLanePassWarps = kLanePassThreads / kWarp;
static_assert(kLanePassWarps == kWarp, "the list's scan takes a warp a warp");
// The tile positions a lane-pass thread loads at once: a lane's pixels
// (1, 2, 4 or 8), for as many of its lanes as fit.
constexpr int kLanePassBatch = 16;

// A tile position's place in a launch over the band (16 x 8 blocks in grid
// order, 16 x 2 warps, x fastest), counted within its tile of side ts, a
// multiple of 16: its block row, block column, then row and column in the
// block. So a block's row of 16 threads is a run of 16 places.
__device__ __forceinline__ int thread_order(int local, int ts) {
  const int lx = local % ts, ly = local / ts;
  return ((ly / kBlockY) * (ts / kBlockX) + lx / kBlockX) *
             (kBlockX * kBlockY) +
         (ly % kBlockY) * kBlockX + lx % kBlockX;
}

// Refill's lane pass, between render_adaptive's two launches where a lane
// traces more than one pixel (Args.refill_ppl > 1). Replaces the part of the
// TPU kernel's tile vote that its lanes' pixel switch adds
// (megakernel.py:1818-1836, :1857-1885): a lane traces its ppl pixels of the
// tile in turn, each after the last's quota, so it is done at the sum of its
// pixels' slots from phase 1, each but the last taken up to its next start
// (with two phases the next even slot); the tile votes for extra samples
// until its largest sum. One block a tile of the band, its threads taking
// the tile's ts * ts / ppl lanes in turn, kLanePassBatch / ppl lanes at a
// time (kPpl = ppl), their positions and slots loaded together before any
// is used, so a thread waits for two reads in a row (perm's, then the
// slot's), not two a lane: lane j's phase-p pixel is tile
// position p * ts * ts / ppl + j, or perm's entry there (the launcher's cost
// pairing, megakernel.py:2596-2632), the clamped border pixel for a position
// past the frame. It writes each pixel's resume slot, its lane's sum where
// it is the lane's last pixel and lies in the band, else -1; its tile's
// largest sum, a reduction over the block; and the tile's segment of the
// lane list (ts * ts / ppl entries from tile t * ts * ts / ppl): the frame
// indices of its lanes' last pixels in the band, in the order a launch over
// the band would give their threads (thread_order), then -1. The order is a
// block-wide scan of a byte a tile position, in shared memory by that
// order: each thread counts its run of 16-byte rows (a block's row of 16
// threads each), the counts are added across the block (a warp's by
// shuffles, then the warps' across one warp), and each thread writes its
// rows' listed pixels from its offset. No atomics. The plain version is
// kernels/megakernel.py refill_lane_pass_plain. What bounds it: bytes, the
// slot map and perm read once, the resume map and the list written once;
// but a tile (16,384 pixels at ts 128) is the work of one SM, and a frame of
// a few tiles leaves the card's other SMs idle (PERF.md).
template <int kPpl>
__global__ void __launch_bounds__(kLanePassThreads)
    refill_lanes(const int* __restrict__ slots, const int* __restrict__ perm,
                 int* __restrict__ resume, int* __restrict__ tile_max,
                 int* __restrict__ lane_list, int width, int height, int y0,
                 int y1, int ts, int phases) {
  constexpr int kGroup = kLanePassBatch / kPpl;  // lanes a thread takes at once
  extern __shared__ uint4 listed[];  // a byte a tile position, by its place
  __shared__ int warp_max[kLanePassWarps];
  __shared__ int warp_sum[kLanePassWarps];
  unsigned char* flag = reinterpret_cast<unsigned char*>(listed);
  const int t = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int area = ts * ts, per_tile = area / kPpl, rows = area / kBlockX;
  const int n_tx = (width + ts - 1) / ts;
  const int x0 = (t % n_tx) * ts, top = y0 + (t / n_tx) * ts;
  const int* tile_perm =
      perm != nullptr ? perm + static_cast<size_t>(t) * area : nullptr;
  for (int r = tid; r < rows; r += kLanePassThreads) {
    listed[r] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  int best = 0;
  for (int j0 = tid; j0 < per_tile; j0 += kGroup * kLanePassThreads) {
    // entry q: lane j0 + (q % kGroup) * kLanePassThreads, its pixel q / kGroup
    int local[kLanePassBatch], e[kLanePassBatch];
#pragma unroll
    for (int q = 0; q < kLanePassBatch; ++q) {
      const int j = j0 + (q % kGroup) * kLanePassThreads;
      const int k = (q / kGroup) * per_tile + j;
      local[q] = j >= per_tile ? 0 : tile_perm != nullptr ? tile_perm[k] : k;
    }
#pragma unroll
    for (int q = 0; q < kLanePassBatch; ++q) {
      const int ux = x0 + local[q] % ts, uy = top + local[q] / ts;
      e[q] = j0 + (q % kGroup) * kLanePassThreads >= per_tile
                 ? 0
                 : slots[(min(uy, height - 1) - y0) * width +
                         min(ux, width - 1)];
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (j0 + g * kLanePassThreads < per_tile) {
        int sum = 0;
#pragma unroll
        for (int p = 0; p < kPpl; ++p) {
          const int q = p * kGroup + g;
          const int ux = x0 + local[q] % ts, uy = top + local[q] / ts;
          const bool last = p == kPpl - 1;
          sum += !last && phases == 2 ? e[q] + (e[q] & 1) : e[q];
          if (ux < width && uy < y1) {
            resume[(uy - y0) * width + ux] = last ? sum : -1;
            if (last) flag[thread_order(local[q], ts)] = 1;
          }
        }
        best = max(best, sum);
      }
    }
  }
  best = __reduce_max_sync(kFullMask, best);
  if (lane == 0) warp_max[warp] = best;
  __syncthreads();
  if (warp == 0) {
    const int m = __reduce_max_sync(kFullMask, warp_max[lane]);
    if (lane == 0) tile_max[t] = m;
  }
  // the thread's run of rows, and how many of their places are listed
  const int per_thread = (rows + kLanePassThreads - 1) / kLanePassThreads;
  const int r0 = min(tid * per_thread, rows);
  const int r1 = min(r0 + per_thread, rows);
  int count = 0;
  for (int r = r0; r < r1; ++r) {
    const uint4 f = listed[r];  // bytes of 0 or 1
    count += __popc(f.x) + __popc(f.y) + __popc(f.z) + __popc(f.w);
  }
  int upto = count;
  for (int d = 1; d < kWarp; d <<= 1) {
    const int n = __shfl_up_sync(kFullMask, upto, d);
    if (lane >= d) upto += n;
  }
  if (lane == kWarp - 1) warp_sum[warp] = upto;
  __syncthreads();
  const int c = warp_sum[lane];
  int warps_upto = c;
  for (int d = 1; d < kWarp; d <<= 1) {
    const int n = __shfl_up_sync(kFullMask, warps_upto, d);
    if (lane >= d) warps_upto += n;
  }
  const int listed_n = __shfl_sync(kFullMask, warps_upto, kWarp - 1);
  int* list = lane_list + static_cast<size_t>(t) * per_tile;
  int at = __shfl_sync(kFullMask, warps_upto - c, warp) + upto - count;
  for (int r = r0; r < r1; ++r) {
    // row r: row r % 8 of the tile's block r / 8, 16 places from its left
    const int blk = r / kBlockY;
    const int lx = (blk % (ts / kBlockX)) * kBlockX;
    const int ly = (blk / (ts / kBlockX)) * kBlockY + r % kBlockY;
    const int first = (top + ly) * width + x0 + lx;
    const uint4 f = listed[r];
#pragma unroll
    for (int i = 0; i < kBlockX; ++i) {
      const unsigned word = i < 4 ? f.x : i < 8 ? f.y : i < 12 ? f.z : f.w;
      if ((word >> (8 * (i % 4))) & 1u) list[at++] = first + i;
    }
  }
  for (int i = listed_n + tid; i < per_tile; i += kLanePassThreads) {
    list[i] = -1;
  }
}

using Kernel = void (*)(const Args);

// The instantiation for a Probe and a Tables value, or null. The production
// library compiles the twenty-four of kNone, twelve a route, and under the
// lane knobs (`knobs`) twelve render_adaptive ones and their twelve
// render_listed ones (`listed`: phase 2 over the lane list), six a route
// each; a probe library (-DRTX_PROBES) the four of each geometry for its
// Probe (RTX_PROBE), sampler (RTX_FAST_SCATTER) and route (RTX_TABLES)
// instead: render_kernel, render_adaptive, and under the knobs
// render_adaptive and render_listed.
#ifdef RTX_PROBES
constexpr Probe kLibProbe = static_cast<Probe>(RTX_PROBE);
constexpr Scatter kLibScatter = RTX_FAST_SCATTER ? kFastScatter : kBoxMuller;
constexpr Tables kLibTables = RTX_TABLES ? kGlobal : kStaged;
static_assert(kLibProbe != kNone && kLibProbe <= kNoCull, "RTX_PROBE");
#endif
template <Geometry kGeom>
Kernel kernel_of(int probe, int tables, bool adaptive, bool fast_scatter,
                 bool knobs, bool listed) {
#ifdef RTX_PROBES
  if (probe != kLibProbe || fast_scatter != (kLibScatter == kFastScatter) ||
      tables != kLibTables || (listed && !knobs) || (knobs && !adaptive)) {
    return nullptr;
  }
  if (listed) return render_listed<kGeom, kLibScatter, kLibProbe, kLibTables>;
  if (knobs) {
    return render_adaptive<kGeom, kLibScatter, kLibProbe, kLibTables, true>;
  }
  return adaptive ? render_adaptive<kGeom, kLibScatter, kLibProbe, kLibTables>
                  : render_kernel<kGeom, kLibScatter, kLibProbe, kLibTables>;
#else
  if (probe != kNone) return nullptr;
  if (listed) {
    if (!adaptive || !knobs) return nullptr;
    if (tables == kGlobal) {
      return fast_scatter ? render_listed<kGeom, kFastScatter, kNone, kGlobal>
                          : render_listed<kGeom, kBoxMuller, kNone, kGlobal>;
    }
    if (tables != kStaged) return nullptr;
    return fast_scatter ? render_listed<kGeom, kFastScatter>
                        : render_listed<kGeom, kBoxMuller>;
  }
  if (knobs) {
    if (!adaptive) return nullptr;
    if (tables == kGlobal) {
      return fast_scatter
                 ? render_adaptive<kGeom, kFastScatter, kNone, kGlobal, true>
                 : render_adaptive<kGeom, kBoxMuller, kNone, kGlobal, true>;
    }
    if (tables != kStaged) return nullptr;
    return fast_scatter
               ? render_adaptive<kGeom, kFastScatter, kNone, kStaged, true>
               : render_adaptive<kGeom, kBoxMuller, kNone, kStaged, true>;
  }
  if (tables == kGlobal) {
    if (fast_scatter) {
      return adaptive ? render_adaptive<kGeom, kFastScatter, kNone, kGlobal>
                      : render_kernel<kGeom, kFastScatter, kNone, kGlobal>;
    }
    return adaptive ? render_adaptive<kGeom, kBoxMuller, kNone, kGlobal>
                    : render_kernel<kGeom, kBoxMuller, kNone, kGlobal>;
  }
  if (tables != kStaged) return nullptr;
  if (fast_scatter) {
    return adaptive ? render_adaptive<kGeom, kFastScatter>
                    : render_kernel<kGeom, kFastScatter>;
  }
  return adaptive ? render_adaptive<kGeom, kBoxMuller>
                  : render_kernel<kGeom, kBoxMuller>;
#endif
}

// The instantiation for a Geometry, a Probe and a Tables value, or null.
Kernel kernel_for(int geometry, int probe, int tables, bool adaptive,
                  bool fast_scatter, bool knobs, bool listed = false) {
  switch (geometry) {
    case kSpheres:
      return kernel_of<kSpheres>(probe, tables, adaptive, fast_scatter, knobs,
                                 listed);
    case kChunks:
      return kernel_of<kChunks>(probe, tables, adaptive, fast_scatter, knobs,
                                listed);
    case kBvh:
      return kernel_of<kBvh>(probe, tables, adaptive, fast_scatter, knobs,
                             listed);
    default:
      return nullptr;
  }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t launch(Kernel kernel, Tables tables, const Args& a,
                   cudaStream_t stream) {
  const size_t smem = shared_bytes(tables, a.n_sph, a.n_clusters, a.n_chunks,
                                   a.n_supers, a.max_bounce);
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 block(kBlockX, kBlockY);
  dim3 grid((a.width + kBlockX - 1) / kBlockX,
            (a.y1 - a.y0 + kBlockY - 1) / kBlockY);
  if (a.lane_list != nullptr) {
    // refill's phase 2 over the lane list: a block a run of 128 entries
    const int n_tiles = ((a.width + a.tile_size - 1) / a.tile_size) *
                        ((a.y1 - a.y0 + a.tile_size - 1) / a.tile_size);
    grid = dim3(n_tiles * (a.tile_size * a.tile_size / a.refill_ppl) /
                (kBlockX * kBlockY));
  }
  kernel<<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// A launch's dynamic shared memory; `geometry` is a Geometry value,
// `tables` a Tables value. The chunk table and its second level are staged
// by kChunks only.
extern "C" size_t rtx_shared_bytes(int geometry, int tables, int n_sph,
                                   int n_clusters, int n_chunks, int n_supers,
                                   int max_bounce) {
  const bool chunks = geometry == kChunks;
  return shared_bytes(tables == kGlobal ? kGlobal : kStaged, n_sph,
                      n_clusters, chunks ? n_chunks : 0,
                      chunks ? n_supers : 0, max_bounce);
}

// How many blocks of an instantiation one SM holds at once with `smem`
// bytes of dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a CUDA error
// code; `knobs` picks a render_adaptive instantiation under the lane knobs.
extern "C" int rtx_occupancy(int geometry, int tables, int adaptive,
                             int fast_scatter, int knobs, size_t smem) {
  const Kernel kernel = kernel_for(geometry, kNone, tables, adaptive != 0,
                                   fast_scatter != 0, knobs != 0);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_shared(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kBlockX * kBlockY, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// `geometry` picks the instantiation (0 kSpheres, 1 kChunks, 2 kBvh) and
// `tables` its route (0 kStaged, 1 kGlobal: tables past a block's shared
// memory). Every geometry takes the sphere tables (16-byte aligned; empty for a
// scene without spheres), the clusters in visit order, and with
// n_sph_supers > 0 a super row over each run of them (read in global memory
// on both routes). kChunks and kBvh need the triangle tables
// (tri_rows 16-byte aligned), kChunks the chunk table and, with n_supers
// > 0, a box over each run of super_size chunks; kBvh the node table
// (64-byte aligned rows), the leaf rows and the BVH's node count (the
// traversal's pop cap is 4 x nodes); the pointers a geometry does not read
// may be null. `adaptive` picks render_adaptive over render_kernel,
// `fast_scatter` the kFastScatter sampler. Rows y0 .. y1 - 1 of the
// width x height frame are rendered (0 <= y0 < y1 <= height; for refill
// on tile rows, see above): out, segs and accum_in hold those y1 - y0
// rows, and each pixel's seed and camera ray are the whole frame's.
// Refill takes two launches (see kRefill): refill_phase 1, then 2, with
// the same scratch (16 bytes a pixel of the band), tile_max (an int a
// tile_size x tile_size tile of the band, zeroed before phase 1 where
// refill_ppl is 1, else the lane pass's), segs
// and hist; phase 1's out (the running average before the last frame,
// written only with accum_in) is phase 2's accum_in. With refill_ppl > 1
// phase 1 also takes `image`, phase 2's out, where it writes each pixel's
// image without extra samples, and phase 2 takes the lane pass's
// lane_list and runs over it; both null otherwise. Exact spp passes 0
// and nulls there. Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue without one for rows or refill arguments outside
// those rules.
//
// A probe library's entry is rtx_render_probe(probe, stub, n_tris,
// geometry, ...): the same arguments after its Probe value, the stub row
// (STUB_ROW floats, kernels/megakernel.py stub_row; null but for
// kStubIntersect and kStubFetch) and the count of triangle rows, with its
// library's fast_scatter and tables; cudaErrorInvalidValue for any other.
#ifdef RTX_PROBES
extern "C" int rtx_render_probe(
    int probe, const void* stub, int n_tris,
#else
extern "C" int rtx_render(
#endif
    int geometry, int tables, const void* sph, const void* sph_orig,
    const void* sph_mat,
    int n_sph, const void* clusters, int n_clusters, int n_hoist,
    const void* sph_supers, int n_sph_supers, const void* tri_rows, const void* tri_normals, const void* tri_mat,
    const void* chunks, int n_chunks, const void* supers, int n_supers,
    int super_size, const void* bvh_nodes, const void* bvh_leaves,
    int n_nodes, const void* mats, const void* params, int width, int height,
    int y0, int y1, int spp, int max_bounce, unsigned int frame0, int n_frames,
    const void* accum_in, int clamp_accum, int adaptive, int fast_scatter,
    int refill_phase, void* scratch, void* tile_max, int tile_size,
    void* slot_map, int refill_ppl, int refill_phases, void* image,
    const void* lane_list, int chunk_warp_scan, void* out, void* segs,
    void* hist, void* stream) {
#ifndef RTX_PROBES
  const int probe = kNone;
#endif
  if (y0 < 0 || y0 >= y1 || y1 > height) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (adaptive) {
    // whole tiles, each holding whole warps; both phases' buffers; lanes
    // that divide the tile's rows of 128, and a slot map where a lane has
    // more than one pixel or two phases
    const bool tiles_ok = tile_size > 0 && tile_size % kBlockX == 0 &&
                          y0 % tile_size == 0 &&
                          (y1 == height || y1 % tile_size == 0);
    const bool lanes_ok =
        (refill_ppl == 1 || refill_ppl == 2 || refill_ppl == 4 ||
         refill_ppl == 8) &&
        (tile_size * tile_size / kLanes) % refill_ppl == 0 &&
        (refill_phases == 1 || refill_phases == 2) &&
        (slot_map != nullptr || (refill_ppl == 1 && refill_phases == 1));
    // with more than one pixel a lane, phase 1's image and phase 2's list
    const bool listed = refill_ppl > 1;
    const bool list_ok =
        refill_phase == 1
            ? (image != nullptr) == listed && lane_list == nullptr
            : (lane_list != nullptr) == listed && image == nullptr;
    if (!tiles_ok || !lanes_ok || !list_ok ||
        (refill_phase != 1 && refill_phase != 2) || scratch == nullptr ||
        tile_max == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (image != nullptr || lane_list != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#ifdef RTX_PROBES
  if (stubbed(static_cast<Probe>(probe)) != (stub != nullptr) || n_tris < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool by_chunks = geometry == kChunks;
  const Args a = {
      static_cast<const float4*>(sph),
      static_cast<const int*>(sph_orig),
      static_cast<const int*>(sph_mat),
      n_sph,
      static_cast<const float4*>(clusters),
      n_clusters,
      n_hoist,
      static_cast<const float4*>(sph_supers),
      n_sph_supers,
      static_cast<const float4*>(tri_rows),
      static_cast<const float*>(tri_normals),
      static_cast<const int*>(tri_mat),
      static_cast<const float4*>(chunks),
      by_chunks ? n_chunks : 0,
      static_cast<const float4*>(supers),
      by_chunks ? n_supers : 0,
      super_size,
      static_cast<const float4*>(bvh_nodes),
      static_cast<const int4*>(bvh_leaves),
      geometry == kBvh ? n_nodes : 0,
      static_cast<const float*>(mats),
      static_cast<const float*>(params),
      width,
      height,
      y0,
      y1,
      spp,
      max_bounce,
      frame0,
      n_frames,
      static_cast<const float*>(accum_in),
      clamp_accum,
      static_cast<float*>(out),
      static_cast<int*>(segs),
      static_cast<int*>(hist),
      refill_phase,
      static_cast<float4*>(scratch),
      static_cast<int*>(tile_max),
      tile_size,
      static_cast<int*>(slot_map),
      adaptive ? refill_ppl : 1,
      adaptive ? refill_phases : 1,
      by_chunks ? chunk_warp_scan : 0,
      static_cast<float*>(image),
      static_cast<const int*>(lane_list)
#ifdef RTX_PROBES
      , static_cast<const float*>(stub), n_tris
#endif
  };
  // a lane of more than one pixel, or two phases, takes the knobs'
  // instantiation (kKnobRefill), and phase 2 over the lane list its own
  // (kKnobList)
  const bool knobs = adaptive && (a.refill_ppl != 1 || a.refill_phases != 1);
  const Kernel kernel = kernel_for(geometry, probe, tables, adaptive != 0,
                                   fast_scatter != 0, knobs,
                                   lane_list != nullptr);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch(kernel, tables == kGlobal ? kGlobal : kStaged, a, s));
}

// Refill's lane pass (refill_lanes) over the band y0 .. y1 - 1 of a width x
// height frame, after render_adaptive's phase 1 with refill_ppl = ppl > 1:
// slots (phase 1's slot map, an int a pixel of the band) -> resume (the
// same shape, phase 2's slot map), tile_max (an int a tile_size x tile_size
// tile of the band) and lane_list (tile_size * tile_size / ppl ints a tile:
// phase 2's threads). perm is null, or an int a position of each tile
// (kernels/megakernel.py pair_perm). The tiles' rule is rtx_render's for
// refill; ppl 1, 2, 4 or 8 dividing the tile's rows of 128, phases 1 or 2.
// A block takes a tile and a byte of shared memory a tile position. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue without
// one.
extern "C" int rtx_refill_lanes(const void* slots, const void* perm,
                                void* resume, void* tile_max, void* lane_list,
                                int width, int height, int y0, int y1,
                                int tile_size, int ppl, int phases,
                                void* stream) {
  const bool ok =
      0 <= y0 && y0 < y1 && y1 <= height && width > 0 && tile_size > 0 &&
      (tile_size * tile_size) % kLanes == 0 && y0 % tile_size == 0 &&
      (y1 == height || y1 % tile_size == 0) &&
      (ppl == 1 || ppl == 2 || ppl == 4 || ppl == 8) &&
      (tile_size * tile_size / kLanes) % ppl == 0 &&
      (phases == 1 || phases == 2) && slots != nullptr &&
      resume != nullptr && tile_max != nullptr && lane_list != nullptr;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  using LanePass = void (*)(const int*, const int*, int*, int*, int*, int,
                           int, int, int, int, int);
  const LanePass pass = ppl == 1   ? refill_lanes<1>
                        : ppl == 2 ? refill_lanes<2>
                        : ppl == 4 ? refill_lanes<4>
                                   : refill_lanes<8>;
  const int n_tiles = ((width + tile_size - 1) / tile_size) *
                      ((y1 - y0 + tile_size - 1) / tile_size);
  const size_t smem = static_cast<size_t>(tile_size) * tile_size;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pass<<<n_tiles, kLanePassThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slots), static_cast<const int*>(perm),
      static_cast<int*>(resume), static_cast<int*>(tile_max),
      static_cast<int*>(lane_list), width, height, y0, y1, tile_size, phases);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
