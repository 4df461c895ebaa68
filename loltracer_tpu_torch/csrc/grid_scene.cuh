// GridScene: the instanced distance search of lol_instanced_render /
// lol_instanced_fwd (K5, K5r), lol_instanced_bwd (K6, its SDF adjoint
// `dist_bwd` through `winner`), lol_instanced_eval (K7) and lol_rg_march /
// lol_rg_shadow / lol_rg_shade (K9a-c) over a cell grid of candidate spheres
// (render/cell_grid.py), with InstancedScene's run walk
// (csrc/instanced_scene.cuh) as its fallback.
//
// Why: the run walk costs every evaluation a pass over the ~157 run balls
// and the ~750 spheres of the ~11.7 runs it visits, where ~7 spheres lie
// within the cut (PERF.md section 5); that work, in FP32 and SFU issue, is
// most of K5's gap to its bound. The grid takes a thread from its point to
// one list in O(1): the spheres that may come within `reach` of the point's
// cell, ~27 read a search at 1-unit cells in instanced:10000, through the
// read-only path; a warp's 8 x 4 pixel tile mostly shares a cell, so its
// loads are broadcasts. The TPU's answer (scratch gathers of micro-blocks
// along a patch's swept segment, a windowed best-first pick) is a layout
// answer for its vector memory and is not carried over.
//
// A search at p takes one cell's list: p's own cell when p lies in the
// grid within reach of the AABB, else the cell of q, the point of the AABB
// nearest p (clamp(p, lo, hi)), when q lies in the grid (it does unless the
// AABB is wider than the grid: a shard's grid under the AABB combined over
// the object axis). (Beyond reach of the AABB every sphere is beyond reach,
// so p's own cell could not certify there; the grid's last cells reach up
// to a cell farther than reach.) It takes the min over the list with the
// plain version's expression at p, starting from the cut (or from +inf
// when exact), as the run walk does; then
// - certified: in p's own cell, when the min ends at <= reach; in q's cell,
//   under the condition below. Then every sphere at or below the min is in
//   the list, so the min is the run walk's value, and `winner`'s
//   first-wins argmin its argmin, ties included (the tie test is the run
//   walk's: the smaller SoA index wins);
// - else it falls back: the run walk from the bound found so far (a bound:
//   the listed spheres and the cut are among the candidates of the exact
//   min). The walk visits every run whose ball can hold a sphere at or
//   below its running bound, so it finds the exact min; min is order-free,
//   no -0 enters (|p - c| - r and py - y are +0 when they vanish), and the
//   build uses --fmad=false: the value is InstancedScene's bitwise.
//   `winner`'s walk restarts its argmin at that bound, whose sphere it
//   meets again. Fallbacks are: exact mode far from every sphere; points
//   beyond a few hundred units; `winner`'s unbounded search (sdf_mat) when
//   no listed sphere is that near; a clamp above the reach that no listed
//   sphere undercuts (the shadow clamp 8 case).
//
// Rounding. Below, e is a few ulps of the scene's coordinates and
// distances: each of the computations involved (the build's box distance,
// the cell chosen for a point by floor((x - origin) / cell), a sphere's
// |p - c| - r, the AABB distance) errs by about 2^-24 times the magnitudes
// it adds, far less than BOUND_MARGIN (0.0625) at the scene's scale.
//
// In p's own cell. The build lists row j in cell c when its float32 box
// distance minus r is <= reach + BOUND_MARGIN. An unlisted sphere has exact
// box distance - r > reach + margin - e; p lies within e of the cell's
// exact box, so its exact |p - c| - r > reach + margin - 2e, and the value
// computed here is > reach + margin - 3e > reach >= the min.
//
// In q's cell (p beyond reach of the AABB B, whose every ball it holds; d
// = the exact distance from p to B). A sphere's centre c lies in B_r, B
// shrunk by its radius r, and q_r, the point of B_r nearest p, is at least
// d + r from p. Projection onto a convex set gives |p - c|^2 >= |p - q_r|^2
// + |q_r - c|^2, so a sphere whose exact distance is <= d + eta has
// |q_r - c|^2 <= (d + r + eta)^2 - (d + r)^2 = eta (2 (d + r) + eta), and,
// as |q - q_r| <= sqrt(3) r, its surface lies within
//   tilt + sqrt(eta (2 (d + r_max) + eta)),   tilt = (sqrt(3) - 1) r_max,
// of q. Every sphere whose computed distance is <= the min has an exact
// one <= d + eta with eta = (min - d_computed) + eps, where eps = 4e-6 (|p|_1
// + coord + d + 1) bounds the two roundings (coord: the largest magnitude
// of the AABB's coordinates, so of every centre). When that bound is <=
// reach, every such sphere is listed in q's cell (q within e of that cell's
// box, the margin again): certified. Under a clamp there, d > reach >
// clamp, so the cut is the AABB distance, the min is <= it, and eta <= eps:
// certified out to a few hundred units. (So "p outside the grid => the
// answer is the cut" is not what is used: a sphere touching the AABB's face
// nearest p has an exact distance equal to the cut's, and the two computed
// values may differ by an ulp either way; such a sphere lies in q's list,
// and the min over it decides.)
//
// Shared memory holds the run balls for the fallback, as before; the lists
// are read from global memory, each entry's sphere stored in the list (one
// 16-byte load an entry; 38 MB at 1-unit cells, in L2), its row read only
// for `winner`'s tie test. With
// kStats (the `_stats` entries only), each thread counts its searches, its
// fallbacks and the list entries it read, and flush() adds them to
// grid.stats at the end of the thread: summed over the warp's threads that
// flush together, then one atomicAdd a counter by the first of them (the
// sums are exact: warp_sum adds 16-bit limbs).
//
// The device functions also compile as host C++ (tests/test_torch_grid_host.py).

namespace lol {

// The cell grid of render/cell_grid.py, passed by value.
struct GridTables {
  float ox, oy, oz;   // the low corner of cell (0, 0, 0)
  int nx, ny, nz;     // cells per axis (all 0: no cell, every point is outside)
  float inv_cell;     // 1 / the cell's edge
  float reach;        // a search in p's cell that ends <= reach is certified
  float r_max;        // the largest radius
  float tilt;         // (sqrt(3) - 1) r_max, rounded up
  float coord;        // the largest magnitude of the AABB's coordinates
  const int* __restrict__ start;  // [nx ny nz + 1] each cell's first entry
  const int* __restrict__ rows;   // [entries] sorted rows, ascending in a cell
  const float4* __restrict__ cells;  // [entries] each entry's sphere (x y z r)
  unsigned long long* stats;      // [3] searches, fallbacks, entries read (kStats)
};

template <class L, class C, bool kCount = false>
struct GridScene : InstancedScene<L, C, GridScene<L, C, kCount>> {
  using Base = InstancedScene<L, C, GridScene<L, C, kCount>>;
  static constexpr bool kStats = kCount;

  // which list a search took
  static constexpr int kNone = 0;  // none: it falls back
  static constexpr int kOwn = 1;   // p's own cell
  static constexpr int kNear = 2;  // the cell of the AABB's point nearest p

  GridTables grid;
  mutable unsigned long long n_search = 0, n_fallback = 0, n_read = 0;

  // records: where dist_bwd<true> records (K6), as InstancedScene's
  __device__ __forceinline__ GridScene(const float* __restrict__ P_, const InstancedTables& t,
                                       const float4* groups, const GridTables& g,
                                       RecordSink* records = nullptr)
      : Base(P_, t, groups, records), grid(g) {}

  // [b, e) of grid.rows: the list of the cell of (x, y, z); false (and an
  // empty list) when the point lies outside the grid (NaN included)
  __device__ __forceinline__ bool cell_of(float x, float y, float z, int& b, int& e) const {
    const float fx = (x - grid.ox) * grid.inv_cell;
    const float fy = (y - grid.oy) * grid.inv_cell;
    const float fz = (z - grid.oz) * grid.inv_cell;
    b = e = 0;
    if (!(fx >= 0.f && fx < (float)grid.nx && fy >= 0.f && fy < (float)grid.ny &&
          fz >= 0.f && fz < (float)grid.nz))
      return false;
    const int c = ((int)fz * grid.ny + (int)fy) * grid.nx + (int)fx;
    b = __ldg(grid.start + c);
    e = __ldg(grid.start + c + 1);
    return true;
  }

  // InstancedScene::sphere_dist of list entry k's sphere, read from the
  // list itself: one load, not a row and then its sphere
  __device__ __forceinline__ float entry_dist(int k, float px, float py, float pz) const {
    const float4 s = __ldg(grid.cells + k);
    const float dx = px - s.x, dy = py - s.y, dz = pz - s.z;
    return sqrtf((dx * dx + dy * dy) + dz * dz) - s.w;
  }

  // the list a search at p, d_box from the AABB, takes (file comment):
  // kOwn, kNear or kNone
  __device__ __forceinline__ int locate(float px, float py, float pz, float d_box, int& b,
                                        int& e) const {
    if (d_box <= grid.reach && cell_of(px, py, pz, b, e)) return kOwn;
    const float* bb = this->tab.bbox;
    const float qx = jmin(jmax(px, __ldg(bb)), __ldg(bb + 3));
    const float qy = jmin(jmax(py, __ldg(bb + 1)), __ldg(bb + 4));
    const float qz = jmin(jmax(pz, __ldg(bb + 2)), __ldg(bb + 5));
    return cell_of(qx, qy, qz, b, e) ? kNear : kNone;
  }

  // whether a search at p, d from the AABB, that took list `where` and
  // ended at `best` falls back (file comment); counted in the kStats build
  __device__ __forceinline__ bool falls_back(int where, float best, float px, float py,
                                             float pz, float d, int listed) const {
    bool fall = where == kNone || (where == kOwn && !(best <= grid.reach));
    if (where == kNear) {
      const float eps = 4e-6f * ((((fabsf(px) + fabsf(py)) + fabsf(pz)) + grid.coord) + d + 1.f);
      const float eta = (best - d) + eps;
      fall = !(grid.tilt + sqrtf(eta * (2.f * (d + grid.r_max) + eta)) <= grid.reach);
    }
    if constexpr (kStats) {
      ++n_search;
      n_fallback += fall;
      n_read += listed;
    }
    return fall;
  }

  // InstancedScene::dist_under, bitwise (file comment)
  template <bool kHasClamp>
  __device__ __forceinline__ float dist_under(float px, float py, float pz, float clamp) const {
    const float d_box = this->box_dist(px, py, pz);
    float best = kHasClamp ? jmax(d_box, clamp) : INFINITY;  // the cut
    int b, e;
    const int where = locate(px, py, pz, d_box, b, e);
    for (int k = b; k < e; ++k) {
      const float d = entry_dist(k, px, py, pz);
      if (d < best) best = d;
    }
    if (falls_back(where, best, px, py, pz, d_box, e - b)) {
      best = (kHasClamp || best < INFINITY) ? this->template walk<false>(px, py, pz, best)
                                            : this->template walk<true>(px, py, pz, best);
    }
    return this->planes(py, best);
  }

  // InstancedScene::winner, bitwise (file comment)
  __device__ __forceinline__ int winner(float px, float py, float pz, float& best) const {
    const float d_box = this->box_dist(px, py, pz);
    int b, e;
    const int where = locate(px, py, pz, d_box, b, e);
    int best_idx = INT_MAX, best_row = -1;
    for (int k = b; k < e; ++k) {
      const float d = entry_dist(k, px, py, pz);
      if (d <= best) {
        const int j = __ldg(grid.rows + k);
        const int idx = __ldg(&this->tab.ids[j].x);
        if (d < best || idx < best_idx) {
          best = d;
          best_idx = idx;
          best_row = j;
        }
      }
    }
    return falls_back(where, best, px, py, pz, d_box, e - b) ? Base::winner(px, py, pz, best)
                                                             : best_row;
  }

#ifdef __CUDACC__
  // the sum of v over the threads of `mask`, exact in 64 bits: a 16-bit
  // limb summed over 32 threads fits the 32 bits of __reduce_add_sync
  static __device__ __forceinline__ unsigned long long warp_sum(unsigned mask,
                                                                unsigned long long v) {
    unsigned long long s = 0;
#pragma unroll
    for (int k = 0; k < 64; k += 16)
      s += (unsigned long long)__reduce_add_sync(mask, (unsigned)(v >> k) & 0xffffu) << k;
    return s;
  }
#endif

  // the kStats counts into grid.stats (once per warp of flushing threads)
  __device__ __forceinline__ void flush() const {
#ifdef __CUDACC__
    if constexpr (kStats) {
      const unsigned mask = __activemask();
      const unsigned long long s = warp_sum(mask, n_search);
      const unsigned long long f = warp_sum(mask, n_fallback);
      const unsigned long long r = warp_sum(mask, n_read);
      unsigned lane;
      asm("mov.u32 %0, %%laneid;" : "=r"(lane));
      if (lane == (unsigned)(__ffs(mask) - 1)) {
        atomicAdd(grid.stats, s);
        atomicAdd(grid.stats + 1, f);
        atomicAdd(grid.stats + 2, r);
      }
    }
#endif
  }
};

}  // namespace lol
