// Pair warp: every sender's typed K/V map resampled into every receiver's
// BEV frame.  Two kernels with one contract and bit-identical outputs,
// and the previous form of the first, kept for timing.
//
// pair_warp_kernel replaces the Pallas kernel
// hmvit_tpu/ops/fused_warp.py::_warp_kernel (pallas_pair_warp, tile
// variant).  The contract: for receiver n
// (= b * R + i) and sender j, read sender j's map in receiver n's type
// variant, src[b, rtype[n], j], and warp it with the two-pass separable
// bilinear resample of hmvit_tpu/ops/shear_warp.py:
//   pass 2 (columns): ccoord = m00 x' + m01 y' + tx
//   pass 1 (rows, on each column tap c): rcoord = v1 y' + v0 c + ty_adj
// with hat weights max(0, 1 - |coord - cell|) computed in fp32 and cast
// to the compute type, the pass-1 value rounded to the compute type
// before pass 2, taps outside [0, size) contributing zero, the source
// read transposed when the conditioning swap is set, identity pairs
// copied, and pairs with non-finite coefficients written as zeros (the
// taps live in warp_taps.cuh).  pallas_pair_warp's destination-row
// window (dest_row_start / dest_row_tiles: the spatial-partitioning
// island computes only its shard's rows of every warped map, from the
// whole source) is the tile kernel's row0 / rows: taps and the ROI skip
// at global rows, stores at window rows.
//
// What bounds it on the H100: bytes.  At the serving shapes (16 pairs of
// 128 x 128 x 512 bf16) the output is 268 MB and the typed source maps
// 134 MB, and every output vector needs 4 source vectors; there is no
// reuse a tensor core could exploit (the Pallas kernel used the MXU only
// because a TPU gathers slowly).  The design:
//   * a block owns one (pair, strip of a 32 x 32 destination tile): 32
//     pixels wide, kStripH = 2 rows, so that the serving launch has 4096
//     blocks (several resident waves; taller strips measured slower);
//   * the block plans each pixel's taps once, into shared memory (the
//     previous body planned them once per 8 channels: 64 times per pixel
//     at C = 512); then a warp walks pixels, its lanes over the pixel's
//     16-byte vectors, two vectors a lane with all eight reads in flight
//     before the arithmetic: 32 lanes x 16 B = 512 contiguous bytes read
//     from each tap and stored a step (where a pixel has fewer than 32
//     vectors, a warp takes several pixels at once);
//   * 32-bit index math inside a map (the previous body did five 64-bit
//     divisions a thread);
//   * blocks ordered (b, sender, strip, receiver): the receivers that
//     read the same typed map run side by side, so it leaves device
//     memory about once, and the output is stored evict-first so that it
//     does not push the maps out of L2;
//   * the ROI tile skip: a strip out of the sender's view
//     (hm::tile_in_view, conservative) reads nothing and stores zeros —
//     the bits the taps would have given.
//
// pair_warp_previous_kernel is the previous body (one thread per
// (pair, y', x', 8 channels), no skip), reached only through
// hm_pair_warp_previous: the on-card bit anchor of both kernels here
// and their timing yardstick.
//
// pair_warp_resident_kernel replaces the Pallas kernel
// hmvit_tpu/ops/fused_warp.py::_warp_kernel_resident
// (pallas_pair_warp(variant="resident")): each source map is fetched
// once per (receiver, sender) pair and every destination pixel reads its
// taps from on-chip memory.  On this card "on-chip" is the shared memory
// of a thread-block cluster: 8 blocks own a (pair, channel slab), each
// block stages a band of size / 8 source rows of the slab with one TMA
// tensor load (an mbarrier per band), and the slab's destination pixels
// are split among the blocks by where their taps lie (TapRow below), so
// nearly every tap is read from the block's own shared memory and the
// few across a band edge from the neighbour's (distributed shared
// memory).  The slab is the widest of 64, 32 or 16 bytes a pixel whose
// band fits 74 KB, so that several blocks share an SM and one block's
// staging runs under another's arithmetic: 32 bytes (16 bf16 channels) at
// 128 x 128.  The slab clusters of one pair are launched side by side
// (grid x), so L2 sees each pixel's row of channels read and written by
// neighbouring clusters.  Identity and invalid pairs, and pairs with no
// 32 x 32 tile in view (the Pallas kernel's pvalid), skip the staging.
// The destination-row window (row0 / rows, as the tile kernel's) is
// pallas_pair_warp(variant="resident")'s: pvalid over the window's tiles
// only, every band still staged (a window row's taps may lie anywhere in
// the source), each block computing the window's pixels whose taps lie in
// its band; taps at global rows, stores at window rows.
// What bounds it: bytes, moved in slab-wide pieces (32 bytes a pixel, 1
// KB apart), which device memory serves more slowly than the tile
// kernel's 512-byte lines; the staging pass comes on top of the tile
// kernel's traffic, so it stays slower than the tile kernel.
#include <cooperative_groups.h>
#include <cuda.h>

#include "warp_taps.cuh"

namespace {

namespace cg = cooperative_groups;
using hm::WarpTaps;

// ---- the tile kernel ------------------------------------------------------

constexpr int kTileW = 32;  // destination tile width, pixels
constexpr int kStripH = 2;  // rows of a block's strip
constexpr int kStripPix = kTileW * kStripH;
constexpr int kTileThreads = 256;

// coef rows (n, j, 8): m00 m01 tx v0 v1 ty_adj swap flag, where flag is
// 0 = warp, 1 = identity copy, 2 = invalid pair (zeros).
// The destination is the row window [row0, row0 + rows) of the map (the
// whole map: 0, size): out holds (N, J, rows, size, c), and a pixel's taps
// and the ROI skip are planned at its global row.
// grid (B * J * strips * R); a map holds size * size * c < 2^31 elements.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
pair_warp_kernel(const T* __restrict__ src, const float* __restrict__ coef,
                 const int* __restrict__ rtype, T* __restrict__ out, int nj,
                 int ty_count, int n_recv, int size, int c, int row0,
                 int rows) {
  constexpr int V = 16 / (int)sizeof(T);  // channels a 16-byte vector
  __shared__ WarpTaps plans[kStripPix];
  __shared__ int src_pix[kStripPix];  // the pixel's own index in the map
  const int tiles_x = (size + kTileW - 1) / kTileW;
  const int strips = tiles_x * ((rows + kStripH - 1) / kStripH);
  // block -> (b, j, strip, r), receivers fastest
  int rest = blockIdx.x;
  const int r = rest % n_recv;
  rest /= n_recv;
  const int s = rest % strips;
  rest /= strips;
  const int j = rest % nj;
  const int b = rest / nj;
  const int n = b * n_recv + r;
  const int sy = s / tiles_x;
  const int x0 = (s - sy * tiles_x) * kTileW, y0 = row0 + sy * kStripH;
  const int w = min(kTileW, size - x0), h = min(kStripH, row0 + rows - y0);
  const int pair = n * nj + j;
  const float* cf = coef + (long long)pair * 8;
  const bool seen = hm::tile_in_view(cf, x0, y0, w, h, size);
  for (int p = threadIdx.x; p < w * h; p += blockDim.x) {
    const int py = p / w;
    const int x = x0 + p - py * w, y = y0 + py;
    WarpTaps plan = hm::plan_taps<T>(cf, x, y, size);
    if (!seen) plan.flag = 2;  // out of view: zeros, no reads
    plans[p] = plan;
    src_pix[p] = y * size + x;
  }
  __syncthreads();
  const int npix = size * size;
  const T* map =
      src + ((long long)(b * ty_count + rtype[n]) * nj + j) * npix * c;
  T* dst = out + (long long)pair * rows * size * c;
  const int dst0 = row0 * size;  // the window's first pixel in the map
  const int cvecs = c / V;
  // lanes a pixel (all 32, or the pixel's vectors) and pixels a warp step
  const int lpp = min(cvecs, 32), pps = 32 / lpp;
  const int lane = threadIdx.x & 31, sub = lane / lpp;
  const int nwarps = blockDim.x >> 5;
  if (sub >= pps) return;
  for (int p = (threadIdx.x >> 5) * pps + sub; p < w * h; p += nwarps * pps) {
    const WarpTaps plan = plans[p];
    const int self = src_pix[p];
    T* dp = dst + (long long)(self - dst0) * c;
    for (int v = lane - sub * lpp; v < cvecs; v += 2 * lpp) {
      const int v2 = v + lpp;
      const hm::TapWords ta =
          hm::fetch_taps(plan, hm::DeviceTaps<T>{map + v * V, c}, self);
      if (v2 < cvecs) {
        const hm::TapWords tb =
            hm::fetch_taps(plan, hm::DeviceTaps<T>{map + v2 * V, c}, self);
        __stcs(reinterpret_cast<uint4*>(dp + v * V),
               hm::combine_taps<T>(plan, ta));
        __stcs(reinterpret_cast<uint4*>(dp + v2 * V),
               hm::combine_taps<T>(plan, tb));
      } else {
        __stcs(reinterpret_cast<uint4*>(dp + v * V),
               hm::combine_taps<T>(plan, ta));
      }
    }
  }
}

// The previous body: one thread per (pair, y', x', 8 channels).
template <typename T>
__global__ void pair_warp_previous_kernel(const T* __restrict__ src,
                                          const float* __restrict__ coef,
                                          const int* __restrict__ rtype,
                                          T* __restrict__ out,
                                          int n_pairs_recv, int nj,
                                          int ty_count, int n_recv, int size,
                                          int c) {
  const int cvecs = c >> 3;
  const long long total =
      (long long)n_pairs_recv * nj * size * size * cvecs;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  long long rest = idx;
  const int cv = (int)(rest % cvecs);
  rest /= cvecs;
  const int x = (int)(rest % size);
  rest /= size;
  const int y = (int)(rest % size);
  rest /= size;
  const int j = (int)(rest % nj);
  const int n = (int)(rest / nj);

  const float* cf = coef + ((long long)n * nj + j) * 8;
  const int b = n / n_recv;
  const T* base =
      src + (((long long)b * ty_count + rtype[n]) * nj + j) *
                (long long)size * size * c +
      cv * 8;
  const WarpTaps taps = hm::plan_taps<T>(cf, x, y, size);
  float acc[8];
  hm::apply_taps<T, 8>(taps, base, c, y * size + x, acc);
  hm::store_vec<T, 8>(out + idx * 8, acc);
}

// ---- the resident kernel --------------------------------------------------

constexpr int kResidentThreads = 256;
constexpr int kCtas = 8;  // blocks of a cluster (the portable most)
// a band's share of shared memory: three blocks an SM
constexpr int kMaxStageBytes = 75776;
constexpr int kAlign = 128;              // a TMA destination's alignment

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  // make the initialised barrier visible to the TMA unit
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}

// box (slab channels, size pixels, band rows, 1 map) at (c0, 0, row0,
// map) -> dst, completion counted on bar
__device__ __forceinline__ void tma_load_band(void* dst, const CUtensorMap* tm,
                                              int c0, int row0, int map,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(tm)), "r"(c0), "r"(0),
      "r"(row0), "r"(map), "r"(smem_u32(bar))
      : "memory");
}

// q / d for 0 <= q < 2^22 and d > 0: a float estimate, corrected once
__device__ __forceinline__ int div_small(int q, int d, float inv_d) {
  int k = __float2int_rz((float)q * inv_d);
  k -= (k * d > q);
  k += ((k + 1) * d <= q);
  return k;
}

// Where a destination pixel's taps lie in the source map: about the
// physical row tr.at(x', y'), affine in (x', y') — the row coordinate's
// affine form, or under the conditioning swap (the source read
// transposed, so a physical row is a column of the resample) the column
// coordinate's.  A pixel whose row lies outside [-reach, size + reach)
// reads nothing: its taps' rows lie within 1 + |v0| of it (see
// hm::tile_in_view), and reach adds one more row and the fp32 slack.
struct TapRow {
  float a, b, c0, reach;
  __device__ __forceinline__ float at(int x, int y) const {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, (float)x), __fmul_rn(b, (float)y)),
                     c0);
  }
};

__device__ __forceinline__ TapRow tap_row(const float* __restrict__ cf,
                                          int size) {
  const float m00 = cf[0], m01 = cf[1], tx = cf[2];
  const float v0 = cf[3], v1 = cf[4], tya = cf[5];
  TapRow t;
  if (cf[6] > 0.5f) {
    t.a = m00;
    t.b = m01;
    t.c0 = tx;
  } else {
    t.a = __fmul_rn(v0, m00);
    t.b = __fadd_rn(__fmul_rn(v0, m01), v1);
    t.c0 = __fadd_rn(tya, __fmul_rn(v0, tx));
  }
  const float mag =
      (fabsf(m00) + fabsf(m01) + fabsf(v0) + fabsf(v1) + fabsf(t.a) +
       fabsf(t.b)) * (float)(size + 1) +
      fabsf(tx) + fabsf(tya) + fabsf(t.c0) + fabsf(v0 * tx);
  t.reach = 2.f + fabsf(v0) + 1e-3f + 1e-5f * mag;
  return t;
}

// grid (kCtas * slabs, pairs), clusters of kCtas blocks along x; dynamic
// shared memory: a band of band * size pixels of slab_ch channels, the
// band's mbarrier, alignment slack.  The destination is the row window
// [row0, row0 + rows) (the whole map: 0, size): out holds (N, J, rows,
// size, c), and the window's pixels are cut into kCtas equal runs, the
// destination share of each block (a band of rows for the whole map).  A
// staged pair's pixels are split by where their taps lie: block `rank`
// computes the window's pixels whose taps' row (TapRow) falls in its own
// band (rows off the map at either end go to the first and last band), so
// nearly every tap is read from the block's own shared memory and only
// those across a band edge from a neighbour's; the pixels whose taps lie
// off the map are zeros, written by the block whose destination share
// holds them.  Lanes walk the destination along
// x' (along y' under the swap) so that neighbouring lanes read
// neighbouring source pixels of one row, not one column (4 KB apart: the
// same shared-memory banks).
template <typename T>
__global__ void __launch_bounds__(kResidentThreads, 2)
pair_warp_resident_kernel(const __grid_constant__ CUtensorMap tmap,
                          const T* __restrict__ src,
                          const float* __restrict__ coef,
                          const int* __restrict__ rtype, T* __restrict__ out,
                          int nj, int ty_count, int n_recv, int size, int c,
                          int slab_ch, int row0, int rows) {
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ uint4 smem_words[];
  cg::cluster_group cluster = cg::this_cluster();
  // the same offset in every block of the cluster
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem_words);
  T* band_buf = reinterpret_cast<T*>(
      raw + ((kAlign - (smem_u32(raw) & (kAlign - 1))) & (kAlign - 1)));
  const int band = size / kCtas;
  const int band_pix = band * size;
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(band_buf + band_pix * slab_ch);
  const int rank = (int)cluster.block_rank();
  const int slab = blockIdx.x / kCtas;
  const int pair = blockIdx.y;
  const int n = pair / nj, j = pair - n * nj, b = n / n_recv;
  const int map = (b * ty_count + rtype[n]) * nj + j;
  const int npix = size * size;
  const float* cf = coef + (long long)pair * 8;
  const float flag = cf[7];
  // the Pallas kernel's pvalid: a warp pair with any 32 x 32 tile of the
  // window in view
  const int tiles = size / hm::kRoiTile;
  const int tile = threadIdx.x;
  const bool staged = __syncthreads_or(
      flag <= 0.5f && tile < tiles * (rows / hm::kRoiTile) &&
      hm::tile_in_view(cf, (tile % tiles) * hm::kRoiTile,
                       row0 + (tile / tiles) * hm::kRoiTile, hm::kRoiTile,
                       hm::kRoiTile, size));
  if (staged) {
    if (threadIdx.x == 0) mbar_init(bar);
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, (unsigned)(band_pix * slab_ch * sizeof(T)));
      tma_load_band(band_buf, &tmap, slab * slab_ch, rank * band, map, bar);
    }
    mbar_wait(bar, 0);
    cluster.sync();  // every band of the slab is on chip
  }
  const int svecs = slab_ch / V;  // lanes a pixel
  const int ppw = 32 / svecs;     // pixels a warp step
  const int lane = threadIdx.x & 31, sub = lane / svecs;
  const int ch = (lane - sub * svecs) * V;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const float inv_size = 1.f / (float)size;
  const float inv_band_pix = 1.f / (float)band_pix;
  const float fsize = (float)size;
  const T* gmap = src + (long long)map * npix * c + slab * slab_ch;
  const int dst0 = row0 * size;  // the window's first pixel in the map
  T* dst = out + (long long)pair * rows * size * c + slab * slab_ch;
  // this block's destination share: pixels [q_lo, q_hi) of the window
  const int wpix = rows * size;
  const int q_lo = dst0 + rank * (wpix / kCtas);
  const int q_hi = dst0 + (rank + 1) * (wpix / kCtas);
  if (!staged) {
    // an identity copy from device memory, or zeros: the destination share
    for (int pix = q_lo + warp * ppw + sub; pix < q_hi; pix += nwarps * ppw) {
      const int y = div_small(pix, size, inv_size);
      WarpTaps plan = hm::plan_taps<T>(cf, pix - y * size, y, size);
      if (flag <= 0.5f) plan.flag = 2;  // no tile in view
      *reinterpret_cast<uint4*>(dst + (pix - dst0) * c + ch) =
          hm::warp_vec16<T>(plan, gmap + ch, c, pix);
    }
  } else {
    const TapRow tr = tap_row(cf, size);
    const float inv_band = 1.f / (float)band;
    // the block that computes a pixel, -1 where its taps lie off the map
    auto src_block = [&](int x, int y) -> int {
      const float r = tr.at(x, y);
      if (!(r >= -tr.reach && r < fsize + tr.reach)) return -1;
      return min(max(__float2int_rd(__fmul_rn(r, inv_band)), 0), kCtas - 1);
    };
    auto load = [&](int sp) {
      const int owner = div_small(sp, band_pix, inv_band_pix);
      const T* rb =
          owner == rank ? band_buf : cluster.map_shared_rank(band_buf, owner);
      return *reinterpret_cast<const uint4*>(
          rb + (sp - owner * band_pix) * slab_ch + ch);
    };
    const bool along_x = cf[6] <= 0.5f;
    const float inner = along_x ? tr.a : tr.b;
    // the rows this block takes, widened past the fp32 rounding
    const float lo = (rank == 0 ? -tr.reach : (float)(rank * band)) - 0.01f;
    const float hi =
        (rank == kCtas - 1 ? fsize + tr.reach : (float)((rank + 1) * band)) +
        0.01f;
    // the lines of the walk (rows of the window along x', every column
    // under the swap) and, under the swap, the window's rows of a line
    const int o_lo = along_x ? row0 : 0, o_hi = along_x ? row0 + rows : size;
    const int i_lo = along_x ? 0 : row0, i_hi = along_x ? size : row0 + rows;
    for (int o = o_lo + warp; o < o_hi; o += nwarps) {
      const float base =
          __fadd_rn(__fmul_rn(along_x ? tr.b : tr.a, (float)o), tr.c0);
      float fa = 0.f, fb = fsize - 1.f;
      if (inner != 0.f) {
        const float e1 = (lo - base) / inner, e2 = (hi - base) / inner;
        fa = fmaxf(fa, floorf(fminf(e1, e2)) - 1.f);
        fb = fminf(fb, ceilf(fmaxf(e1, e2)) + 1.f);
      } else if (!(base >= lo && base < hi)) {
        fb = -1.f;
      }
      const int ia = max((int)fminf(fa, fsize), i_lo);
      const int ib = min((int)fmaxf(fb, -1.f), i_hi - 1);
      for (int i = ia + sub; i <= ib; i += ppw) {
        const int x = along_x ? i : o, y = along_x ? o : i;
        if (src_block(x, y) != rank) continue;
        const int pix = y * size + x;
        const WarpTaps plan = hm::plan_taps<T>(cf, x, y, size);
        *reinterpret_cast<uint4*>(dst + (pix - dst0) * c + ch) =
            hm::warp_vec16<T>(plan, load, pix);
      }
    }
    // the destination share's pixels whose taps lie off the map
    for (int pix = q_lo + warp * ppw + sub; pix < q_hi; pix += nwarps * ppw) {
      const int y = div_small(pix, size, inv_size);
      if (src_block(pix - y * size, y) < 0) {
        *reinterpret_cast<uint4*>(dst + (pix - dst0) * c + ch) =
            make_uint4(0u, 0u, 0u, 0u);  // +0: what the taps give
      }
    }
  }
  if (staged) cluster.sync();  // no block leaves while its band is read
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime (no link against
// libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// the widest slab of 64, 32 or 16 bytes that divides a pixel's channels
// and whose band fits kMaxStageBytes, in channels
template <typename T>
int slab_channels(int c, int size) {
  const int band_pix = size / kCtas * size;
  for (int bytes = 64; bytes >= 16; bytes /= 2) {
    const int ch = bytes / (int)sizeof(T);
    if (c % ch == 0 && band_pix * bytes + 8 + kAlign <= kMaxStageBytes) {
      return ch;
    }
  }
  return 0;
}

template <typename T>
int launch_resident(const void* src, const void* coef, const void* rtype,
                    void* out, int n_pairs_recv, int nj, int ty_count,
                    int n_recv, int size, int c, int row0, int rows,
                    cudaStream_t s) {
  const int slab_ch = slab_channels<T>(c, size);
  const int band = size / kCtas;
  const size_t staged = (size_t)band * size * slab_ch * sizeof(T);
  const size_t bytes = staged + 8 + kAlign;
  // the whole map (0, size) or a window of whole 32-row tiles
  const bool window = row0 != 0 || rows != size;
  if (slab_ch == 0 || size % kCtas != 0 || size > 256 ||
      row0 < 0 || rows <= 0 || row0 + rows > size ||
      (window && (row0 % hm::kRoiTile != 0 || rows % hm::kRoiTile != 0)) ||
      (long long)size * size * c >= (1ll << 31) ||
      c / slab_ch * kCtas > 65535 ||
      n_pairs_recv * nj > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int n_maps = n_pairs_recv / n_recv * ty_count * nj;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)size,
                              (cuuint64_t)size, (cuuint64_t)n_maps};
  const cuuint64_t strides[3] = {c * es, (cuuint64_t)size * c * es,
                                 (cuuint64_t)size * size * c * es};
  const cuuint32_t box[4] = {(cuuint32_t)slab_ch, (cuuint32_t)size,
                             (cuuint32_t)band, 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  CUtensorMap tmap;
  const CUresult enc = encode(
      &tmap,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(src), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (enc != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  auto kernel = pair_warp_resident_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas * (c / slab_ch), n_pairs_recv * nj, 1);
  cfg.blockDim = dim3(kResidentThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tmap, static_cast<const T*>(src),
                           static_cast<const float*>(coef),
                           static_cast<const int*>(rtype), static_cast<T*>(out),
                           nj, ty_count, n_recv, size, c, slab_ch, row0,
                           rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(const void* src, const void* coef, const void* rtype,
                void* out, int n_pairs_recv, int nj, int ty_count, int n_recv,
                int size, int c, int row0, int rows, cudaStream_t s) {
  const long long strips = (long long)((size + kTileW - 1) / kTileW) *
                           ((rows + kStripH - 1) / kStripH);
  const long long blocks = strips * n_pairs_recv * nj;
  // the source map and the window are indexed in 32 bits
  if ((long long)size * size * c >= (1ll << 31) || blocks >= (1ll << 31) ||
      row0 < 0 || rows <= 0 || row0 + rows > size) {
    return (int)cudaErrorInvalidValue;
  }
  pair_warp_kernel<T><<<(unsigned)blocks, kTileThreads, 0, s>>>(
      static_cast<const T*>(src), static_cast<const float*>(coef),
      static_cast<const int*>(rtype), static_cast<T*>(out), nj, ty_count,
      n_recv, size, c, row0, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_previous(const void* src, const void* coef, const void* rtype,
                    void* out, int n_pairs_recv, int nj, int ty_count,
                    int n_recv, int size, int c, int row0, int rows,
                    cudaStream_t s) {
  // the whole map only: the previous body is kept for timing
  if (row0 != 0 || rows != size) return (int)cudaErrorInvalidValue;
  const long long total =
      (long long)n_pairs_recv * nj * size * size * (c >> 3);
  const int threads = 256;
  pair_warp_previous_kernel<T>
      <<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
          static_cast<const T*>(src), static_cast<const float*>(coef),
          static_cast<const int*>(rtype), static_cast<T*>(out), n_pairs_recv,
          nj, ty_count, n_recv, size, c);
  return (int)cudaGetLastError();
}

typedef int (*Launch)(const void*, const void*, const void*, void*, int, int,
                      int, int, int, int, int, int, cudaStream_t);

int dispatch(Launch f32, Launch bf16, const void* src, const void* coef,
             const void* rtype, void* out, int dtype, int n_pairs_recv,
             int nj, int ty_count, int n_recv, int size, int size_w, int c,
             int row0, int rows, void* stream) {
  if (size != size_w || (c & 7) != 0 || n_recv <= 0 ||
      n_pairs_recv % n_recv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)n_pairs_recv * nj * size * c == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return f32(src, coef, rtype, out, n_pairs_recv, nj, ty_count, n_recv,
               size, c, row0, rows, s);
  }
  if (dtype == 1) {
    return bf16(src, coef, rtype, out, n_pairs_recv, nj, ty_count, n_recv,
                size, c, row0, rows, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// src (B, TY, J, S, S, C); coef (N, J, 8) f32; rtype (N,) i32;
// out (N, J, rows, S, C) with N = B * n_recv: the destination rows
// [row0, row0 + rows) (the whole map: 0, S; the SP island's shard: its
// window of whole 32-row tiles).  dtype 0 = f32, 1 = bf16.
extern "C" int hm_pair_warp(const void* src, const void* coef,
                            const void* rtype, void* out, int dtype,
                            int n_pairs_recv, int nj, int ty_count,
                            int n_recv, int size, int size_w, int c, int row0,
                            int rows, void* stream) {
  return dispatch(launch_tile<float>, launch_tile<__nv_bfloat16>, src, coef,
                  rtype, out, dtype, n_pairs_recv, nj, ty_count, n_recv, size,
                  size_w, c, row0, rows, stream);
}

// The previous body of hm_pair_warp, for timing: the same arguments (the
// whole map only: row0 0, rows S) and the same output bits.
extern "C" int hm_pair_warp_previous(const void* src, const void* coef,
                                     const void* rtype, void* out, int dtype,
                                     int n_pairs_recv, int nj, int ty_count,
                                     int n_recv, int size, int size_w, int c,
                                     int row0, int rows, void* stream) {
  return dispatch(launch_previous<float>, launch_previous<__nv_bfloat16>, src,
                  coef, rtype, out, dtype, n_pairs_recv, nj, ty_count, n_recv,
                  size, size_w, c, row0, rows, stream);
}

// The resident variant: the same arguments and the same output bits
// (row0 and rows whole 32-row tiles).
// size % 8 == 0, size <= 256, and a band of size / 8 rows of a slab of
// at least 16 bytes a pixel (C % 8 == 0 in bf16, % 4 in fp32) fits
// kMaxStageBytes: band * size * slab + 136 <= 75776 bytes (size <= 192
// at 16 bytes).
extern "C" int hm_pair_warp_resident(const void* src, const void* coef,
                                     const void* rtype, void* out, int dtype,
                                     int n_pairs_recv, int nj, int ty_count,
                                     int n_recv, int size, int size_w, int c,
                                     int row0, int rows, void* stream) {
  return dispatch(launch_resident<float>, launch_resident<__nv_bfloat16>, src,
                  coef, rtype, out, dtype, n_pairs_recv, nj, ty_count, n_recv,
                  size, size_w, c, row0, rows, stream);
}
