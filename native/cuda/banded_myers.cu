// Banded batched Myers DP for NVIDIA Hopper, called from JAX through the
// XLA foreign function interface (astarpa_tpu/ops/cuda_banded.py).
//
// Semantics: bit for bit those of the jnp references in
// astarpa_tpu/ops/banded.py (banded_cost_block / banded_ck_block), for the
// shared bucket schedule (int32 (n_max,)) and per-pair schedules (uint8
// (n_max, B)).
//
// Layout: one team of NW warps aligns one pair.  Lane l of warp w holds the
// v planes of the K consecutive window words starting at (w*32 + l)*K in
// registers.  Per column the vertical chain through the window is a carry
// chain of one bit (hm; hp only feeds the next word's shifted-in bit), so
// each lane evaluates its K words for both possible incoming hm bits, the
// teams compose those 1-bit maps with a warp shuffle scan (and shared
// memory across warps), and then every lane runs its words once with its
// true carry.  A window slide moves every v word up one slot: a shuffle
// between lanes, shared memory between warps, and a fresh word at slot
// SW-1.  Words at slots >= SW (padding up to R = NW*32*K) only ever sit
// below the window and never feed a slot < SW.
//
// The window's profile words stay put in a shared-memory ring per team:
// profile row r lives at ring slot r mod R, stored at slot + slot/32 so
// that lanes reading rows K apart hit different banks.  A slide writes the
// one entering row over a row that has left the window.
//
// Register budget: each lane keeps 3*K words (vp, vm, eq).  Every instance
// is compiled for the largest team it may run (MAX_THREADS), so a launch
// never asks for more registers than the SM has; the host plan
// (cuda_banded.plan) keeps K < 32 within 8 warps and K = 32 within
// kMaxWarps, which bounds the band at kMaxWarps*32*32 words.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int W = 32;
constexpr int kTargetWarps = 8;
constexpr int kMaxWarps = 16;
constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// Threads per block an instance is compiled for: one team of up to
// kTargetWarps warps (or four one-warp teams) below K = 32; at K = 32 a
// team of up to kMaxWarps warps, which leaves 128 registers per lane.
#define MAX_THREADS(K) ((K) < 32 ? 32 * kTargetWarps : 32 * kMaxWarps)

// Words of one profile plane's ring of R rows (R a multiple of 32).
__host__ __device__ constexpr int ring_words(int R) { return R + R / 32; }

__device__ __forceinline__ int ring_at(int slot) { return slot + (slot >> 5); }

struct Params {
  const uint32_t* a0;
  const uint32_t* a1;
  const uint32_t* pb0;
  const uint32_t* pb1;
  const int32_t* n;
  const int32_t* m;
  const int32_t* shift;   // shared schedule (n_max,) or null
  const uint8_t* sched;   // per-pair schedule (n_max, B) or null
  int n_max, B, S, SW, CB, NW, PPB;
  int32_t* cost;
  uint32_t* ckvp;  // (n_ck, SW, B) or null
  uint32_t* ckvm;
  int32_t* cktv;   // (n_ck, B)
};

// Apply a 1-bit map f (bit x of f is f(x)) to bit x.
__device__ __forceinline__ uint32_t app(uint32_t f, uint32_t x) {
  return (f >> x) & 1u;
}

// g after f.
__device__ __forceinline__ uint32_t compose(uint32_t g, uint32_t f) {
  return app(g, f & 1u) | (app(g, (f >> 1) & 1u) << 1);
}

__device__ __forceinline__ uint32_t hm_out(uint32_t eq, uint32_t vp,
                                           uint32_t hm) {
  uint32_t eq2 = eq | hm;
  uint32_t hx = (((eq2 & vp) + vp) ^ vp) | eq2;
  return (vp & hx) >> (W - 1);
}

__device__ __forceinline__ uint32_t hp_out(uint32_t eq, uint32_t vp,
                                           uint32_t vm, uint32_t hm) {
  uint32_t eq2 = eq | hm;
  uint32_t hx = (((eq2 & vp) + vp) ^ vp) | eq2;
  return (vm | ~(hx | vp)) >> (W - 1);
}

template <int K>
__global__ void __launch_bounds__(MAX_THREADS(K)) banded_kernel(Params p) {
  extern __shared__ uint32_t rings[];    // per team: pb0 ring, pb1 ring
  __shared__ uint32_t sx[kMaxWarps][2];  // vp/vm word 0 of each warp
  __shared__ uint32_t smap[2][kMaxWarps];
  __shared__ int32_t sred[kMaxWarps];

  const int team_threads = 32 * p.NW;
  const int team = threadIdx.x / team_threads;
  const int tid = threadIdx.x % team_threads;
  const int warp = tid / 32;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * p.PPB + team;
  if (pair >= p.B) return;  // whole team; PPB == 1 whenever NW > 1
  const bool owner = tid == 0;
  const bool multi = p.NW > 1;
  const int B = p.B, S = p.S, SW = p.SW;
  const int R = team_threads * K;
  const int base = tid * K;
  const int n = p.n[pair];
  const int m = p.m[pair];
  uint32_t* ring0 = rings + (size_t)team * 2 * ring_words(R);
  uint32_t* ring1 = ring0 + ring_words(R);
  // NW > 1 means one team per block.
  auto team_sync = [multi] {
    if (multi)
      __syncthreads();
    else
      __syncwarp();
  };

  for (int j = tid; j < R; j += team_threads) {
    size_t o = (size_t)min(j, S - 1) * B + pair;
    ring0[ring_at(j)] = p.pb0[o];
    ring1[ring_at(j)] = p.pb1[o];
  }
  uint32_t vp[K], vm[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    vp[s] = kFull;
    vm[s] = 0;
  }
  int lo = 0;
  int top = 0;      // ring slot of row lo
  int top_val = 0;  // meaningful in the owner lane
  // Pairs with n == 0 (and pairs past the last column) keep cost m.
  if (owner) p.cost[pair] = m;
  // The row entering at the next slide: profile row lo + SW (clamped).
  uint32_t ent0 = 0, ent1 = 0;
  if (owner) {
    ent0 = p.pb0[(size_t)min(lo + SW, S - 1) * B + pair];
    ent1 = p.pb1[(size_t)min(lo + SW, S - 1) * B + pair];
  }
  team_sync();

  // Per-column inputs arrive 32 columns at a time, lane t holding column
  // i0 + t; the next chunk is loaded one chunk ahead.
  auto load_chunk = [&](int i0, uint32_t& c0, uint32_t& c1, uint32_t& cs) {
    int i = i0 + lane;
    if (i < p.n_max) {
      c0 = p.a0[(size_t)i * B + pair];
      c1 = p.a1[(size_t)i * B + pair];
      cs = p.sched ? (uint32_t)p.sched[(size_t)i * B + pair]
                   : (uint32_t)p.shift[i];
    } else {
      c0 = c1 = cs = 0;
    }
  };
  uint32_t cur0, cur1, curs, nxt0, nxt1, nxts;
  load_chunk(0, nxt0, nxt1, nxts);

  const int n_end = p.ckvp ? p.n_max : min(n, p.n_max);
  for (int i = 0; i < n_end; ++i) {
    const int t = i & 31;
    if (t == 0) {
      cur0 = nxt0;
      cur1 = nxt1;
      curs = nxts;
      load_chunk(i + 32, nxt0, nxt1, nxts);
    }
    const uint32_t ca0 = __shfl_sync(kFull, cur0, t);
    const uint32_t ca1 = __shfl_sync(kFull, cur1, t);
    const bool do_shift = __shfl_sync(kFull, curs, t) != 0;

    // --- checkpoint: the state entering column i.
    if (p.ckvp && i % p.CB == 0) {
      const int k = i / p.CB;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        int j = base + s;
        if (j < SW) {
          size_t o = ((size_t)k * SW + j) * B + pair;
          p.ckvp[o] = vp[s];
          p.ckvm[o] = vm[s];
        }
      }
      if (owner) p.cktv[(size_t)k * B + pair] = top_val;
    }

    // --- slide the window one word down.
    if (do_shift) {
      if (owner) top_val += __popc(vp[0]) - __popc(vm[0]);
      uint32_t nb_vp = __shfl_down_sync(kFull, vp[0], 1);
      uint32_t nb_vm = __shfl_down_sync(kFull, vm[0], 1);
      if (multi && lane == 0) {
        sx[warp][0] = vp[0];
        sx[warp][1] = vm[0];
      }
      // Also: every lane is done reading the ring for column i - 1.
      team_sync();
      if (multi && lane == 31 && warp + 1 < p.NW) {
        nb_vp = sx[warp + 1][0];
        nb_vm = sx[warp + 1][1];
      }
      // Row lo + SW enters at window slot SW - 1.  Its ring slot held row
      // lo + SW - R <= lo, which is out of the window after this slide.
      if (owner) {
        int r = top + SW;
        if (r >= R) r -= R;
        ring0[ring_at(r)] = ent0;
        ring1[ring_at(r)] = ent1;
      }
      team_sync();
#pragma unroll
      for (int s = 0; s + 1 < K; ++s) {
        vp[s] = vp[s + 1];
        vm[s] = vm[s + 1];
      }
      vp[K - 1] = nb_vp;
      vm[K - 1] = nb_vm;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (base + s >= SW - 1) {
          vp[s] = kFull;
          vm[s] = 0;
        }
      }
      ++lo;
      if (++top == R) top = 0;
      if (owner) {
        ent0 = p.pb0[(size_t)min(lo + SW, S - 1) * B + pair];
        ent1 = p.pb1[(size_t)min(lo + SW, S - 1) * B + pair];
      }
    }

    if (i >= n) continue;  // finished pair: the window only slides

    // --- one banded column.  Pass 1: this lane's carry map.
    int slot0 = top + base;  // ring slot of this lane's first row
    if (slot0 >= R) slot0 -= R;
    uint32_t eq[K];
    uint32_t h0 = 0, h1 = 1, hp0 = 0, hp1 = 0;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      int r = slot0 + s;
      if (r >= R) r -= R;
      eq[s] = (ca0 ^ ring0[ring_at(r)]) & (ca1 ^ ring1[ring_at(r)]);
      if (s == K - 1) {
        hp0 = hp_out(eq[s], vp[s], vm[s], h0);
        hp1 = hp_out(eq[s], vp[s], vm[s], h1);
      }
      h0 = hm_out(eq[s], vp[s], h0);
      h1 = hm_out(eq[s], vp[s], h1);
    }
    const uint32_t fmap = h0 | (h1 << 1);  // hm in -> hm out
    const uint32_t hpmap = hp0 | (hp1 << 1);  // hm in -> hp out
    uint32_t g = fmap;  // inclusive scan: lanes 0..lane of this warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      uint32_t o = __shfl_up_sync(kFull, g, d);
      if (lane >= d) g = compose(g, o);
    }
    uint32_t excl = __shfl_up_sync(kFull, g, 1);
    if (lane == 0) excl = 2u;  // identity
    uint32_t hm_w = 0, hp_w = 1;  // carry into this warp's lane 0
    if (multi) {
      const int par = i & 1;
      if (lane == 31) smap[par][warp] = g | (excl << 2) | (hpmap << 4);
      __syncthreads();
      for (int v = 0; v < warp; ++v) {
        uint32_t e = smap[par][v];
        hp_w = app(e >> 4, app(e >> 2, hm_w));
        hm_w = app(e, hm_w);
      }
    }
    const uint32_t hm_in = app(excl, hm_w);
    uint32_t hp_in = __shfl_up_sync(kFull, app(hpmap, hm_in), 1);
    if (lane == 0) hp_in = hp_w;

    // Pass 2: the words with their true carries.
    uint32_t hp = hp_in, hm = hm_in;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      uint32_t vx = eq[s] | vm[s];
      uint32_t eq2 = eq[s] | hm;
      uint32_t hx = (((eq2 & vp[s]) + vp[s]) ^ vp[s]) | eq2;
      uint32_t hpo = vm[s] | ~(hx | vp[s]);
      uint32_t hmo = vp[s] & hx;
      uint32_t hpn = hpo >> (W - 1);
      uint32_t hmn = hmo >> (W - 1);
      hpo = (hpo << 1) | hp;
      hmo = (hmo << 1) | hm;
      vp[s] = hmo | ~(vx | hpo);
      vm[s] = hpo & vx;
      hp = hpn;
      hm = hmn;
    }
    if (owner) ++top_val;

    // --- the pair's last column: value at row m of the window.
    if (i == n - 1) {
      const int rows = m - lo * W;
      int val = 0;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        int j = base + s;
        int full = min(max(rows - j * W, 0), W);
        if (j < SW && full > 0) {
          uint32_t mask = full >= W ? kFull : ((1u << full) - 1u);
          val += __popc(vp[s] & mask) - __popc(vm[s] & mask);
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) val += __shfl_xor_sync(kFull, val, d);
      if (multi) {
        if (lane == 0) sred[warp] = val;
        __syncthreads();
        if (owner)
          for (int v = 1; v < p.NW; ++v) val += sred[v];
      }
      if (owner) p.cost[pair] = rows <= SW * W ? top_val + val : kInf;
    }
  }
}

template <int K>
ffi::Error launch(cudaStream_t stream, const Params& p) {
  const int threads = 32 * p.NW * p.PPB;
  if (threads > MAX_THREADS(K))
    return ffi::Error::InvalidArgument(
        "banded_myers: team too large for its words per lane");
  const int blocks = (p.B + p.PPB - 1) / p.PPB;
  const size_t smem =
      sizeof(uint32_t) * 2 * p.PPB * (size_t)ring_words(32 * p.NW * K);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(banded_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess) {
    banded_kernel<K><<<blocks, threads, smem, stream>>>(p);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error run(cudaStream_t stream, ffi::Buffer<ffi::U32> a0,
               ffi::Buffer<ffi::U32> a1, ffi::Buffer<ffi::U32> pb0,
               ffi::Buffer<ffi::U32> pb1, ffi::Buffer<ffi::S32> n,
               ffi::Buffer<ffi::S32> m, ffi::AnyBuffer sched, int64_t sw,
               int64_t k, int64_t nw, int64_t cb, int32_t* cost,
               uint32_t* ckvp, uint32_t* ckvm, int32_t* cktv) {
  auto ad = a0.dimensions();
  auto pd = pb0.dimensions();
  if (ad.size() != 2 || pd.size() != 2 || ad[1] != pd[1])
    return ffi::Error::InvalidArgument("banded_myers: bad plane shapes");
  Params p;
  p.n_max = (int)ad[0];
  p.B = (int)ad[1];
  p.S = (int)pd[0];
  p.SW = (int)sw;
  p.CB = (int)cb;
  p.NW = (int)nw;
  p.PPB = nw == 1 ? 4 : 1;
  if (p.SW < 1 || p.SW > p.S || p.NW < 1 || p.NW > kMaxWarps ||
      (int64_t)p.NW * 32 * k < p.SW)
    return ffi::Error::InvalidArgument("banded_myers: bad band plan");
  auto sdims = sched.dimensions();
  p.shift = nullptr;
  p.sched = nullptr;
  if (sched.element_type() == ffi::DataType::S32 && sdims.size() == 1 &&
      sdims[0] == p.n_max) {
    p.shift = reinterpret_cast<const int32_t*>(sched.untyped_data());
  } else if (sched.element_type() == ffi::DataType::U8 && sdims.size() == 2 &&
             sdims[0] == p.n_max && sdims[1] == p.B) {
    p.sched = reinterpret_cast<const uint8_t*>(sched.untyped_data());
  } else {
    return ffi::Error::InvalidArgument("banded_myers: bad schedule");
  }
  p.a0 = a0.typed_data();
  p.a1 = a1.typed_data();
  p.pb0 = pb0.typed_data();
  p.pb1 = pb1.typed_data();
  p.n = n.typed_data();
  p.m = m.typed_data();
  p.cost = cost;
  p.ckvp = ckvp;
  p.ckvm = ckvm;
  p.cktv = cktv;
  switch (k) {
    case 1: return launch<1>(stream, p);
    case 2: return launch<2>(stream, p);
    case 4: return launch<4>(stream, p);
    case 8: return launch<8>(stream, p);
    case 16: return launch<16>(stream, p);
    case 32: return launch<32>(stream, p);
    default:
      return ffi::Error::InvalidArgument("banded_myers: bad words per lane");
  }
}

ffi::Error CostImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> a0,
                    ffi::Buffer<ffi::U32> a1, ffi::Buffer<ffi::U32> pb0,
                    ffi::Buffer<ffi::U32> pb1, ffi::Buffer<ffi::S32> n,
                    ffi::Buffer<ffi::S32> m, ffi::AnyBuffer sched, int64_t sw,
                    int64_t k, int64_t nw,
                    ffi::ResultBuffer<ffi::S32> cost) {
  return run(stream, a0, a1, pb0, pb1, n, m, sched, sw, k, nw, 1,
             cost->typed_data(), nullptr, nullptr, nullptr);
}

ffi::Error CkImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> a0,
                  ffi::Buffer<ffi::U32> a1, ffi::Buffer<ffi::U32> pb0,
                  ffi::Buffer<ffi::U32> pb1, ffi::Buffer<ffi::S32> n,
                  ffi::Buffer<ffi::S32> m, ffi::AnyBuffer sched, int64_t sw,
                  int64_t k, int64_t nw, int64_t cb,
                  ffi::ResultBuffer<ffi::S32> cost,
                  ffi::ResultBuffer<ffi::U32> ckvp,
                  ffi::ResultBuffer<ffi::U32> ckvm,
                  ffi::ResultBuffer<ffi::S32> cktv) {
  if (cb < 1) return ffi::Error::InvalidArgument("banded_myers: bad cb");
  return run(stream, a0, a1, pb0, pb1, n, m, sched, sw, k, nw, cb,
             cost->typed_data(), ckvp->typed_data(), ckvm->typed_data(),
             cktv->typed_data());
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    AstarpaBandedCost, CostImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::AnyBuffer>()
        .Attr<int64_t>("sw")
        .Attr<int64_t>("k")
        .Attr<int64_t>("nw")
        .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    AstarpaBandedCk, CkImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::AnyBuffer>()
        .Attr<int64_t>("sw")
        .Attr<int64_t>("k")
        .Attr<int64_t>("nw")
        .Attr<int64_t>("cb")
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::S32>>());
