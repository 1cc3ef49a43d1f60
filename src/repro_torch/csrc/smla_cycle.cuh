// SMLA cycle engine: one cell's whole chunked simulation, run by one warp
// (32 lanes), written once against a small warp interface so that the
// same code runs in the CUDA kernel (smla_engine.cu, nvcc for sm_90a,
// `DeviceWarp`: the warp intrinsics) and in a g++ host build
// (smla_host.cpp, `HostWarp`: 32 lanes emulated one after another) that
// the CPU tests hold against the plain PyTorch version.
//
// Replaces: repro/core/smla/pallas_engine.py::sim_cell_blocks (the Pallas
// kernel that runs engine._sim_core over blocks of cells).  It computes
// what that kernel's body computes, cell by cell: the seven-stage
// per-cycle controller pipeline (refresh -> enqueue -> schedule ->
// transfer -> retire -> progress -> power) under the chunked early-exit
// loop, writing back only the final counters; the PyTorch wrapper
// (core/smla/cuda_engine.py) finishes the float metrics with the same
// function the plain version uses.
//
// Layout of the work.  A cell's cycles form a serial chain, so its
// latency is the kernel's time; the chain is cut by spreading each cycle's
// scans over the lanes.  Lanes own window slots (slot i belongs to lane
// i % 32, so a lane holds ceil(QT/32) of them) and, in refresh and power,
// ranks (lane r takes rank r; R <= 32).  Every scan over slots becomes one
// warp collective: per-rank bitmasks by an or-reduction of 1 << rank,
// counts by a sum (or a ballot and a popcount), the schedulers' arg-max by
// a max-reduction of the score and then a min-reduction of the slot index
// among the lanes that hold it (the lowest index wins, as jnp.argmax's
// first index does; a candidate is told by its score above -BIG), a
// segment's oldest instruction by a min-reduction of order-preserving
// integer keys (a minimum is exact in any order).  The whole state lives
// in the warp's slice of shared memory; the context row and the counters
// live in registers, equal in every lane.
//
// Who writes what: a lane writes only the slots and ranks it owns; a
// value every lane computed alike (the pick of an arg-max, a core's
// progress) is written by lane 0 (`leader`).  Each stage reads, then
// `sync`s the warp, then writes, then `sync`s again, so no lane reads a
// word another lane writes in the same phase; that is also what makes the
// sequential host emulation compute exactly what the warp computes.
//
// Bit-identity with the reference: every integer is int32_t as in JAX
// (the worst score is 1.875 * BIG < 2**31); the bus groups are granted in
// order g = 0, 1, ..., so the ECC cadence sees the earlier groups' grants
// of the same cycle (only groups holding a ready request are visited: the
// others grant nothing and count nothing); float32 c_inst keeps the
// reference's update order (build with --fmad=false).  C++ '/' and '%'
// truncate where JAX floors: every operand reaching them here is
// non-negative (t, ranks, banks, tags, the ECC grant counter), and the
// wrapper checks the inputs that feed them.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SMLA_HD __host__ __device__ inline
#else
#define SMLA_HD inline
#endif

namespace smla {

constexpr int32_t BIG = 1 << 30;
constexpr int32_t DEBT_CAP = 8;
constexpr int32_t OOO_ROW_BONUS = BIG >> 2;
constexpr int32_t OOO_DIR_BONUS = BIG >> 3;
constexpr float F_BIG = 1e30f;
constexpr int LANES = 32;

// Per-cell int32 context columns (engine._prepare's scalars, then the
// cell's chunk width and chunk count); the Python wrapper packs them in
// this order (cuda_engine.CTX_COLUMNS).
enum Ctx : int {
  CX_N_REQ, CX_T_RCD, CX_T_RP, CX_T_CL, CX_T_WR, CX_T_WTR, CX_T_PD, CX_T_SR,
  CX_T_XSR, CX_REFRESH_EN, CX_T_RFC_EFF, CX_L, CX_SLOTTED, CX_ECC_EVERY,
  CX_N_RANKS, CX_FCFS, CX_CLOSED_PAGE, CX_PER_BANK, CX_DRAIN_FULL,
  CX_DRAIN_OPP, CX_SR, CX_POSTPONE, CX_OOO_ROW, CX_OOO_DIR, CX_CHUNK,
  CX_K_MAX, CX_COUNT
};
// Per-rank int32 rows (cuda_engine.RANK_ROWS).
enum RankRow : int { RK_T_REFI_EFF, RK_DUR, RK_GROUP, RK_REF_NEXT0, RK_COUNT };
// Trace int32 fields (cuda_engine.TRACE_FIELDS); inst travels as float32.
enum Trace : int { TR_RANK, TR_BANK, TR_ROW, TR_WR, TR_COUNT };
// Per-cell int32 outputs (engine.SUMMARY_INT).
enum Out : int {
  OUT_N_ACT, OUT_N_CONFLICT, OUT_N_ROW_HIT, OUT_BUS_CYCLES, OUT_WR_BUS_CYCLES,
  OUT_N_WR, OUT_REFRESH_CYCLES, OUT_REF_RANK_BLOCKED, OUT_REF_POSTPONED,
  OUT_REF_PULLED_IN, OUT_REF_DEBT_MAX, OUT_REF_DEBT_END, OUT_PD_CYCLES,
  OUT_SR_CYCLES, OUT_N_SR_EXIT, OUT_N_DRAIN_BURSTS, OUT_N_GRANTS,
  OUT_N_SLOT_GRANTS, OUT_N_ECC_REREAD, OUT_WTR_STALL, OUT_N_OOO_RETIRE,
  OUT_N_ENQUEUED, OUT_N_OUTSTANDING, OUT_CHUNKS_RUN, OUT_COUNT
};
// Launch dimensions (cuda_engine.DIM_FIELDS).
enum Dim : int {
  D_N, D_C, D_M, D_R, D_B, D_WD, D_HORIZON, D_MSHR_WINDOW, D_Q_SIZE, D_WQ_HI,
  D_WQ_LO, D_COUNT
};

struct Dims {
  int32_t v[D_COUNT];
  float inst_window;
  float inst_per_cycle;
};

// Device buffers, every one indexed by cell first (cell-major).
struct Buffers {
  const int32_t* ctx;    // (N, CX_COUNT)
  const int32_t* rank;   // (N, RK_COUNT, R)
  const float* inst;     // (N, C, M)
  const int32_t* tr;     // (N, TR_COUNT, C, M)
  int32_t* out_i;        // (N, OUT_COUNT)
  int32_t* out_core;     // (N, 2, C): served, c_finish
  float* out_f;          // (N, C): c_inst
};

inline Dims make_dims(const int32_t* dims, const float* fdims) {
  Dims d;
  for (int i = 0; i < D_COUNT; ++i) d.v[i] = dims[i];
  d.inst_window = fdims[0];
  d.inst_per_cycle = fdims[1];
  return d;
}

// ---- the warp interface -------------------------------------------------
// `each(f)` runs f(lane) for the calling lane (the host: for every lane in
// turn); the collectives take f(lane), the lane's contribution.  `Lanes<T>`
// is a value per lane: a register on the card, an array on the host.

#ifdef __CUDACC__
struct DeviceWarp {
  static constexpr unsigned FULL = 0xffffffffu;
  template <typename T>
  struct Lanes {
    T v;
    SMLA_HD T& operator[](int) { return v; }
  };
  int lane;
  SMLA_HD bool leader() const { return lane == 0; }
  SMLA_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  template <class F>
  SMLA_HD void each(F f) const { f(lane); }
  template <class F>
  SMLA_HD uint32_t ballot(F f) const {
#ifdef __CUDA_ARCH__
    return __ballot_sync(FULL, f(lane));
#else
    return 0;
#endif
  }
  template <class F>
  SMLA_HD uint32_t any_bits(F f) const {
#ifdef __CUDA_ARCH__
    return __reduce_or_sync(FULL, static_cast<unsigned>(f(lane)));
#else
    return 0;
#endif
  }
  template <class F>
  SMLA_HD int32_t sum(F f) const {
#ifdef __CUDA_ARCH__
    return __reduce_add_sync(FULL, static_cast<int>(f(lane)));
#else
    return 0;
#endif
  }
  template <class F>
  SMLA_HD int32_t max(F f) const {
#ifdef __CUDA_ARCH__
    return __reduce_max_sync(FULL, static_cast<int>(f(lane)));
#else
    return 0;
#endif
  }
  template <class F>
  SMLA_HD int32_t min(F f) const {
#ifdef __CUDA_ARCH__
    return __reduce_min_sync(FULL, static_cast<int>(f(lane)));
#else
    return 0;
#endif
  }
  //! the smallest float, by one integer min-reduction of keys whose
  //! signed order is the floats' order (negative floats' magnitude bits
  //! flipped); exact for every float but NaN
  template <class F>
  SMLA_HD float fmin(F f) const {
#ifdef __CUDA_ARCH__
    int key = __float_as_int(f(lane));
    key ^= (key >> 31) & 0x7fffffff;
    key = __reduce_min_sync(FULL, key);
    return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
#else
    return 0.0f;
#endif
  }
  static SMLA_HD int first_set(uint32_t m) {
#ifdef __CUDA_ARCH__
    return __ffs(m) - 1;
#else
    return 0;
#endif
  }
  static SMLA_HD int popc(uint32_t m) {
#ifdef __CUDA_ARCH__
    return __popc(m);
#else
    return 0;
#endif
  }
};
#endif

struct HostWarp {
  template <typename T>
  struct Lanes {
    T v[LANES];
    T& operator[](int l) { return v[l]; }
  };
  bool leader() const { return true; }
  void sync() const {}
  template <class F>
  void each(F f) const {
    for (int l = 0; l < LANES; ++l) f(l);
  }
  template <class F>
  uint32_t ballot(F f) const {
    uint32_t m = 0;
    for (int l = 0; l < LANES; ++l) m |= (f(l) ? 1u : 0u) << l;
    return m;
  }
  template <class F>
  uint32_t any_bits(F f) const {
    uint32_t m = 0;
    for (int l = 0; l < LANES; ++l) m |= static_cast<uint32_t>(f(l));
    return m;
  }
  template <class F>
  int32_t sum(F f) const {
    int32_t s = 0;
    for (int l = 0; l < LANES; ++l) s += static_cast<int32_t>(f(l));
    return s;
  }
  template <class F>
  int32_t max(F f) const {
    int32_t m = static_cast<int32_t>(f(0));
    for (int l = 1; l < LANES; ++l) {
      const int32_t v = static_cast<int32_t>(f(l));
      m = v > m ? v : m;
    }
    return m;
  }
  template <class F>
  int32_t min(F f) const {
    int32_t m = static_cast<int32_t>(f(0));
    for (int l = 1; l < LANES; ++l) {
      const int32_t v = static_cast<int32_t>(f(l));
      m = v < m ? v : m;
    }
    return m;
  }
  template <class F>
  float fmin(F f) const {
    float m = f(0);
    for (int l = 1; l < LANES; ++l) {
      const float v = f(l);
      m = v < m ? v : m;
    }
    return m;
  }
  static int first_set(uint32_t m) { return __builtin_ctz(m); }
  static int popc(uint32_t m) { return __builtin_popcount(m); }
};

// ---- one cell's state ----------------------------------------------------

// Window-slot fields (QT words each), per-rank fields (R each), per-bank
// fields (R*B each), per-core fields (C each) of the int32 state.
enum SlotField : int {
  S_V, S_TAG, S_R, S_B, S_ROW, S_ARR, S_PHASE, S_READY, S_DONE, S_WR, S_HIT,
  S_G, S_COUNT
};
enum RankField : int {
  R_REFI, R_DUR, R_GROUP, R_GRP_BUSY, R_GRP_WR_UNTIL, R_GRP_LAST_WR,
  R_REF_NEXT, R_REF_BANK, R_REF_DEBT, R_IN_SR, R_IDLE_SINCE, R_AUX_DUE,
  R_AUX_TARGET, R_COUNT
};
enum BankField : int { K_BUSY, K_ROW, K_REF_UNTIL, K_COUNT };
enum CoreField : int { C_NEXT, C_OUT, C_SERVED, C_FINISH, C_COUNT };

//! 32-bit words of one cell's state: the int32 fields above, then
//! float32 qinst (QT) and c_inst (C)
SMLA_HD int64_t cell_words(const Dims& d) {
  const int64_t QT = (int64_t)d.v[D_C] * d.v[D_WD], R = d.v[D_R];
  const int64_t C = d.v[D_C];
  return S_COUNT * QT + R_COUNT * R + K_COUNT * R * d.v[D_B] + C_COUNT * C +
         QT + C;
}

// A cell's view: its inputs in device memory, its state in `words` (the
// warp's slice of shared memory), its context row and the counters in
// registers (every index into them is a constant).
struct Cell {
  const float* inst;
  const int32_t* tr;
  int32_t cx[CX_COUNT];
  int32_t *slot, *rank, *bank, *core;
  float *qinst_, *c_inst_;
  int32_t cnt[OUT_COUNT];
  bool draining;
  int C, M, R, B, Wd, QT, NS;
  int32_t mshr_window, q_size, wq_hi, wq_lo;
  float inst_window, inst_per_cycle;

  SMLA_HD int32_t& s(int f, int i) { return slot[f * QT + i]; }
  SMLA_HD int32_t& r(int f, int i) { return rank[f * R + i]; }
  SMLA_HD int32_t& bk(int f, int rk, int b) { return bank[(f * R + rk) * B + b]; }
  SMLA_HD int32_t& c(int f, int i) { return core[f * C + i]; }
  SMLA_HD float& qinst(int i) { return qinst_[i]; }
  SMLA_HD float& c_inst(int i) { return c_inst_[i]; }
};

SMLA_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
SMLA_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

//! f(i) for each window slot lane `l` owns (i = l, l + 32, ... < QT)
template <class F>
SMLA_HD void own_slots(const Cell& k, int l, F f) {
  for (int i = l; i < k.QT; i += LANES) f(i);
}

template <class W>
SMLA_HD Cell bind(const W& w, const Dims& d, const Buffers& b, int64_t c,
                  int32_t* words) {
  Cell k;
  k.C = d.v[D_C];
  k.M = d.v[D_M];
  k.R = d.v[D_R];
  k.B = d.v[D_B];
  k.Wd = d.v[D_WD];
  k.QT = k.C * k.Wd;
  k.NS = (k.QT + LANES - 1) / LANES;
  k.mshr_window = d.v[D_MSHR_WINDOW];
  k.q_size = d.v[D_Q_SIZE];
  k.wq_hi = d.v[D_WQ_HI];
  k.wq_lo = d.v[D_WQ_LO];
  k.inst_window = d.inst_window;
  k.inst_per_cycle = d.inst_per_cycle;
  const int64_t CM = (int64_t)k.C * k.M;
  k.inst = b.inst + c * CM;
  k.tr = b.tr + c * TR_COUNT * CM;
  int32_t* p = words;
  k.slot = p; p += S_COUNT * k.QT;
  k.rank = p; p += R_COUNT * k.R;
  k.bank = p; p += K_COUNT * k.R * k.B;
  k.core = p; p += C_COUNT * k.C;
  k.qinst_ = reinterpret_cast<float*>(p);
  k.c_inst_ = k.qinst_ + k.QT;
  for (int i = 0; i < OUT_COUNT; ++i) k.cnt[i] = 0;
  k.draining = false;
  const int32_t* cx = b.ctx + c * CX_COUNT;
  for (int i = 0; i < CX_COUNT; ++i) k.cx[i] = cx[i];
  // every lane clears and loads a strided share of the state
  const int32_t* rk = b.rank + c * RK_COUNT * k.R;
  const int64_t n_words = cell_words(d);
  const int R = k.R, RB = k.R * k.B;
  w.each([&](int l) {
    for (int64_t i = l; i < n_words; i += LANES) words[i] = 0;
  });
  w.sync();
  w.each([&](int l) {
    for (int i = l; i < R; i += LANES) {
      k.r(R_REFI, i) = rk[RK_T_REFI_EFF * R + i];
      k.r(R_DUR, i) = rk[RK_DUR * R + i];
      k.r(R_GROUP, i) = rk[RK_GROUP * R + i];
      k.r(R_REF_NEXT, i) = rk[RK_REF_NEXT0 * R + i];
    }
    for (int i = l; i < RB; i += LANES) k.bank[K_ROW * RB + i] = -1;
  });
  w.sync();
  return k;
}

// ---- stages (engine._stage_* of the reference, in the same order) -------

SMLA_HD bool cas_candidate(Cell& k, int i, int32_t t) {
  // phase-1 entry, bank free, not draining for a due refresh, rank awake
  if (!k.s(S_V, i) || k.s(S_PHASE, i) != 1) return false;
  const int r = k.s(S_R, i), b = k.s(S_B, i);
  if (k.bk(K_BUSY, r, b) > t) return false;
  const bool ref_blk = k.r(R_AUX_DUE, r) &&
                       (!k.cx[CX_PER_BANK] || b == k.r(R_AUX_TARGET, r));
  return !ref_blk && !k.r(R_IN_SR, r);
}

template <class W>
SMLA_HD void stage_refresh(const W& w, Cell& k, int32_t t, bool work_left) {
  const int32_t(&cx)[CX_COUNT] = k.cx;
  const int R = k.R, B = k.B;
  const bool per_bank = cx[CX_PER_BANK], postpone_pol = cx[CX_POSTPONE];
  const bool held_wr = cx[CX_DRAIN_FULL] && !k.draining;
  const int32_t t_rfc_eff = cx[CX_T_RFC_EFF];
  // per-rank masks of the window: demand, in flight, in flight on the
  // rank's refresh target
  typename W::template Lanes<uint32_t> dem, fly, fly_tgt;
  w.each([&](int l) {
    uint32_t a = 0, f = 0, ft = 0;
    own_slots(k, l, [&](int i) {
      if (!k.s(S_V, i)) return;
      const int r = k.s(S_R, i);
      const uint32_t bit = 1u << r;
      if (k.s(S_PHASE, i) >= 1 && !(k.s(S_WR, i) && held_wr)) a |= bit;
      if (k.s(S_PHASE, i) >= 2) {
        f |= bit;
        if (k.s(S_B, i) == k.r(R_REF_BANK, r)) ft |= bit;
      }
    });
    dem[l] = a;
    fly[l] = f;
    fly_tgt[l] = ft;
  });
  const uint32_t demand_m = w.any_bits([&](int l) { return dem[l]; });
  const uint32_t fly_m = w.any_bits([&](int l) { return fly[l]; });
  const uint32_t tgt_m = w.any_bits([&](int l) { return fly_tgt[l]; });
  w.sync();
  // lane r takes rank r
  typename W::template Lanes<int32_t> ev, flags, debt_l;
  w.each([&](int r) {
    ev[r] = flags[r] = debt_l[r] = 0;
    if (r >= R) return;
    const int32_t t_refi_eff = k.r(R_REFI, r);
    const bool real = r < cx[CX_N_RANKS];
    const int32_t tgt = k.r(R_REF_BANK, r);
    const bool demand = (demand_m >> r) & 1u, in_flight = (fly_m >> r) & 1u;
    const bool in_flight_tgt = (tgt_m >> r) & 1u;
    int32_t debt = k.r(R_REF_DEBT, r), next = k.r(R_REF_NEXT, r);
    const bool in_sr = k.r(R_IN_SR, r);
    bool due = cx[CX_REFRESH_EN] && t >= next && real && !in_sr;
    const bool post = postpone_pol && due && demand && debt < DEBT_CAP;
    if (post) {
      debt += 1;
      next += t_refi_eff;
    }
    due = due && !post;
    bool bank_idle = true;
    for (int b = 0; b < B; ++b) bank_idle = bank_idle && k.bk(K_BUSY, r, b) <= t;
    const bool can_ab = bank_idle && !in_flight;
    const bool can_pb = k.bk(K_BUSY, r, tgt) <= t && !in_flight_tgt;
    const bool can_start = per_bank ? can_pb : can_ab;
    const bool start_sched = due && can_start;
    const bool pull = postpone_pol && debt > 0 && !demand && !due && can_start &&
                      !in_sr;
    const bool start = start_sched || pull;
    if (pull) debt -= 1;
    int32_t n_in_ref = 0;
    bool all_in_ref = true;
    for (int b = 0; b < B; ++b) {
      if (start && (!per_bank || b == tgt)) {
        k.bk(K_BUSY, r, b) = t + t_rfc_eff;
        k.bk(K_ROW, r, b) = -1;
        k.bk(K_REF_UNTIL, r, b) = t + t_rfc_eff;
      }
      const bool in_ref = k.bk(K_REF_UNTIL, r, b) > t;
      n_in_ref += in_ref;
      all_in_ref = all_in_ref && in_ref;
    }
    if (start_sched) next += t_refi_eff;
    if (start && per_bank) k.r(R_REF_BANK, r) = (tgt + 1) % B;
    k.r(R_REF_DEBT, r) = debt;
    k.r(R_REF_NEXT, r) = next;
    k.r(R_AUX_DUE, r) = due;
    k.r(R_AUX_TARGET, r) = tgt;  // pre-increment round-robin target
    ev[r] = per_bank ? n_in_ref : (all_in_ref ? 1 : 0);
    flags[r] = (all_in_ref && real ? 1 : 0) | (post ? 1 << 8 : 0) |
               (pull ? 1 << 16 : 0);
    debt_l[r] = debt;
  });
  if (work_left) {
    k.cnt[OUT_REFRESH_CYCLES] += w.sum([&](int l) { return ev[l]; });
    const int32_t f = w.sum([&](int l) { return flags[l]; });
    k.cnt[OUT_REF_RANK_BLOCKED] += f & 0xff;
    k.cnt[OUT_REF_POSTPONED] += (f >> 8) & 0xff;
    k.cnt[OUT_REF_PULLED_IN] += f >> 16;
  }
  if (postpone_pol)  // without the policy every debt stays 0
    k.cnt[OUT_REF_DEBT_MAX] = imax(k.cnt[OUT_REF_DEBT_MAX],
                                   w.max([&](int l) { return debt_l[l]; }));
  w.sync();
}

template <class W>
SMLA_HD void stage_enqueue(const W& w, Cell& k, int32_t t) {
  const int cid = t % k.C;
  const int32_t n_req = k.cx[CX_N_REQ];
  const int32_t nxt = k.c(C_NEXT, cid);
  const int64_t ti = (int64_t)cid * k.M + imin(nxt, n_req - 1);
  const float inst = k.inst[ti];
  if (!(nxt < n_req && inst <= k.c_inst(cid) &&
        k.c(C_OUT, cid) < k.mshr_window))
    return;
  int32_t occ = 0;
  for (int j = 0; j < k.NS; ++j)
    occ += W::popc(w.ballot([&](int l) {
      const int i = l + LANES * j;
      return i < k.QT && k.s(S_V, i) != 0;
    }));
  if (occ >= k.q_size) return;
  // the first free slot of the core's segment
  const int lo = cid * k.Wd, hi = lo + k.Wd;
  int slot = -1;
  for (int j = lo / LANES; j <= (hi - 1) / LANES && slot < 0; ++j) {
    const uint32_t m = w.ballot([&](int l) {
      const int i = l + LANES * j;
      return i >= lo && i < hi && !k.s(S_V, i);
    });
    if (m) slot = LANES * j + W::first_set(m);
  }
  if (slot < 0) return;
  w.sync();
  if (w.leader()) {
    const int64_t CM = (int64_t)k.C * k.M;
    const int32_t r = k.tr[TR_RANK * CM + ti];
    k.s(S_V, slot) = 1;
    k.s(S_TAG, slot) = nxt;
    k.s(S_R, slot) = r;
    k.s(S_B, slot) = k.tr[TR_BANK * CM + ti];
    k.s(S_ROW, slot) = k.tr[TR_ROW * CM + ti];
    k.s(S_G, slot) = k.r(R_GROUP, r);
    k.qinst(slot) = inst;
    k.s(S_ARR, slot) = t;
    k.s(S_PHASE, slot) = 1;
    k.s(S_WR, slot) = k.tr[TR_WR * CM + ti] != 0;
    k.s(S_HIT, slot) = 0;
    k.c(C_NEXT, cid) = nxt + 1;
    k.c(C_OUT, cid) += 1;
  }
  w.sync();
}

struct Pick {
  int32_t top;  // the largest score
  int slot;     // the lowest slot holding it
};

//! the slot of the largest score, the lowest index among equals (the
//! reference's first-index arg-max); `score(i)` for every slot
template <class W, class F>
SMLA_HD Pick argmax_slot(const W& w, Cell& k, F score) {
  typename W::template Lanes<int32_t> best, at;
  w.each([&](int l) {
    int32_t b = INT32_MIN, a = INT32_MAX;
    own_slots(k, l, [&](int i) {
      const int32_t s = score(i);
      if (a == INT32_MAX || s > b) {
        b = s;
        a = i;
      }
    });
    best[l] = b;
    at[l] = a;
  });
  const int32_t top = w.max([&](int l) { return best[l]; });
  return Pick{top, w.min([&](int l) {
                return best[l] == top ? at[l] : INT32_MAX;
              })};
}


template <class W>
SMLA_HD void stage_schedule(const W& w, Cell& k, int32_t t, bool work_left) {
  const int32_t(&cx)[CX_COUNT] = k.cx;
  const int32_t wq = w.sum([&](int l) {
    int32_t occ = 0, wait = 0;
    own_slots(k, l, [&](int i) {
      if (k.s(S_V, i) && k.s(S_WR, i)) {
        ++occ;
        if (k.s(S_PHASE, i) == 1) ++wait;
      }
    });
    return occ | wait << 16;
  });
  const int32_t n_wq_occ = wq & 0xffff, n_wq_wait = wq >> 16;
  const bool any_read = w.ballot([&](int l) {
    bool any = false;
    own_slots(k, l, [&](int i) {
      any = any || (!k.s(S_WR, i) && cas_candidate(k, i, t));
    });
    return any;
  }) != 0;
  const bool was_draining = k.draining;
  const bool draining = n_wq_occ >= k.wq_hi   ? true
                        : n_wq_occ <= k.wq_lo ? false
                                              : was_draining;
  if (work_left && draining && !was_draining) k.cnt[OUT_N_DRAIN_BURSTS] += 1;
  k.draining = draining;
  const bool wr_ok = cx[CX_DRAIN_FULL]  ? (draining || !any_read)
                     : cx[CX_DRAIN_OPP] ? (n_wq_wait >= k.wq_lo || !any_read)
                                        : true;
  // a candidate scores above -BIG (its arrival is before the horizon,
  // and the wrapper holds the horizon below BIG), any other slot -BIG: so
  // the arg-max's slot is a candidate exactly when its score is above -BIG
  const Pick best = argmax_slot(w, k, [&](int i) -> int32_t {
    if (!cas_candidate(k, i, t) || (k.s(S_WR, i) && !wr_ok)) return -BIG;
    const bool wr = k.s(S_WR, i);
    const bool hit = k.bk(K_ROW, k.s(S_R, i), k.s(S_B, i)) == k.s(S_ROW, i);
    const bool drain_write = cx[CX_DRAIN_FULL] && draining && wr;
    const bool dir_match = wr == (k.r(R_GRP_LAST_WR, k.s(S_G, i)) != 0);
    int32_t bonus = drain_write ? BIG + (BIG >> 1)
                                : ((hit && !cx[CX_FCFS]) ? BIG : 0);
    bonus += (cx[CX_OOO_ROW] && hit ? OOO_ROW_BONUS : 0) +
             (cx[CX_OOO_DIR] && dir_match ? OOO_DIR_BONUS : 0);
    return bonus - k.s(S_ARR, i);
  });
  if (best.top == -BIG) return;
  const int pick = best.slot;
  const int r = k.s(S_R, pick), b = k.s(S_B, pick);
  const int32_t open = k.bk(K_ROW, r, b);
  const bool p_hit = open == k.s(S_ROW, pick), p_closed = open < 0;
  const int32_t t_cl = cx[CX_T_CL], t_rcd = cx[CX_T_RCD], t_rp = cx[CX_T_RP];
  const int32_t lat = p_hit ? t_cl : (p_closed ? t_rcd + t_cl : t_rp + t_rcd + t_cl);
  const int32_t ready = t + lat;
  const bool closed_page = cx[CX_CLOSED_PAGE];
  const int32_t row = k.s(S_ROW, pick);
  k.cnt[OUT_N_ACT] += !p_hit;
  k.cnt[OUT_N_ROW_HIT] += p_hit;
  k.cnt[OUT_N_CONFLICT] += !p_hit && !p_closed;
  w.sync();
  if (w.leader()) {
    k.bk(K_BUSY, r, b) = ready + (closed_page ? t_rp : 0);
    k.bk(K_ROW, r, b) = closed_page ? -1 : row;
    k.s(S_PHASE, pick) = 2;
    k.s(S_READY, pick) = ready;
    k.s(S_HIT, pick) = p_hit;
  }
  w.sync();
}

template <class W>
SMLA_HD void stage_transfer(const W& w, Cell& k, int32_t t, bool work_left) {
  const int32_t(&cx)[CX_COUNT] = k.cx;
  const int32_t L = cx[CX_L];
  const int32_t t_slot = t % L;
  const int32_t wr_extra = cx[CX_CLOSED_PAGE] ? cx[CX_T_RP] : 0;
  const int32_t ecc = cx[CX_ECC_EVERY];
  auto base3 = [&](int i) {
    const int r = k.s(S_R, i);
    return k.s(S_V, i) && k.s(S_PHASE, i) == 3 &&
           (!cx[CX_SLOTTED] || t_slot == r % L) &&
           k.bk(K_REF_UNTIL, r, k.s(S_B, i)) <= t;
  };
  // requests whose data is ready move to phase 3 (each lane its own
  // slots, which only it reads until the next sync); the bus groups
  // holding a ready request are granted in ascending order
  w.sync();
  uint32_t groups = w.any_bits([&](int l) {
    uint32_t m = 0;
    own_slots(k, l, [&](int i) {
      if (k.s(S_V, i) && k.s(S_PHASE, i) == 2 && k.s(S_READY, i) <= t)
        k.s(S_PHASE, i) = 3;
      if (base3(i)) m |= 1u << k.s(S_G, i);
    });
    return m;
  });
  while (groups) {
    const int g = W::first_set(groups);
    groups &= groups - 1;
    if (k.r(R_GRP_BUSY, g) > t) continue;  // bus busy: no grant, no stall
    const bool wtr_open = k.r(R_GRP_WR_UNTIL, g) <= t;
    const bool last_wr = k.r(R_GRP_LAST_WR, g);
    // as in schedule: the pick is a candidate exactly when it scores
    // above -BIG
    const Pick best = argmax_slot(w, k, [&](int i) -> int32_t {
      const bool wr = k.s(S_WR, i);
      if (!base3(i) || k.s(S_G, i) != g || !(wr || wtr_open)) return -BIG;
      return (cx[CX_OOO_ROW] && k.s(S_HIT, i) ? OOO_ROW_BONUS : 0) +
             (cx[CX_OOO_DIR] && wr == last_wr ? OOO_DIR_BONUS : 0) -
             k.s(S_ARR, i);
    });
    if (best.top == -BIG) {
      // bus free, a read held only by tWTR
      if (work_left && !wtr_open &&
          w.ballot([&](int l) {
            bool blocked = false;
            own_slots(k, l, [&](int i) {
              blocked = blocked ||
                        (base3(i) && k.s(S_G, i) == g && !k.s(S_WR, i));
            });
            return blocked;
          }))
        k.cnt[OUT_WTR_STALL] += 1;
      continue;
    }
    const int p3 = best.slot;
    const bool wr = k.s(S_WR, p3);
    const bool reread = !wr && k.cnt[OUT_N_GRANTS] % ecc == ecc - 1;
    const int r3 = k.s(S_R, p3), b3 = k.s(S_B, p3);
    const int32_t dur = k.r(R_DUR, r3);
    const int32_t d = dur + (reread ? dur : 0);
    k.cnt[OUT_N_ECC_REREAD] += reread;
    k.cnt[OUT_BUS_CYCLES] += d;
    k.cnt[OUT_N_GRANTS] += 1;
    k.cnt[OUT_N_SLOT_GRANTS] += t_slot == r3 % L;
    if (wr) k.cnt[OUT_WR_BUS_CYCLES] += d;
    w.sync();
    if (w.leader()) {
      k.r(R_GRP_BUSY, g) = t + d;
      k.s(S_PHASE, p3) = 4;
      k.s(S_DONE, p3) = t + d;
      k.r(R_GRP_LAST_WR, g) = wr;
      if (wr) {
        k.bk(K_BUSY, r3, b3) =
            imax(k.bk(K_BUSY, r3, b3), t + d + cx[CX_T_WR] + wr_extra);
        k.r(R_GRP_WR_UNTIL, g) = t + d + cx[CX_T_WTR];
      }
    }
    w.sync();
  }
}

template <class W>
SMLA_HD void stage_retire(const W& w, Cell& k, int32_t t) {
  auto fin = [&](int i) {
    return k.s(S_V, i) && k.s(S_PHASE, i) == 4 && k.s(S_DONE, i) <= t;
  };
  for (int c = 0; c < k.C; ++c) {
    const int lo = c * k.Wd, hi = lo + k.Wd;
    const int32_t nf = w.sum([&](int l) {
      int32_t n = 0, n_wr = 0;
      own_slots(k, l, [&](int i) {
        if (i >= lo && i < hi && fin(i)) {
          ++n;
          n_wr += k.s(S_WR, i) != 0;
        }
      });
      return n | n_wr << 16;
    });
    const int32_t n_fin = nf & 0xffff;
    if (n_fin == 0) continue;  // nothing retires: the core's state stands
    const int32_t min_rem = w.min([&](int l) {
      int32_t m = BIG;
      own_slots(k, l, [&](int i) {
        if (i >= lo && i < hi && k.s(S_V, i) && !fin(i))
          m = imin(m, k.s(S_TAG, i));
      });
      return m;
    });
    k.cnt[OUT_N_OOO_RETIRE] += w.sum([&](int l) {
      int32_t n = 0;
      own_slots(k, l, [&](int i) {
        if (i >= lo && i < hi && fin(i)) n += min_rem < k.s(S_TAG, i);
      });
      return n;
    });
    k.cnt[OUT_N_WR] += nf >> 16;
    w.sync();
    w.each([&](int l) {
      own_slots(k, l, [&](int i) {
        if (i >= lo && i < hi && fin(i)) {
          k.s(S_V, i) = 0;
          k.s(S_PHASE, i) = 0;
        }
      });
    });
    if (w.leader()) {
      k.c(C_SERVED, c) += n_fin;
      k.c(C_FINISH, c) = imax(k.c(C_FINISH, c), t);
      k.c(C_OUT, c) -= n_fin;
    }
    w.sync();
  }
}

template <class W>
SMLA_HD void stage_progress(const W& w, Cell& k) {
  const int32_t n_req = k.cx[CX_N_REQ];
  for (int c = 0; c < k.C; ++c) {
    const int lo = c * k.Wd, hi = lo + k.Wd;
    const float oldest = w.fmin([&](int l) {
      float m = F_BIG;
      own_slots(k, l, [&](int i) {
        if (i >= lo && i < hi && k.s(S_V, i) && k.qinst(i) < m) m = k.qinst(i);
      });
      return m;
    });
    const float ci = k.c_inst(c);
    const bool window_ok = (ci - oldest) < k.inst_window;
    const int32_t nx = k.c(C_NEXT, c);
    const float nxt_inst =
        nx < n_req ? k.inst[(int64_t)c * k.M + imin(nx, n_req - 1)] : F_BIG;
    const bool advance = window_ok && k.c(C_SERVED, c) < n_req;
    const float v = advance ? ci + k.inst_per_cycle : ci;
    w.sync();
    if (w.leader()) k.c_inst(c) = v < nxt_inst ? v : nxt_inst;
    w.sync();
  }
}

template <class W>
SMLA_HD void stage_power(const W& w, Cell& k, int32_t t, bool work_left) {
  const int32_t(&cx)[CX_COUNT] = k.cx;
  const int R = k.R, B = k.B;
  const uint32_t pend_m = w.any_bits([&](int l) {
    uint32_t m = 0;
    own_slots(k, l, [&](int i) {
      if (k.s(S_V, i)) m |= 1u << k.s(S_R, i);
    });
    return m;
  });
  w.sync();
  typename W::template Lanes<int32_t> flags;
  w.each([&](int r) {
    flags[r] = 0;
    if (r >= R) return;
    const bool pending = (pend_m >> r) & 1u;
    bool bank_idle = true;
    for (int b = 0; b < B; ++b) bank_idle = bank_idle && k.bk(K_BUSY, r, b) <= t;
    const bool rank_idle = bank_idle && !pending && r < cx[CX_N_RANKS];
    if (!rank_idle) k.r(R_IDLE_SINCE, r) = t + 1;
    const int32_t idle_for = t - k.r(R_IDLE_SINCE, r);
    const bool enter = cx[CX_SR] && rank_idle && idle_for >= cx[CX_T_SR] &&
                       k.r(R_REF_DEBT, r) == 0;
    const bool leave = k.r(R_IN_SR, r) && pending;
    const bool in_sr = (k.r(R_IN_SR, r) || enter) && !leave;
    if (leave) {
      for (int b = 0; b < B; ++b)
        k.bk(K_BUSY, r, b) = imax(k.bk(K_BUSY, r, b), t + cx[CX_T_XSR]);
      k.r(R_REF_NEXT, r) = t + cx[CX_T_XSR] + k.r(R_REFI, r);
    }
    k.r(R_IN_SR, r) = in_sr;
    flags[r] = (leave ? 1 : 0) | (in_sr ? 1 << 8 : 0) |
               (rank_idle && idle_for >= cx[CX_T_PD] && !in_sr ? 1 << 16 : 0);
  });
  w.sync();
  if (work_left) {
    const int32_t f = w.sum([&](int l) { return flags[l]; });
    k.cnt[OUT_N_SR_EXIT] += f & 0xff;
    k.cnt[OUT_SR_CYCLES] += (f >> 8) & 0xff;
    k.cnt[OUT_PD_CYCLES] += f >> 16;
  }
}

SMLA_HD bool work_left(Cell& k) {
  for (int c = 0; c < k.C; ++c)
    if (k.c(C_SERVED, c) < k.cx[CX_N_REQ]) return true;
  return false;
}

// The reference's loop_cond: work left, or a postponed refresh still owed.
SMLA_HD bool running(Cell& k) {
  if (work_left(k)) return true;
  for (int r = 0; r < k.R; ++r)
    if (k.r(R_REF_DEBT, r) > 0) return true;
  return false;
}

template <class W>
SMLA_HD void step(const W& w, Cell& k, int32_t t) {
  const bool wl = work_left(k);
  stage_refresh(w, k, t, wl);
  stage_enqueue(w, k, t);
  stage_schedule(w, k, t, wl);
  stage_transfer(w, k, t, wl);
  stage_retire(w, k, t);
  stage_progress(w, k);
  stage_power(w, k, t, wl);
}

// One cell start to finish, by one warp whose state is `words`
// (cell_words(d) of them): init, the chunked loop with early exit at the
// cell's chunk boundaries (cycles at or past the horizon are no-ops, so
// they are not run), then the summary counters.
template <class W>
SMLA_HD void sim_cell(const W& w, const Dims& d, const Buffers& b, int64_t c,
                      int32_t* words) {
  Cell k = bind(w, d, b, c, words);
  const int32_t chunk = k.cx[CX_CHUNK], k_max = k.cx[CX_K_MAX];
  const int32_t horizon = d.v[D_HORIZON];
  int32_t chunks = 0;
  while (chunks < k_max && running(k)) {
    const int32_t t0 = chunks * chunk;
    const int32_t t1 = imin(t0 + chunk, horizon);
    for (int32_t t = t0; t < t1; ++t) step(w, k, t);
    ++chunks;
  }
  int32_t debt = 0, enq = 0, outstanding = 0;
  for (int r = 0; r < k.R; ++r) debt += k.r(R_REF_DEBT, r);
  for (int cc = 0; cc < k.C; ++cc) enq += k.c(C_NEXT, cc);
  for (int j = 0; j < k.NS; ++j)
    outstanding += W::popc(w.ballot([&](int l) {
      const int i = l + LANES * j;
      return i < k.QT && k.s(S_V, i) != 0;
    }));
  k.cnt[OUT_REF_DEBT_END] = debt;
  k.cnt[OUT_N_ENQUEUED] = enq;
  k.cnt[OUT_N_OUTSTANDING] = outstanding;
  k.cnt[OUT_CHUNKS_RUN] = chunks;
  if (w.leader()) {
    int32_t* out = b.out_i + c * OUT_COUNT;
    for (int i = 0; i < OUT_COUNT; ++i) out[i] = k.cnt[i];
    int32_t* served = b.out_core + c * 2 * k.C;
    for (int cc = 0; cc < k.C; ++cc) {
      served[cc] = k.c(C_SERVED, cc);
      served[k.C + cc] = k.c(C_FINISH, cc);
      b.out_f[c * k.C + cc] = k.c_inst(cc);
    }
  }
}

}  // namespace smla
