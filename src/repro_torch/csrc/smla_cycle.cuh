// SMLA cycle engine: one cell's whole chunked simulation, written once as
// __host__ __device__ C++ so the same code runs in the CUDA kernel
// (smla_engine.cu, nvcc for sm_90a) and in a g++ host build that the CPU
// tests hold against the plain PyTorch version.
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
// Bit-identity with the reference: every integer is int32_t as in JAX
// (the worst score is 1.875 * BIG < 2**31); argmax/argmin loop in slot
// order with a strict '>' so the first index wins ties, as jnp.argmax
// does; the bus groups are visited in order g = 0..R-1, so the ECC
// cadence sees the earlier groups' grants of the same cycle; float32
// c_inst keeps the reference's update order (build with --fmad=false).
// C++ '/' and '%' truncate where JAX floors: every operand reaching them
// here is non-negative (t, ranks, banks, tags, the ECC grant counter), and
// the wrapper checks the inputs that feed them.
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

// Per-cell int32 context columns (engine._prepare's scalars); the Python
// wrapper packs them in this order (cuda_engine.CTX_COLUMNS).
enum Ctx : int {
  CX_N_REQ, CX_T_RCD, CX_T_RP, CX_T_CL, CX_T_WR, CX_T_WTR, CX_T_PD, CX_T_SR,
  CX_T_XSR, CX_REFRESH_EN, CX_T_RFC_EFF, CX_L, CX_SLOTTED, CX_ECC_EVERY,
  CX_N_RANKS, CX_FCFS, CX_CLOSED_PAGE, CX_PER_BANK, CX_DRAIN_FULL,
  CX_DRAIN_OPP, CX_SR, CX_POSTPONE, CX_OOO_ROW, CX_OOO_DIR, CX_COUNT
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
  D_N, D_C, D_M, D_R, D_B, D_WD, D_HORIZON, D_CHUNK, D_K_MAX, D_MSHR_WINDOW,
  D_Q_SIZE, D_WQ_HI, D_WQ_LO, D_COUNT
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
  int32_t* scratch_i;    // (N, scratch_i_words)
  float* scratch_f;      // (N, scratch_f_words)
  int32_t* out_i;        // (N, OUT_COUNT)
  int32_t* out_core;     // (N, 2, C): served, c_finish
  float* out_f;          // (N, C): c_inst
};

SMLA_HD int64_t scratch_i_words(const Dims& d) {
  const int64_t QT = (int64_t)d.v[D_C] * d.v[D_WD];
  const int64_t R = d.v[D_R], RB = R * d.v[D_B];
  // 11 window arrays, 3 bank matrices, 10 per-rank vectors, 2 per-core
  // vectors, the drain flag
  return 11 * QT + 3 * RB + 10 * R + 2 * (int64_t)d.v[D_C] + 1;
}

SMLA_HD int64_t scratch_f_words(const Dims& d) {
  return (int64_t)d.v[D_C] * d.v[D_WD];  // qinst
}

// One cell's view: inputs, state (in scratch) and outputs (the counters,
// served, c_finish and c_inst are state written in place).
struct Cell {
  const int32_t* cx;
  const int32_t* rk;
  const float* inst;
  const int32_t* tr;
  int32_t *qv, *qtag, *qr, *qb, *qrow, *qarr, *qphase, *qready, *qdone, *qwr,
      *whit;
  float* qinst;
  int32_t *bank_busy, *bank_row, *ref_until;
  int32_t *grp_busy, *grp_wr_until, *grp_last_wr, *ref_next, *ref_bank,
      *ref_debt, *in_sr, *idle_since, *aux_due, *aux_target;
  int32_t *c_next, *c_out, *draining;
  int32_t *served, *c_finish, *cnt;
  float* c_inst;
  int C, M, R, B, Wd, QT;
  int32_t mshr_window, q_size, wq_hi, wq_lo;
  float inst_window, inst_per_cycle;
};

SMLA_HD Cell bind(const Dims& d, const Buffers& b, int64_t c) {
  Cell k;
  k.C = d.v[D_C];
  k.M = d.v[D_M];
  k.R = d.v[D_R];
  k.B = d.v[D_B];
  k.Wd = d.v[D_WD];
  k.QT = k.C * k.Wd;
  k.mshr_window = d.v[D_MSHR_WINDOW];
  k.q_size = d.v[D_Q_SIZE];
  k.wq_hi = d.v[D_WQ_HI];
  k.wq_lo = d.v[D_WQ_LO];
  k.inst_window = d.inst_window;
  k.inst_per_cycle = d.inst_per_cycle;
  const int64_t CM = (int64_t)k.C * k.M;
  k.cx = b.ctx + c * CX_COUNT;
  k.rk = b.rank + c * RK_COUNT * k.R;
  k.inst = b.inst + c * CM;
  k.tr = b.tr + c * TR_COUNT * CM;
  // carve the cell's scratch (no address-of on `k`, so it can stay in
  // registers): 11 window arrays, 3 bank matrices, 10 per-rank vectors
  int32_t* s = b.scratch_i + c * scratch_i_words(d);
  const int QT = k.QT, RB = k.R * k.B, R = k.R;
  k.qv = s; s += QT;
  k.qtag = s; s += QT;
  k.qr = s; s += QT;
  k.qb = s; s += QT;
  k.qrow = s; s += QT;
  k.qarr = s; s += QT;
  k.qphase = s; s += QT;
  k.qready = s; s += QT;
  k.qdone = s; s += QT;
  k.qwr = s; s += QT;
  k.whit = s; s += QT;
  k.bank_busy = s; s += RB;
  k.bank_row = s; s += RB;
  k.ref_until = s; s += RB;
  k.grp_busy = s; s += R;
  k.grp_wr_until = s; s += R;
  k.grp_last_wr = s; s += R;
  k.ref_next = s; s += R;
  k.ref_bank = s; s += R;
  k.ref_debt = s; s += R;
  k.in_sr = s; s += R;
  k.idle_since = s; s += R;
  k.aux_due = s; s += R;
  k.aux_target = s; s += R;
  k.c_next = s; s += k.C;
  k.c_out = s; s += k.C;
  k.draining = s;
  k.qinst = b.scratch_f + c * scratch_f_words(d);
  k.cnt = b.out_i + c * OUT_COUNT;
  k.served = b.out_core + c * 2 * k.C;
  k.c_finish = k.served + k.C;
  k.c_inst = b.out_f + c * k.C;
  return k;
}

SMLA_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
SMLA_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

SMLA_HD void init_state(Cell& k) {
  for (int i = 0; i < k.QT; ++i) {
    k.qv[i] = k.qtag[i] = k.qr[i] = k.qb[i] = k.qrow[i] = 0;
    k.qarr[i] = k.qphase[i] = k.qready[i] = k.qdone[i] = 0;
    k.qwr[i] = k.whit[i] = 0;
    k.qinst[i] = 0.0f;
  }
  for (int i = 0; i < k.R * k.B; ++i) {
    k.bank_busy[i] = 0;
    k.bank_row[i] = -1;
    k.ref_until[i] = 0;
  }
  for (int r = 0; r < k.R; ++r) {
    k.grp_busy[r] = k.grp_wr_until[r] = k.grp_last_wr[r] = 0;
    k.ref_next[r] = k.rk[RK_REF_NEXT0 * k.R + r];
    k.ref_bank[r] = k.ref_debt[r] = k.in_sr[r] = k.idle_since[r] = 0;
    k.aux_due[r] = k.aux_target[r] = 0;
  }
  for (int c = 0; c < k.C; ++c) {
    k.c_next[c] = k.c_out[c] = k.served[c] = k.c_finish[c] = 0;
    k.c_inst[c] = 0.0f;
  }
  k.draining[0] = 0;
  for (int i = 0; i < OUT_COUNT; ++i) k.cnt[i] = 0;
}

// ---- stages (engine._stage_* of the reference, in the same order) -------

SMLA_HD void stage_refresh(Cell& k, int32_t t, bool work_left) {
  const int32_t* cx = k.cx;
  const int R = k.R, B = k.B;
  const bool per_bank = cx[CX_PER_BANK], postpone_pol = cx[CX_POSTPONE];
  const bool held_wr = cx[CX_DRAIN_FULL] && !k.draining[0];
  const int32_t t_rfc_eff = cx[CX_T_RFC_EFF];
  int32_t n_ref_ev = 0, blocked = 0, postponed = 0, pulled = 0;
  int32_t debt_max = k.cnt[OUT_REF_DEBT_MAX];
  for (int r = 0; r < R; ++r) {
    const int32_t t_refi_eff = k.rk[RK_T_REFI_EFF * R + r];
    const bool real = r < cx[CX_N_RANKS];
    const int32_t tgt = k.ref_bank[r];
    bool demand = false, in_flight = false, in_flight_tgt = false;
    for (int i = 0; i < k.QT; ++i) {
      if (!k.qv[i] || k.qr[i] != r) continue;
      if (k.qphase[i] >= 1 && !(k.qwr[i] && held_wr)) demand = true;
      if (k.qphase[i] >= 2) {
        in_flight = true;
        if (k.qb[i] == tgt) in_flight_tgt = true;
      }
    }
    int32_t debt = k.ref_debt[r], next = k.ref_next[r];
    bool due = cx[CX_REFRESH_EN] && t >= next && real && !k.in_sr[r];
    const bool post = postpone_pol && due && demand && debt < DEBT_CAP;
    if (post) {
      debt += 1;
      next += t_refi_eff;
    }
    due = due && !post;
    bool bank_idle = true;
    for (int b = 0; b < B; ++b) bank_idle = bank_idle && k.bank_busy[r * B + b] <= t;
    const bool can_ab = bank_idle && !in_flight;
    const bool can_pb = k.bank_busy[r * B + tgt] <= t && !in_flight_tgt;
    const bool can_start = per_bank ? can_pb : can_ab;
    const bool start_sched = due && can_start;
    const bool pull = postpone_pol && debt > 0 && !demand && !due && can_start &&
                      !k.in_sr[r];
    const bool start = start_sched || pull;
    if (pull) debt -= 1;
    int32_t n_in_ref = 0;
    bool all_in_ref = true;
    for (int b = 0; b < B; ++b) {
      const int rb = r * B + b;
      if (start && (!per_bank || b == tgt)) {
        k.bank_busy[rb] = t + t_rfc_eff;
        k.bank_row[rb] = -1;
        k.ref_until[rb] = t + t_rfc_eff;
      }
      const bool in_ref = k.ref_until[rb] > t;
      n_in_ref += in_ref;
      all_in_ref = all_in_ref && in_ref;
    }
    if (start_sched) next += t_refi_eff;
    if (start && per_bank) k.ref_bank[r] = (tgt + 1) % B;
    n_ref_ev += per_bank ? n_in_ref : (all_in_ref ? 1 : 0);
    blocked += all_in_ref && real;
    postponed += post;
    pulled += pull;
    debt_max = imax(debt_max, debt);
    k.ref_debt[r] = debt;
    k.ref_next[r] = next;
    k.aux_due[r] = due;
    k.aux_target[r] = tgt;  // pre-increment round-robin target
  }
  if (work_left) {
    k.cnt[OUT_REFRESH_CYCLES] += n_ref_ev;
    k.cnt[OUT_REF_RANK_BLOCKED] += blocked;
    k.cnt[OUT_REF_POSTPONED] += postponed;
    k.cnt[OUT_REF_PULLED_IN] += pulled;
  }
  k.cnt[OUT_REF_DEBT_MAX] = debt_max;
}

SMLA_HD void stage_enqueue(Cell& k, int32_t t) {
  const int cid = t % k.C;
  const int32_t n_req = k.cx[CX_N_REQ];
  const int32_t nxt = k.c_next[cid];
  const int64_t ti = (int64_t)cid * k.M + imin(nxt, n_req - 1);
  const float inst = k.inst[ti];
  int32_t occ = 0;
  for (int i = 0; i < k.QT; ++i) occ += k.qv[i] != 0;
  int slot = cid * k.Wd;  // argmin of the segment: its first free slot
  for (int j = 0; j < k.Wd; ++j) {
    if (!k.qv[cid * k.Wd + j]) {
      slot = cid * k.Wd + j;
      break;
    }
  }
  const bool do_enq = nxt < n_req && inst <= k.c_inst[cid] &&
                      k.c_out[cid] < k.mshr_window && occ < k.q_size &&
                      !k.qv[slot];
  if (!do_enq) return;
  const int64_t CM = (int64_t)k.C * k.M;
  k.qv[slot] = 1;
  k.qtag[slot] = nxt;
  k.qr[slot] = k.tr[TR_RANK * CM + ti];
  k.qb[slot] = k.tr[TR_BANK * CM + ti];
  k.qrow[slot] = k.tr[TR_ROW * CM + ti];
  k.qinst[slot] = inst;
  k.qarr[slot] = t;
  k.qphase[slot] = 1;
  k.qwr[slot] = k.tr[TR_WR * CM + ti] != 0;
  k.whit[slot] = 0;
  k.c_next[cid] += 1;
  k.c_out[cid] += 1;
}

SMLA_HD bool cas_candidate(const Cell& k, int i, int32_t t) {
  // phase-1 entry, bank free, not draining for a due refresh, rank awake
  if (!k.qv[i] || k.qphase[i] != 1) return false;
  const int r = k.qr[i];
  if (k.bank_busy[r * k.B + k.qb[i]] > t) return false;
  const bool ref_blk = k.aux_due[r] &&
                       (!k.cx[CX_PER_BANK] || k.qb[i] == k.aux_target[r]);
  return !ref_blk && !k.in_sr[r];
}

SMLA_HD void stage_schedule(Cell& k, int32_t t, bool work_left) {
  const int32_t* cx = k.cx;
  const int B = k.B;
  int32_t n_wq_wait = 0, n_wq_occ = 0;
  bool any_read = false;
  for (int i = 0; i < k.QT; ++i) {
    if (k.qv[i] && k.qwr[i]) {
      ++n_wq_occ;
      if (k.qphase[i] == 1) ++n_wq_wait;
    }
    if (!k.qwr[i] && cas_candidate(k, i, t)) any_read = true;
  }
  const bool was_draining = k.draining[0];
  const bool draining = n_wq_occ >= k.wq_hi   ? true
                        : n_wq_occ <= k.wq_lo ? false
                                              : was_draining;
  if (work_left && draining && !was_draining) k.cnt[OUT_N_DRAIN_BURSTS] += 1;
  k.draining[0] = draining;
  const bool wr_ok = cx[CX_DRAIN_FULL]  ? (draining || !any_read)
                     : cx[CX_DRAIN_OPP] ? (n_wq_wait >= k.wq_lo || !any_read)
                                        : true;
  int pick = 0;
  int32_t best = 0;
  bool p_cand = false, p_hit = false, p_closed = false;
  for (int i = 0; i < k.QT; ++i) {
    const bool cand = cas_candidate(k, i, t) && (!k.qwr[i] || wr_ok);
    const int32_t open = k.bank_row[k.qr[i] * B + k.qb[i]];
    const bool hit = open == k.qrow[i];
    int32_t score = -BIG;
    if (cand) {
      const bool wr = k.qwr[i];
      const bool drain_write = cx[CX_DRAIN_FULL] && draining && wr;
      const int32_t g = k.rk[RK_GROUP * k.R + k.qr[i]];
      const bool dir_match = wr == (k.grp_last_wr[g] != 0);
      int32_t bonus = drain_write ? BIG + (BIG >> 1)
                                  : ((hit && !cx[CX_FCFS]) ? BIG : 0);
      bonus += (cx[CX_OOO_ROW] && hit ? OOO_ROW_BONUS : 0) +
               (cx[CX_OOO_DIR] && dir_match ? OOO_DIR_BONUS : 0);
      score = bonus - k.qarr[i];
    }
    if (i == 0 || score > best) {
      best = score;
      pick = i;
      p_cand = cand;
      p_hit = hit;
      p_closed = open < 0;
    }
  }
  if (!p_cand) return;
  const int32_t t_cl = cx[CX_T_CL], t_rcd = cx[CX_T_RCD], t_rp = cx[CX_T_RP];
  const int32_t lat = p_hit ? t_cl : (p_closed ? t_rcd + t_cl : t_rp + t_rcd + t_cl);
  const int32_t ready = t + lat;
  const bool closed_page = cx[CX_CLOSED_PAGE];
  const int rb = k.qr[pick] * B + k.qb[pick];
  k.bank_busy[rb] = ready + (closed_page ? t_rp : 0);
  k.bank_row[rb] = closed_page ? -1 : k.qrow[pick];
  k.qphase[pick] = 2;
  k.qready[pick] = ready;
  k.whit[pick] = p_hit;
  k.cnt[OUT_N_ACT] += !p_hit;
  k.cnt[OUT_N_ROW_HIT] += p_hit;
  k.cnt[OUT_N_CONFLICT] += !p_hit && !p_closed;
}

SMLA_HD void stage_transfer(Cell& k, int32_t t, bool work_left) {
  const int32_t* cx = k.cx;
  const int R = k.R, B = k.B;
  for (int i = 0; i < k.QT; ++i)
    if (k.qv[i] && k.qphase[i] == 2 && k.qready[i] <= t) k.qphase[i] = 3;
  const int32_t L = cx[CX_L];
  const int32_t t_slot = t % L;
  const int32_t wr_extra = cx[CX_CLOSED_PAGE] ? cx[CX_T_RP] : 0;
  const int32_t ecc = cx[CX_ECC_EVERY];
  for (int g = 0; g < R; ++g) {
    const bool grp_free = k.grp_busy[g] <= t;
    const bool wtr_open = k.grp_wr_until[g] <= t;
    const bool last_wr = k.grp_last_wr[g];
    int p3 = 0;
    int32_t best = 0;
    bool go = false, read_blocked = false;
    for (int i = 0; i < k.QT; ++i) {
      const int r = k.qr[i];
      const bool base3 = k.qv[i] && k.qphase[i] == 3 &&
                         k.rk[RK_GROUP * R + r] == g &&
                         (!cx[CX_SLOTTED] || t_slot == r % L) &&
                         k.ref_until[r * B + k.qb[i]] <= t;
      const bool wr = k.qwr[i];
      const bool wtr_ok = wr || wtr_open;
      const bool cand3 = base3 && wtr_ok && grp_free;
      if (base3 && !wtr_ok) read_blocked = true;
      int32_t score = -BIG;
      if (cand3) {
        score = (cx[CX_OOO_ROW] && k.whit[i] ? OOO_ROW_BONUS : 0) +
                (cx[CX_OOO_DIR] && wr == last_wr ? OOO_DIR_BONUS : 0) -
                k.qarr[i];
      }
      if (i == 0 || score > best) {
        best = score;
        p3 = i;
        go = cand3;
      }
    }
    const bool wr = k.qwr[p3];
    const bool reread = go && !wr && k.cnt[OUT_N_GRANTS] % ecc == ecc - 1;
    const int32_t dur = k.rk[RK_DUR * R + k.qr[p3]];
    const int32_t d = dur + (reread ? dur : 0);
    k.cnt[OUT_N_ECC_REREAD] += reread;
    if (go) {
      k.grp_busy[g] = t + d;
      k.qphase[p3] = 4;
      k.qdone[p3] = t + d;
      k.grp_last_wr[g] = wr;
      k.cnt[OUT_BUS_CYCLES] += d;
      k.cnt[OUT_N_GRANTS] += 1;
      k.cnt[OUT_N_SLOT_GRANTS] += t_slot == k.qr[p3] % L;
      if (wr) {
        const int rb = k.qr[p3] * B + k.qb[p3];
        k.bank_busy[rb] = imax(k.bank_busy[rb], t + d + cx[CX_T_WR] + wr_extra);
        k.grp_wr_until[g] = t + d + cx[CX_T_WTR];
        k.cnt[OUT_WR_BUS_CYCLES] += d;
      }
    } else if (work_left && grp_free && read_blocked) {
      k.cnt[OUT_WTR_STALL] += 1;  // bus free, a read held only by tWTR
    }
  }
}

SMLA_HD void stage_retire(Cell& k, int32_t t) {
  for (int c = 0; c < k.C; ++c) {
    const int lo = c * k.Wd, hi = lo + k.Wd;
    int32_t n_fin = 0, fin_t = -1, min_rem = BIG;
    for (int i = lo; i < hi; ++i) {
      const bool fin = k.qv[i] && k.qphase[i] == 4 && k.qdone[i] <= t;
      if (fin) {
        ++n_fin;
        fin_t = t;
      } else if (k.qv[i]) {
        min_rem = imin(min_rem, k.qtag[i]);
      }
    }
    for (int i = lo; i < hi; ++i) {
      if (!(k.qv[i] && k.qphase[i] == 4 && k.qdone[i] <= t)) continue;
      k.cnt[OUT_N_OOO_RETIRE] += min_rem < k.qtag[i];
      k.cnt[OUT_N_WR] += k.qwr[i] != 0;
      k.qv[i] = 0;
      k.qphase[i] = 0;
    }
    k.served[c] += n_fin;
    k.c_finish[c] = imax(k.c_finish[c], fin_t);
    k.c_out[c] -= n_fin;
  }
}

SMLA_HD void stage_progress(Cell& k) {
  const int32_t n_req = k.cx[CX_N_REQ];
  for (int c = 0; c < k.C; ++c) {
    float oldest = F_BIG;
    for (int i = c * k.Wd; i < (c + 1) * k.Wd; ++i)
      if (k.qv[i] && k.qinst[i] < oldest) oldest = k.qinst[i];
    const float ci = k.c_inst[c];
    const bool window_ok = (ci - oldest) < k.inst_window;
    const int32_t nx = k.c_next[c];
    const float nxt_inst =
        nx < n_req ? k.inst[(int64_t)c * k.M + imin(nx, n_req - 1)] : F_BIG;
    const bool advance = window_ok && k.served[c] < n_req;
    const float v = advance ? ci + k.inst_per_cycle : ci;
    k.c_inst[c] = v < nxt_inst ? v : nxt_inst;
  }
}

SMLA_HD void stage_power(Cell& k, int32_t t, bool work_left) {
  const int32_t* cx = k.cx;
  const int R = k.R, B = k.B;
  for (int r = 0; r < R; ++r) {
    bool pending = false;
    for (int i = 0; i < k.QT; ++i) pending = pending || (k.qv[i] && k.qr[i] == r);
    bool bank_idle = true;
    for (int b = 0; b < B; ++b) bank_idle = bank_idle && k.bank_busy[r * B + b] <= t;
    const bool rank_idle = bank_idle && !pending && r < cx[CX_N_RANKS];
    if (!rank_idle) k.idle_since[r] = t + 1;
    const int32_t idle_for = t - k.idle_since[r];
    const bool enter = cx[CX_SR] && rank_idle && idle_for >= cx[CX_T_SR] &&
                       k.ref_debt[r] == 0;
    const bool leave = k.in_sr[r] && pending;
    const bool in_sr = (k.in_sr[r] || enter) && !leave;
    if (leave) {
      for (int b = 0; b < B; ++b)
        k.bank_busy[r * B + b] = imax(k.bank_busy[r * B + b], t + cx[CX_T_XSR]);
      k.ref_next[r] = t + cx[CX_T_XSR] + k.rk[RK_T_REFI_EFF * R + r];
    }
    k.in_sr[r] = in_sr;
    if (work_left) {
      k.cnt[OUT_N_SR_EXIT] += leave;
      k.cnt[OUT_SR_CYCLES] += in_sr;
      k.cnt[OUT_PD_CYCLES] += rank_idle && idle_for >= cx[CX_T_PD] && !in_sr;
    }
  }
}

SMLA_HD bool work_left(const Cell& k) {
  for (int c = 0; c < k.C; ++c)
    if (k.served[c] < k.cx[CX_N_REQ]) return true;
  return false;
}

SMLA_HD void step(Cell& k, int32_t t) {
  const bool wl = work_left(k);
  stage_refresh(k, t, wl);
  stage_enqueue(k, t);
  stage_schedule(k, t, wl);
  stage_transfer(k, t, wl);
  stage_retire(k, t);
  stage_progress(k);
  stage_power(k, t, wl);
}

// The reference's loop_cond: work left, or a postponed refresh still owed.
SMLA_HD bool running(const Cell& k) {
  if (work_left(k)) return true;
  for (int r = 0; r < k.R; ++r)
    if (k.ref_debt[r] > 0) return true;
  return false;
}

// One cell start to finish: init, chunked loop with early exit at chunk
// boundaries (cycles at or past the horizon are no-ops, so they are not
// run), then the summary counters.
SMLA_HD void sim_cell(const Dims& d, const Buffers& b, int64_t c) {
  Cell k = bind(d, b, c);
  init_state(k);
  const int32_t chunk = d.v[D_CHUNK], horizon = d.v[D_HORIZON];
  int32_t chunks = 0;
  while (chunks < d.v[D_K_MAX] && running(k)) {
    const int32_t t0 = chunks * chunk;
    const int32_t t1 = imin(t0 + chunk, horizon);
    for (int32_t t = t0; t < t1; ++t) step(k, t);
    ++chunks;
  }
  int32_t debt = 0, enq = 0, outstanding = 0;
  for (int r = 0; r < k.R; ++r) debt += k.ref_debt[r];
  for (int cc = 0; cc < k.C; ++cc) enq += k.c_next[cc];
  for (int i = 0; i < k.QT; ++i) outstanding += k.qv[i] != 0;
  k.cnt[OUT_REF_DEBT_END] = debt;
  k.cnt[OUT_N_ENQUEUED] = enq;
  k.cnt[OUT_N_OUTSTANDING] = outstanding;
  k.cnt[OUT_CHUNKS_RUN] = chunks;
}

inline Dims make_dims(const int32_t* dims, const float* fdims) {
  Dims d;
  for (int i = 0; i < D_COUNT; ++i) d.v[i] = dims[i];
  d.inst_window = fdims[0];
  d.inst_per_cycle = fdims[1];
  return d;
}

}  // namespace smla
