/* Native issue loop for the RegDem timing simulator.
 *
 * A statement-for-statement translation of the scheduling semantics of
 * repro.core.simulator._issue_loop (which is itself cycle-exact with
 * simulate_reference): warps round-robin under the arch's issue width,
 * per-class unit capacity gates issue, a cycle in which nothing issues
 * jumps to the next warp-ready or unit-free event, and (optionally) every
 * idle cycle is charged to exactly one (record, reason) blame bucket.
 *
 * All clocks are IEEE-754 binary64, the same representation CPython floats
 * use, and every operation performed on them (compare, add, max, truncate)
 * is exact in both languages — so this engine is state-for-state identical
 * to the Python fallback, checkpoint captures included.  The Python side
 * (repro.core._native) owns compilation, marshalling and the reason-code
 * order; keep the two files in sync.
 */
#include <math.h>
#include <stdint.h>
#include <string.h>

#define N_REASONS 5
#define REASON_STALL 0
#define REASON_BANK 1
#define REASON_MEM 2
#define REASON_BAR 3
#define REASON_UNIT 4

/* params_i layout (mirrored in repro.core._native) */
enum {
    PI_N_TRACE,
    PI_N_RECORDS,
    PI_N_WARPS,
    PI_ISSUE_WIDTH,
    PI_NUM_BARRIERS,
    PI_N_CLASSES,
    PI_PROFILE,
    PI_N_THRESHOLDS,
    PI_RR,
    PI_IDLE,
    PI_FRONTIER,
    PI_COUNT
};

/* out_i layout */
enum { PO_IDLE, PO_FRONTIER, PO_RR, PO_N_CAPTURED, PO_COUNT };

int64_t regdem_issue_loop(
    const int64_t *params_i,
    const double *params_d, /* [max_cycles, cycle0] */
    const int64_t *code,    /* n_trace dynamic positions -> record index */
    const int64_t *r_klass, /* per-record fields, n_records each */
    const int64_t *r_cost,
    const int64_t *r_wbar,
    const int64_t *r_rbar,
    const int64_t *r_wlat,
    const int64_t *r_rlat,
    const int64_t *r_confl,
    const int64_t *r_mem,
    const int64_t *wait_off,  /* n_records + 1 */
    const int64_t *wait_data, /* flattened wait sets */
    const double *intervals,  /* n_classes */
    int64_t *pc,              /* n_warps, in/out */
    double *next_time,        /* n_warps, in/out */
    double *bars,             /* n_warps * num_barriers, in/out */
    double *unit_free,        /* n_classes, in/out */
    int64_t *blame,           /* n_records * N_REASONS (profile only) */
    int64_t *warp_blame,      /* n_warps * 2: (rec, reason) (profile only) */
    int64_t *bar_setter,      /* n_warps * num_barriers (profile only) */
    const int64_t *thresholds, /* ascending capture milestones */
    int64_t *cap_i, /* per slot: frontier, idle, rr, pc[], wblame[], bset[] */
    double *cap_d,  /* per slot: cycle, next_time[], bars[], unit_free[] */
    int64_t *cap_blame, /* per slot: n_records * N_REASONS */
    double *out_d,      /* [cycle] */
    int64_t *out_i      /* PO_COUNT */
) {
    const int64_t n_trace = params_i[PI_N_TRACE];
    const int64_t n_records = params_i[PI_N_RECORDS];
    const int64_t n_warps = params_i[PI_N_WARPS];
    const int64_t issue_width = params_i[PI_ISSUE_WIDTH];
    const int64_t nb = params_i[PI_NUM_BARRIERS];
    const int64_t nc = params_i[PI_N_CLASSES];
    const int profile = (int)params_i[PI_PROFILE];
    const int64_t n_thr = params_i[PI_N_THRESHOLDS];
    int64_t rr = params_i[PI_RR];
    int64_t idle_cycles = params_i[PI_IDLE];
    int64_t frontier = params_i[PI_FRONTIER];
    const double max_cycles = params_d[0];
    double cycle = params_d[1];

    int64_t n_done = 0;
    for (int64_t w = 0; w < n_warps; w++)
        if (pc[w] >= n_trace) n_done++;

    int64_t thr_cur = 0, n_cap = 0;
    const int64_t slot_i = 3 + 3 * n_warps + n_warps * nb;
    const int64_t slot_d = 1 + n_warps + n_warps * nb + nc;

    while (n_done < n_warps && cycle < max_cycles) {
        /* checkpoint capture at trace-position milestones (loop top) */
        if (thr_cur < n_thr && n_done == 0 && frontier >= thresholds[thr_cur]) {
            while (thr_cur < n_thr && frontier >= thresholds[thr_cur])
                thr_cur++;
            int64_t *ci = cap_i + n_cap * slot_i;
            double *cd = cap_d + n_cap * slot_d;
            ci[0] = frontier;
            ci[1] = idle_cycles;
            ci[2] = rr;
            memcpy(ci + 3, pc, (size_t)n_warps * sizeof(int64_t));
            if (profile) {
                memcpy(ci + 3 + n_warps, warp_blame,
                       (size_t)(2 * n_warps) * sizeof(int64_t));
                memcpy(ci + 3 + 3 * n_warps, bar_setter,
                       (size_t)(n_warps * nb) * sizeof(int64_t));
                memcpy(cap_blame + n_cap * n_records * N_REASONS, blame,
                       (size_t)(n_records * N_REASONS) * sizeof(int64_t));
            }
            cd[0] = cycle;
            memcpy(cd + 1, next_time, (size_t)n_warps * sizeof(double));
            memcpy(cd + 1 + n_warps, bars,
                   (size_t)(n_warps * nb) * sizeof(double));
            memcpy(cd + 1 + n_warps + n_warps * nb, unit_free,
                   (size_t)nc * sizeof(double));
            n_cap++;
        }

        const double cap = cycle + 1.0;
        int64_t issued = 0;
        for (int64_t k = 0; k < n_warps; k++) {
            int64_t w = rr + k;
            if (w >= n_warps) w -= n_warps;
            if (next_time[w] > cycle) continue; /* blocked (done parks at inf) */
            int64_t p = pc[w];
            int64_t j = code[p];
            int64_t ki = r_klass[j];
            double uf = unit_free[ki];
            if (uf >= cap) continue; /* unit capacity spent this cycle */
            /* ---- issue ---- */
            issued++;
            unit_free[ki] = (uf > cycle ? uf : cycle) + intervals[ki];
            double t = cycle + (double)r_cost[j];
            double *bw = bars + w * nb;
            int64_t b = r_wbar[j];
            if (b >= 0) bw[b] = cycle + (double)r_wlat[j];
            b = r_rbar[j];
            if (b >= 0) bw[b] = cycle + (double)r_rlat[j];
            if (profile) {
                int64_t *bs = bar_setter + w * nb;
                if (r_wbar[j] >= 0) bs[r_wbar[j]] = j;
                if (r_rbar[j] >= 0) bs[r_rbar[j]] = j;
            }
            p++;
            pc[w] = p;
            if (p > frontier) frontier = p;
            if (p >= n_trace) {
                n_done++;
                next_time[w] = INFINITY;
            } else if (!profile) {
                int64_t jn = code[p];
                for (int64_t q = wait_off[jn]; q < wait_off[jn + 1]; q++) {
                    double v = bw[wait_data[q]];
                    if (v > t) t = v;
                }
                next_time[w] = t;
            } else {
                /* same wait maximization, additionally tracking which event
                 * bounds t: the issued instruction's own cost (stall / bank
                 * conflict) or a scoreboard barrier and its setter */
                int64_t rec = j;
                int64_t reason = r_confl[j] ? REASON_BANK : REASON_STALL;
                int64_t *bs = bar_setter + w * nb;
                int64_t jn = code[p];
                for (int64_t q = wait_off[jn]; q < wait_off[jn + 1]; q++) {
                    int64_t bb = wait_data[q];
                    double v = bw[bb];
                    if (v > t) {
                        t = v;
                        int64_t sj = bs[bb];
                        if (sj >= 0) {
                            rec = sj;
                            reason = r_mem[sj] ? REASON_MEM : REASON_BAR;
                        }
                    }
                }
                next_time[w] = t;
                warp_blame[2 * w] = rec;
                warp_blame[2 * w + 1] = reason;
            }
            if (issued >= issue_width) break;
        }
        if (issued) {
            rr++;
            if (rr >= n_warps) rr = 0;
            cycle += 1.0;
            continue;
        }
        /* Idle: jump to the next time anything can happen.  Two shapes,
         * both counted exactly as the reference engine does:
         *   - no warp ready: one iteration jumps to the earliest warp-ready
         *     event (rr advances once);
         *   - a warp is ready but its unit is at capacity: the reference
         *     crawls cycle-by-cycle until the unit frees or another warp
         *     readies; the k crawl cycles collapse into one iteration with
         *     rr += k and idle += k. */
        rr++;
        if (rr >= n_warps) rr = 0;
        double mn_wait = INFINITY;
        int64_t w_wait = -1; /* first strict minimum, ascending warp order */
        double mn_block = INFINITY;
        int64_t w_block = -1;
        for (int64_t w = 0; w < n_warps; w++) {
            double v = next_time[w];
            if (v > cycle) {
                if (v < mn_wait) {
                    mn_wait = v;
                    w_wait = w;
                }
            } else {
                /* ready but unit-blocked: the unit frees at floor(clock) */
                int64_t ki = r_klass[code[pc[w]]];
                double bv = (double)(int64_t)unit_free[ki];
                if (bv < mn_block) {
                    mn_block = bv;
                    w_block = w;
                }
            }
        }
        double nxt;
        int64_t kk;
        if (mn_block < INFINITY) {
            nxt = mn_block < mn_wait ? mn_block : mn_wait;
            if (nxt < cap)
                nxt = cap;
            else if (nxt > max_cycles)
                nxt = max_cycles; /* the reference stops exactly at the cap */
            kk = (int64_t)(nxt - cycle);
            idle_cycles += kk;
            rr += kk - 1;
            rr %= n_warps;
            if (profile && kk) {
                if (mn_block <= mn_wait) {
                    blame[code[pc[w_block]] * N_REASONS + REASON_UNIT] += kk;
                } else {
                    blame[warp_blame[2 * w_wait] * N_REASONS +
                          warp_blame[2 * w_wait + 1]] += kk;
                }
            }
        } else {
            nxt = mn_wait > cap ? mn_wait : cap;
            kk = (int64_t)(nxt - cycle);
            idle_cycles += kk;
            if (profile && kk) {
                blame[warp_blame[2 * w_wait] * N_REASONS +
                      warp_blame[2 * w_wait + 1]] += kk;
            }
        }
        cycle = nxt;
    }
    out_d[0] = cycle;
    out_i[PO_IDLE] = idle_cycles;
    out_i[PO_FRONTIER] = frontier;
    out_i[PO_RR] = rr;
    out_i[PO_N_CAPTURED] = n_cap;
    return 0;
}
