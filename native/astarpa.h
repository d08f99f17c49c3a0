/* astarpa_tpu native C API (astarpa-c parity; cf. the reference's
 * astarpa-c/astarpa.h:15-65).
 *
 * Sequences must be ACGT bytes.  Returned CIGAR strings are malloc'd and
 * must be released with astarpa_free().
 */
#ifndef ASTARPA_NATIVE_H
#define ASTARPA_NATIVE_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Align with the default A*PA parameters: GCSH, inexact matches r=2,
 * seed length k=15, prune-by-start, diagonal-transition state space. */
int astarpa(const uint8_t* a, int n, const uint8_t* b, int m,
            char** cigar_out);

/* Align with custom GCSH parameters (r in {1,2}); prune_end also prunes
 * matches by their end position. */
int astarpa_gcsh(const uint8_t* a, int n, const uint8_t* b, int m, int r,
                 int k, int prune_end, char** cigar_out);

/* Full-control entry: prune 0=none 1=start 2=end 3=both; dt selects the
 * diagonal-transition state space; use_gap_cost selects GCSH over CSH.
 * stats_out (optional, length >= 5) receives expanded, explored, extended,
 * reordered, pruned. */
int astarpa_align(const uint8_t* a, int n, const uint8_t* b, int m, int r,
                  int k, int prune, int dt, int use_gap_cost,
                  char** cigar_out, int64_t* stats_out);

/* Traceback from per-block banded-DP checkpoints (ck_vp/ck_vm: (n_ck, SW)
 * words = window state after every col_block columns; ck_tv: (n_ck,)
 * device top_val at the same columns).  The path between checkpoints is
 * recovered with backward diagonal-transition bursts (use_dt=1) or by
 * recomputing stripes (use_dt=0 and as the burst fallback).  S is the
 * bucket's padded profile width in words; shift_at is the bucket's window
 * schedule.  Returns the banded cost and a malloc'd CIGAR, or < 0 on
 * inconsistency. */
int trace_banded_ck(const uint8_t* a, int n, const uint8_t* b, int m, int S,
                    const uint32_t* ck_vp, const uint32_t* ck_vm,
                    const int32_t* ck_tv, int n_ck, const int32_t* shift_at,
                    int SW, int col_block, int use_dt, char** cigar_out);

/* Same, with an explicit checkpoint-plane row count.  ck_rows == SW is the
 * classic contract; ck_rows > SW is the striped kernel's 8-aligned-top
 * contract (plane rows cover words [lo&~7, lo&~7 + ck_rows); the true
 * SW-word window starts at row lo&7). */
int trace_banded_ck_rows(const uint8_t* a, int n, const uint8_t* b, int m,
                         int S, const uint32_t* ck_vp, const uint32_t* ck_vm,
                         const int32_t* ck_tv, int n_ck,
                         const int32_t* shift_at, int SW, int col_block,
                         int use_dt, int ck_rows, char** cigar_out);

/* Traceback through stored banded-DP window planes for one pair (see
 * astarpa_tpu/ops/banded.py::banded_fill).  vp/vm are (n * SW) uint32 words
 * row-major; lo is the per-column window top word index.  Returns the
 * banded cost and a malloc'd CIGAR, or -1 on inconsistency. */
int trace_banded(const uint8_t* a, int n, const uint8_t* b, int m,
                 const uint32_t* vp_cols, const uint32_t* vm_cols,
                 const int32_t* lo, int SW, char** cigar_out);

void astarpa_free(char* p);

#ifdef __cplusplus
}
#endif

#endif /* ASTARPA_NATIVE_H */
