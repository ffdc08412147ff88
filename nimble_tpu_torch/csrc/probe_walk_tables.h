// probe_walk_tables.h: the tables of a probe_walk_filter launch, one
// library's or L stacked on a leading axis, with the gates of compact mode.
// Plain C, included by probe_walk_filter.cu; nimble_tpu_torch/ops/
// probe_walk.py mirrors it field for field as a ctypes.Structure
// (_ProbeTables), built once per (tables, bucket, mode) after the host's
// checks: every extent and index below 2^31, bkey_fp 16-byte aligned and
// W a multiple of 4 (the probe loads 16 bytes of a bucket row at a time).
// tests/test_torch_probe_walk.py compiles this header with the host's C++
// compiler and holds the two layouts equal.

#ifndef NIMBLE_PROBE_WALK_TABLES_H_
#define NIMBLE_PROBE_WALK_TABLES_H_

#include <stdint.h>

struct ProbeTables {
  const uint32_t* bkey_lo;          // (L, n_buckets, W)
  const uint32_t* bkey_hi;
  const uint32_t* bkey_fp;
  const int32_t* bstart;
  const int32_t* bcount;
  const int32_t* postings_row;      // (L, n_postings)
  const int32_t* postings_off;
  const uint32_t* ref;              // (L, n_words)
  const int32_t* row_starts;        // (L, n_rows)
  const int32_t* row_lengths;
  const int32_t* s_min;             // (L, s_len); null in full mode
  const int32_t* threshold;         // (L,) when stacked, else null:
  const int32_t* mismatches;        //   the scalars below
  const uint8_t* discard_multiple;  // (L,) bool
  const uint8_t* discard_nonzero;
  int64_t threshold0, mismatches0;
  int32_t discard_multiple0, discard_nonzero0;
  int32_t L, n_buckets, W, max_probe, n_postings, n_rows, n_words, s_len;
  int32_t Lmax, k, ref_pad, full;
};

#endif  // NIMBLE_PROBE_WALK_TABLES_H_
