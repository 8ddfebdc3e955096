// Compact delta slots for the rows a trainer step touches, shared by the
// exact-negative step (sgns_exact.cu) and the conv step (sgns_conv.cu).
//
// A step adds its gradient rows into slots [R, D] of a workspace instead of
// a vocabulary-sized buffer: a row's slot is taken at its first touch
// through a row-to-slot map (one int a vocabulary row, -1 when free) and
// the row is listed beside it, so the update (sgns_exact.cu's apply kernel)
// visits the touched rows alone and leaves every slot and map entry empty
// again. The workspace is ops/sgns_exact.py::Workspace.

#pragma once

#include <cstdint>

namespace srw {

constexpr int kNoSlot = -1;

struct Scratch {
  float* d[2];     // delta slots [R, D]: 0 = w_in's rows, 1 = w_out's
  int* cnt[2];     // shares summed into each slot
  int* map[2];     // row -> slot, kNoSlot when none
  int* list[2];    // slot -> row
  int* counts;     // slots taken in each
  // table t's arrays (a select, not an index: a parameter indexed by a
  // value known only at run time would be copied to local memory)
  __device__ float* dt(int t) const { return t == 0 ? d[0] : d[1]; }
  __device__ int* cntt(int t) const { return t == 0 ? cnt[0] : cnt[1]; }
  __device__ int* mapt(int t) const { return t == 0 ? map[0] : map[1]; }
  __device__ int* listt(int t) const { return t == 0 ? list[0] : list[1]; }
};

// The compact slot of `row` in table t, taken at the row's first touch: the
// first toucher marks the map busy, takes the next slot, lists the row and
// publishes the slot; a later toucher waits for the slot to appear. A
// plain read (which may be stale, never wrong once it holds a slot) comes
// first, so a row's later touches take no atomic.
__device__ inline int claim(const Scratch& s, int t, int row) {
  int* m = s.mapt(t) + row;
  int slot = *m;
  if (slot >= 0) return slot;
  slot = atomicCAS(m, kNoSlot, -2);
  if (slot == kNoSlot) {
    slot = atomicAdd(s.counts + t, 1);
    s.listt(t)[slot] = row;
    atomicExch(m, slot);
    return slot;
  }
  while (slot == -2) slot = *static_cast<volatile int*>(m);
  return slot;
}

// The workspace's arrays from the wrapper's pointer list: d_in, d_out,
// cnt_in, cnt_out, map_in, map_out, list_in, list_out, counts[2].
inline Scratch scratch(void* const* p) {
  Scratch s;
  for (int t = 0; t < 2; ++t) {
    s.d[t] = static_cast<float*>(p[t]);
    s.cnt[t] = static_cast<int*>(p[2 + t]);
    s.map[t] = static_cast<int*>(p[4 + t]);
    s.list[t] = static_cast<int*>(p[6 + t]);
  }
  s.counts = static_cast<int*>(p[8]);
  return s;
}

}  // namespace srw
