// Lane-gather tile-join probe of transposed plane tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ``kernel`` of scripts/sweep.py
// section_tjgather.make_probe (the lane-axis gather experiment of the tile
// join). Its operands are taken as they are:
//   plane3 u16 [tiles, 128, 128], read as [tile, off, row] (each 128x128
//          plane tile stored transposed),
//   ids    i32 [nsup]: super-tile b covers tiles ids[b] * 8 + t, t < 8,
//   packed i32 [nsup, 8, cap128, 128]: qfp << 14 | row << 7 | off.
// For every packed cell p, with tile = ids[b] * 8 + t, rr = (p >> 7) & 127,
// off = p & 127 and qfp = p >> 14 (an arithmetic shift, as in the TPU
// kernel), it writes
//   key = min over rel < 16 with off + rel < 128 of
//         2 * rel      if plane3[tile, off + rel, rr] == qfp,
//         2 * rel + 1  if it is FP_EMPTY (65535),
//   else 32,
// the unpacked first-event key of the tile join: a candidate outranks an
// empty slot at the same offset. The window (16) and the tiles a super-tile
// (8) are the sweep's constants. A super-tile whose ids[b] names no tile of
// the plane gives 32 in every cell (the TPU kernel's block index would
// run off the plane there).
//
// Bound: device-memory bytes. A cell reads 4 B of packed input, writes 4 B,
// and reads up to 16 plane values 256 B apart (one column of the transposed
// tile); at random rows neighbouring lanes touch other columns, so each
// read is a sector of its own from L2 (a tile is 32 KB and the cells of a
// super-tile revisit its tiles). The design is the simple one: one thread
// per packed cell, neighbouring threads on neighbouring cells (coalesced
// packed loads and key stores), each scanning its column and stopping at
// the first event. The transposed tile is the experiment's input, so its
// strided column read is kept. Measured on an H100 80GB HBM3 (700 W) at
// the sweep's shape (a 512 MB plane, cap 512, 8.4M cells, random operands
// that scan every column to its end): 0.41 ms a launch (PERF.md,
// Findings).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtjgather.so tjgather.cu
// Bound to PyTorch with ctypes by kmergutsjava_tpu_torch/lookup/tjgather.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // rows (and offsets) of a plane tile
constexpr int kTpg = 8;     // tiles a super-tile
constexpr int kW = 16;      // probe window
constexpr int kThreads = 256;
constexpr int32_t kFpEmpty = 65535;

__global__ void __launch_bounds__(kThreads)
tjgather_kernel(const uint16_t* __restrict__ plane3, int64_t tiles,
                const int32_t* __restrict__ ids,
                const int32_t* __restrict__ packed, int64_t cells,
                int32_t cap128, int32_t* __restrict__ key) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const int64_t per_tile = static_cast<int64_t>(cap128) * kTile;
  const int64_t t = (i / per_tile) % kTpg;
  const int64_t b = i / (per_tile * kTpg);
  const int64_t tile = static_cast<int64_t>(ids[b]) * kTpg + t;
  const int32_t p = packed[i];
  int32_t k = 2 * kW;
  if (tile >= 0 && tile < tiles) {
    const int32_t rr = (p >> 7) & 127;
    const int32_t off = p & 127;
    const int32_t qfp = p >> 14;
    const uint16_t* col = plane3 + tile * kTile * kTile + rr;
    const int32_t end = min(kW, kTile - off);
    for (int32_t rel = 0; rel < end; ++rel) {
      const int32_t v = __ldg(col + (off + rel) * kTile);
      if (v == qfp) {
        k = 2 * rel;
        break;
      }
      if (v == kFpEmpty) {
        k = 2 * rel + 1;
        break;
      }
    }
  }
  key[i] = k;
}

}  // namespace

extern "C" {

// Launches the probe on ``stream``; returns cudaGetLastError() (0 = the
// launch was accepted). Inputs: plane3[tiles, 128, 128], ids[nsup] and
// packed[nsup, 8, cap128, 128]; output key[nsup, 8, cap128, 128].
int tjgather_probe(const void* plane3, int64_t tiles, const void* ids,
                   int64_t nsup, const void* packed, int32_t cap128,
                   void* key, void* stream) {
  if (cap128 < 1 || nsup < 0 || tiles < 0) return cudaErrorInvalidValue;
  const int64_t cells = nsup * kTpg * cap128 * kTile;
  if (cells == 0) return cudaSuccess;
  const int64_t blocks = (cells + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  tjgather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(plane3), tiles,
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(packed),
      cells, cap128, static_cast<int32_t*>(key));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
