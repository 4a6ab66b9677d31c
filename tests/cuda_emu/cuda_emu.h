// A CPU stand-in for the CUDA features lighthouse_tpu_torch/csrc/fp_kernels.cu
// uses, so that g++ can build the same source for the tests:
//
// * one std::thread per CUDA thread, the blocks of a launch one after
//   another; threadIdx and blockIdx are thread-local;
// * __shared__ variables are static locals, shared by the block's threads;
// * __syncwarp and the shuffles meet at one std::barrier per warp,
//   __syncthreads at one per block; a thread that returns drops out of both.
//
// It reproduces the kernels' arithmetic, indexing and synchronisation, not
// their speed or what nvcc accepts.
#pragma once
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static

struct EmuIndex {
  unsigned x;
};
inline thread_local EmuIndex threadIdx, blockIdx;

struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};

template <class T>
T __ldg(const T* p) {
  return *p;
}

using cudaStream_t = void*;
inline int cudaGetLastError() { return 0; }

struct EmuWarp {
  std::barrier<> bar{32};
  uint32_t slot[32];
};
inline thread_local EmuWarp* emu_warp;
inline thread_local std::barrier<>* emu_block;

inline void __syncwarp(unsigned = 0xFFFFFFFFu) { emu_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { emu_block->arrive_and_wait(); }

inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  const int t = threadIdx.x & 31;
  emu_warp->slot[t] = v;
  emu_warp->bar.arrive_and_wait();
  const uint32_t r = emu_warp->slot[src & 31];
  emu_warp->bar.arrive_and_wait();
  return r;
}

inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int delta) {
  const int t = threadIdx.x & 31;
  emu_warp->slot[t] = v;
  emu_warp->bar.arrive_and_wait();
  const uint32_t r = t >= delta ? emu_warp->slot[t - delta] : v;
  emu_warp->bar.arrive_and_wait();
  return r;
}

// kernel<<<grid, block, 0, stream>>>(args...) becomes
// emu_launch(kernel, grid, block, args...).
template <class Kernel, class... Args>
void emu_launch(Kernel kernel, int grid, int block, Args... args) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> block_bar(block);
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (int w = 0; w < block / 32; ++w) warps.emplace_back(new EmuWarp);
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_warp = warps[t / 32].get();
        emu_block = &block_bar;
        kernel(args...);
        emu_warp->bar.arrive_and_drop();
        block_bar.arrive_and_drop();
      });
    }
    for (auto& th : threads) th.join();
  }
}
