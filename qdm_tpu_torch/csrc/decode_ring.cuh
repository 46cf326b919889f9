// Pieces shared by the decode kernels that stream their weight through a
// TMA-fed ring with one producer warp and split K across a thread-block
// cluster (decode_dense_bf16.cu: K5, decode_o_mlp_i4.cu: K26).
//
// A block runs consumer warps and one producer warp.  The producer's lane 0
// issues one TMA tile load a stage into a ring of `stages` buffers; each
// buffer has a "full" mbarrier (one arrival with the tile's bytes) and an
// "empty" one (one arrival a consumer warp once it has read the buffer).
// Cluster barriers order the blocks' distributed-shared-memory exchanges;
// the producer warp takes part in each of them, waiting only once it has
// filled the ring, so that no barrier waits on a load that waits on the
// consumers, and no consumer on the producer's issue.

#pragma once

#include "decode_common.cuh"
#include "hopper.cuh"

namespace qdm {
namespace dec {

constexpr int kRingMaxSplit = 8;  // blocks of a cluster

// Four 8 x 8 matrices of 16-bit values (8 rows of 16 bytes each) from shared
// memory; lane L gives the address of row L % 8 of matrix L / 8 and receives
// the 32-bit word L % 4 of row L / 4 of each.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void st_cluster_f64(uint32_t addr, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;\n" ::"r"(addr), "d"(v));
}

// Cluster barriers that the warps of a block may reach at different places
// in the code (the producer warp and the consumers): no .aligned.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The ring's mbarriers: full[i] at bar0 + 8 i, empty[i] at bar0 + 8 (stages + i).
struct Ring {
  uint32_t bar0;
  int stages;
  __device__ uint32_t full(int buf) const { return bar0 + 8u * buf; }
  __device__ uint32_t empty(int buf) const { return bar0 + 8u * (stages + buf); }
  // by one thread, before the block's first __syncthreads
  __device__ void init(int consumer_warps) const {
    for (int i = 0; i < stages; ++i) {
      hop::mbar_init(full(i), 1);
      hop::mbar_init(empty(i), consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // consumer: until stage q's buffer holds its tile
  __device__ void wait_full(int q) const {
    hop::mbar_wait(full(q % stages), (uint32_t)((q / stages) & 1));
  }
  // consumer warp: done with stage q's buffer
  __device__ void release(int q) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) hop::mbar_arrive(empty(q % stages));
  }
  // producer: until stage q's buffer is free (stage q - stages consumed)
  __device__ void wait_empty(int q) const {
    if (q >= stages) hop::mbar_wait(empty(q % stages), (uint32_t)((q / stages - 1) & 1));
  }
};

}  // namespace dec
}  // namespace qdm
