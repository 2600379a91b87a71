#!/usr/bin/env python3
"""Which shared-memory integer adds the card's compiler makes native.

    python -m jspsr_torch.scripts.sass_shared_atomics

Builds a probe of one 64-bit and one 32-bit ``atomicAdd`` into shared
memory with ``nvcc`` for sm_90a, and prints, with the card's name and
power limit, one JSON line of the atomic instructions in the SASS of the
probe's two kernels and of every kernel of ``csrc/deform_bwd.cu``
(``ATOMS.ADD`` is a native shared add, ``ATOMS.CAST.SPIN*`` the
compare-and-swap of a loop). K3's shared-memory window is built on the
answer: its cells are pairs of 32-bit words. Needs ``nvcc`` and
``cuobjdump``; the card is only named.
"""

from __future__ import annotations

import json
import sys

from jspsr_torch.ops import cuda_build
from jspsr_torch.scripts.bench_conv_same import card_line

SHARED_ADD_PROBE = r"""
__global__ void shared_add_u64(unsigned long long* out,
                               unsigned long long v) {
  __shared__ unsigned long long cell[32];
  cell[threadIdx.x & 31] = 0ull;
  __syncthreads();
  atomicAdd(cell + (threadIdx.x * 7 & 31), v);
  __syncthreads();
  out[threadIdx.x] = cell[threadIdx.x & 31];
}
__global__ void shared_add_u32(unsigned* out, unsigned v) {
  __shared__ unsigned cell[32];
  cell[threadIdx.x & 31] = 0u;
  __syncthreads();
  atomicAdd(cell + (threadIdx.x * 7 & 31), v);
  __syncthreads();
  out[threadIdx.x] = cell[threadIdx.x & 31];
}
"""


def main(argv=None) -> dict:
    del argv
    print(card_line(), flush=True)
    cuda_build.build()
    sass = {
        **cuda_build.sass_atomics(cuda_build.build_source(
            "shared_add_probe", SHARED_ADD_PROBE)),
        **cuda_build.sass_atomics(cuda_build.library_path("deform_bwd"))}
    print(json.dumps({"sass_atomics": sass}), flush=True)
    return sass


if __name__ == "__main__":
    main(sys.argv[1:])
