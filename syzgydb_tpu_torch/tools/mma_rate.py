"""The warp-level tensor-core MMA rate (csrc/mma_rate.cu) on the current
CUDA device, for the int8 operands K1's int8 route multiplies and for
bf16:

    python3 -m syzgydb_tpu_torch.tools.mma_rate

Prints the card's name and power limit (nvidia-smi), then one JSON line:
for each operand kind and for 8 and 16 warps per SM, the ms of one launch
(mean of 5, CUDA events) and the rate in T op/s (an int8 MMA m16n8k32 is
8,192 operations, a bf16 m16n8k16 4,096).  Exits 2 without a card."""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from ..ops import cuda_build

KINDS = {"s8_m16n8k32": (0, 8192), "bf16_m16n8k16": (1, 4096)}
WARPS_PER_BLOCK, CHAINS = 8, 24  # as csrc/mma_rate.cu


def mma_rate(kind: int, ops_per_mma: int, blocks_per_sm: int,
             iters: int = 2048, reps: int = 5) -> dict:
    fn = cuda_build.entry("mma_rate", "mma_rate_launch",
                          [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p])
    blocks = blocks_per_sm * torch.cuda.get_device_properties(
        0).multi_processor_count
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        cuda_build.check(fn(kind, blocks, iters, out.data_ptr(), stream),
                         "mma_rate")

    launch()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / reps
    ops = blocks * WARPS_PER_BLOCK * iters * CHAINS * ops_per_mma
    return {"ms": ms, "tops": ops / (ms * 1e-3) / 1e12}


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_rate: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    res = {f"{name}_{8 * k}warps": mma_rate(kind, ops, k)
           for name, (kind, ops) in KINDS.items() for k in (1, 2)}
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "mma_sync": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
