"""Where the fp32 tile loop's time goes (csrc/scan_tile.cuh), on the
current CUDA device:

    python3 -m syzgydb_tpu_torch.tools.fp32_split

Builds csrc/segmin.cu twice more besides the shipped library, through
ops/cuda_build (the shipped build's flags, each variant in a subdirectory
of _build/): without the stage copies and the decode (SCAN_TILE_SPLIT=1:
the products and the epilogue alone, on whatever shared memory holds) and
without the products (SCAN_TILE_SPLIT=2: the copies, the decode and the
epilogue alone).  Then times K1 (seg 32, cosine) with each on 1,048,576
x 384 seeded codes at 4, 16 and 64 bits and Q = 16, 64 and 1024, by CUDA
events (mean of 5 launches after one warm-up).  The split builds' outputs
are meaningless; only their times are read.  Prints the card's name and
power limit (nvidia-smi), then one JSON line.  Exits 2 without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import cuda_build, scan
from ..ops import quantize as qz

SPLITS = {"shipped": (), "products_only": (("SCAN_TILE_SPLIT", 1),),
          "staging_only": (("SCAN_TILE_SPLIT", 2),)}
N_ROWS, DIMS = 1 << 20, 384


def _ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # the host queues every launch first
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _codes(bits: int, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(bits)
    w = qz.device_width(bits, DIMS)
    if bits == 4:
        codes = torch.randint(0, 256, (N_ROWS, w), generator=gen, device=dev,
                              dtype=torch.uint8)
    elif bits == 16:
        codes = torch.randint(-32768, 32768, (N_ROWS, w), generator=gen,
                              device=dev, dtype=torch.int16)
    else:
        codes = torch.rand((N_ROWS, w), generator=gen, device=dev) * 2 - 1
    norms = torch.rand(N_ROWS, generator=gen, device=dev) + 0.5
    valid = torch.rand(N_ROWS, generator=gen, device=dev) > 0.01
    return codes, norms, valid


def main() -> int:
    if not torch.cuda.is_available():
        print("fp32_split: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    cuda_build.build_all(("segmin",), variants=tuple(SPLITS.values()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    queries = torch.rand((1024, DIMS), generator=gen, device=dev) * 2 - 1
    ms = {name: {} for name in SPLITS}
    for bits in (4, 16, 64):
        codes, norms, valid = _codes(bits, dev)
        for name, defines in SPLITS.items():
            for q in (16, 64, 1024):
                qq = queries[:q].contiguous()
                out = torch.empty((q, N_ROWS // 32), device=dev)
                ms[name][f"{bits}bit_q{q}"] = _ms(lambda: scan._launch_fp32(
                    "segmin", out, 32, qq, codes, norms, valid, bits=bits,
                    metric="cosine", defines=defines))
        del codes, norms, valid
    print(json.dumps({"card": card, "rows": N_ROWS, "dims": DIMS,
                      "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
