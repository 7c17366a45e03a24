"""Hamming sketch surfaces: the wrappers of kernels K2 and K3
(``csrc/hamming.cu``) and their plain PyTorch versions.

K2 is the counterpart of
``syzgydb_tpu/ops/pallas_hamming.py::hamming_scores_bf16``: (Q, W) query
sketches x (N, W) row sketches + (N,) validity -> (Q, N) Hamming distances,
invalid rows 16384, as bf16 or f32 (``out_dtype``; every value is exact in
both).  K3 (``hamming_scores_u8``) is the counterpart of
``pallas_hamming.hamming_scores``: the same distances with no mask as a
uint8 surface, wrapping at 256 as that function's uint8 cast does.  Sketch
words are uint32 values carried in int32 tensors (same bits; PyTorch's
uint32 support is partial).

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version.  On the card both surfaces are exact int8 tensor-core products of
the unpacked sketch bits (see the source); PyTorch has no popcount
operator, so no library call computes them.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

INVALID = 16384.0

# plain-integer launch counters (reset by callers)
launches = 0     # K2
u8_launches = 0  # K3


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each int32 word's 32-bit pattern (SWAR, in int64 so no
    step overflows)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_scores_plain(qcodes: torch.Tensor, hashes: torch.Tensor,
                         valid: torch.Tensor,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain version of K2 (per-word accumulate, like the JAX package's XLA
    loop, _hamming_candidates_xla), as `out_dtype`."""
    out = _hamming_counts(qcodes, hashes).to(out_dtype)
    return torch.where(valid[None, :], out, torch.full_like(out, INVALID))


def hamming_scores_u8_plain(qcodes: torch.Tensor,
                            hashes: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: the low 8 bits of each count, as uint8."""
    return (_hamming_counts(qcodes, hashes) & 0xFF).to(torch.uint8)


def _hamming_counts(qcodes: torch.Tensor, hashes: torch.Tensor):
    """(Q, N) int64 Hamming counts, one word at a time (like the JAX
    package's XLA loop, _hamming_candidates_xla)."""
    q = qcodes.to(torch.int32)
    ham = torch.zeros((q.shape[0], hashes.shape[0]), dtype=torch.int64,
                      device=hashes.device)
    for w in range(hashes.shape[1]):
        ham += _popcount32(torch.bitwise_xor(q[:, w, None],
                                             hashes[None, :, w]))
    return ham


def _check(qcodes, hashes, valid=None):
    q, w = qcodes.shape
    n, w2 = hashes.shape
    if w != w2:
        raise ValueError(f"sketch widths differ: {w} vs {w2}")
    if valid is not None and (valid.shape != (n,) or
                              valid.dtype != torch.bool):
        raise ValueError("valid must be an (N,) bool tensor")
    for t in (qcodes, hashes):
        if t.dtype != torch.int32:
            raise TypeError("sketch words must be int32 tensors")
    devs = {t.device for t in (qcodes, hashes, valid) if t is not None}
    if len(devs) != 1:
        raise ValueError("qcodes, hashes and valid must share a device")
    for t in (qcodes, hashes, valid):
        if t is not None and t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {t.device}")


OUT_DTYPES = (torch.bfloat16, torch.float32)


def hamming_scores(qcodes: torch.Tensor, hashes: torch.Tensor,
                   valid: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(Q, W) x (N, W) int32 sketches + (N,) bool -> (Q, N) distances as
    `out_dtype` (bf16 or f32), invalid rows 16384.  CUDA tensors on the
    current device launch K2; CPU tensors take the plain version."""
    global launches
    _check(qcodes, hashes, valid)
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}")
    if hashes.device.type == "cpu":
        return hamming_scores_plain(qcodes, hashes, valid, out_dtype)
    _check_cuda_operands(qcodes=qcodes, hashes=hashes, valid=valid)
    # the kernel bulk-copies validity from a 16-byte aligned start
    if valid.data_ptr() % 16:
        valid = valid.clone()
    fn = cuda_build.entry("hamming", "hamming_launch", [ctypes.c_void_p] * 4 +
                          [ctypes.c_int, ctypes.c_long, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p])
    q, w = qcodes.shape
    n = hashes.shape[0]
    out = torch.empty((q, n), dtype=out_dtype, device=hashes.device)
    rc = fn(qcodes.data_ptr(), hashes.data_ptr(), valid.data_ptr(),
            out.data_ptr(), q, n, w, int(out_dtype == torch.bfloat16),
            cuda_build.launch_stream(hashes.device))
    cuda_build.check(rc, "hamming")
    launches += 1
    return out


def _check_cuda_operands(**tensors) -> None:
    """Contiguous operands, and a sketch array that starts 16-byte aligned:
    the kernel bulk-copies whole 512-row blocks of it (2048 W bytes)."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tensors["hashes"].data_ptr() % 16:
        raise ValueError("hashes must start 16-byte aligned (a view that "
                         "begins inside a tensor's storage may not)")


def hamming_scores_u8(qcodes: torch.Tensor,
                      hashes: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (N, W) int32 sketches -> (Q, N) uint8 Hamming distances
    with no validity mask; a count of 256 (W = 8, every bit differs) wraps
    to 0 as the JAX function's uint8 cast does.  CUDA tensors on the
    current device launch K3; CPU tensors take the plain version."""
    global u8_launches
    _check(qcodes, hashes)
    if hashes.device.type == "cpu":
        return hamming_scores_u8_plain(qcodes, hashes)
    _check_cuda_operands(qcodes=qcodes, hashes=hashes)
    fn = cuda_build.entry("hamming", "hamming_u8_launch", [ctypes.c_void_p] * 3
                          + [ctypes.c_int, ctypes.c_long, ctypes.c_int,
                             ctypes.c_void_p])
    q, w = qcodes.shape
    n = hashes.shape[0]
    out = torch.empty((q, n), dtype=torch.uint8, device=hashes.device)
    rc = fn(qcodes.data_ptr(), hashes.data_ptr(), out.data_ptr(), q, n, w,
            cuda_build.launch_stream(hashes.device))
    cuda_build.check(rc, "hamming_u8")
    u8_launches += 1
    return out
