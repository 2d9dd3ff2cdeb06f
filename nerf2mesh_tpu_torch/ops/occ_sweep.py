"""Bit-packed occupancy lookup: kernel K1 (csrc/occ_lookup.cu) and its plain
PyTorch version.  Port of nerf2mesh_tpu/ops/occ_sweep.py.

The grid is packed 32 cells to an int32 word, bit i of word w = cell 32*w+i
with cells in row-major order ((cas*H + x)*H + y)*H + z, exactly as the JAX
``pack_bits``; the port keeps the words flat ([CAS*H^3/32]).  The JAX
package's size gate ``sweep_supported`` was a TPU VMEM/lane constraint and has
no counterpart here: any grid whose cell count is a multiple of 32 packs.
"""

from __future__ import annotations

import torch

from .. import kernels


def pack_bits(occ_grid: torch.Tensor) -> torch.Tensor:
    """[CAS, H, H, H] occupancy (nonzero = occupied) -> [CAS*H^3/32] int32."""
    bits = (occ_grid.reshape(-1, 32) > 0).to(torch.int64)
    shifts = torch.arange(32, device=occ_grid.device, dtype=torch.int64)
    words = (bits << shifts).sum(dim=-1)                    # < 2^32
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def occ_lookup_plain(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: int32 0/1, the shape of idx."""
    return (words[(idx >> 5).long()] >> (idx & 31)) & 1


def occ_lookup(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bit idx of the packed grid (int32 0/1, shape of idx).

    words: pack_bits output [n_words] int32; idx: int32 linear cell indices,
    in range (callers clamp).  A CPU tensor takes the plain version; a CUDA
    tensor launches K1 (counted in kernels.LAUNCHES["occ_lookup"])."""
    if words.dtype != torch.int32 or idx.dtype != torch.int32:
        raise TypeError("occ_lookup: words and idx must be int32")
    if words.dim() != 1:
        raise ValueError("occ_lookup: words must be flat [n_words]")
    if words.device != idx.device:
        raise ValueError("occ_lookup: words and idx on different devices")
    if words.device.type == "cpu":
        return occ_lookup_plain(words, idx)
    if words.device.type != "cuda":
        raise RuntimeError(f"occ_lookup: no kernel for {words.device}")
    words = words.contiguous()
    flat = idx.contiguous().reshape(-1)
    # out at idx's offset from a 16-byte boundary: K1 then stores vectors
    phase = flat.data_ptr() % 16 // 4
    out = torch.empty(flat.numel() + phase, dtype=torch.int32,
                      device=flat.device)[phase:]
    lib = kernels.load()
    code = lib.n2m_occ_lookup(words.data_ptr(), flat.data_ptr(),
                              out.data_ptr(), flat.numel(),
                              kernels.current_stream_handle(words.device))
    kernels.check(lib, "n2m_occ_lookup", code)
    kernels.LAUNCHES["occ_lookup"] += 1
    return out.reshape(idx.shape)
