"""Kernel library loader and the per-kernel launch counters.

Each wrapper (ops/occ_sweep.occ_lookup, ops/splat_encode.inwin_fwd,
inwin_bwd, winsort_fwd and winsort_bwd, ops/pallas_encode.sweep_fwd and
sweep_bwd, ops/inwin_variants.inwin_dense_*) adds one to its count where it
launches its CUDA kernel and nowhere else, so a run can show that its main
path went through the kernels.  The inwin_dense variants (K7) lie on no
path: only chip_smoke.py's kernel phase launches them.
"""

from .build import check, load

LAUNCHES = {"occ_lookup": 0, "inwin_fwd": 0, "inwin_bwd": 0,
            "winsort_fwd": 0, "winsort_bwd": 0, "sweep_fwd": 0,
            "sweep_bwd": 0, "inwin_dense_deep": 0,
            "inwin_dense_const_rows": 0, "inwin_dense_four_tiles": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def current_stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["LAUNCHES", "check", "current_stream_handle", "load",
           "reset_launches"]
