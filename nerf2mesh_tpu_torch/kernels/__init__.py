"""Kernel library loader and the per-kernel launch counters.

Each wrapper (ops/occ_sweep.occ_lookup, ops/splat_encode.inwin_fwd,
inwin_bwd, winsort_fwd and winsort_bwd, ops/pallas_encode.sweep_fwd and
sweep_bwd, ops/inwin_variants.inwin_dense_*) adds one to its count where it
launches its CUDA kernel and nowhere else, so a run can show that its main
path went through the kernels.  The inwin_dense variants (K7) lie on no
path: only chip_smoke.py's kernel phase launches them.  The encode kernels
that take a table of C = 1, 2 or 3 channels (inwin_fwd/bwd, winsort_fwd/bwd,
sweep_fwd/bwd) also count each launch under "<name>_c<C>", so that a run
can show which instantiations it went through; "<name>" counts them all.
"""

from .build import check, load

LAUNCHES = {"occ_lookup": 0, "inwin_fwd": 0, "inwin_bwd": 0,
            "winsort_fwd": 0, "winsort_bwd": 0, "sweep_fwd": 0,
            "sweep_bwd": 0, "inwin_dense_deep": 0,
            "inwin_dense_const_rows": 0, "inwin_dense_four_tiles": 0}
CHANNEL_KERNELS = ("inwin_fwd", "inwin_bwd", "winsort_fwd", "winsort_bwd",
                   "sweep_fwd", "sweep_bwd")
LAUNCHES.update({f"{k}_c{c}": 0 for k in CHANNEL_KERNELS for c in (1, 2, 3)})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def channels(spec) -> int:
    """The table channels C = spec.level_dim that the encode kernels read:
    1, 2 or 3 (each kernel has an instantiation for each), else
    ValueError."""
    if spec.level_dim not in (1, 2, 3):
        raise ValueError(f"the encode kernels read tables of 1, 2 or 3 "
                         f"channels, not level_dim={spec.level_dim}")
    return spec.level_dim


def count(name: str, channels: int) -> None:
    """One launch of kernel `name` at `channels` table channels."""
    LAUNCHES[name] += 1
    LAUNCHES[f"{name}_c{channels}"] += 1


def current_stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


__all__ = ["CHANNEL_KERNELS", "LAUNCHES", "channels", "check", "count",
           "current_stream_handle", "load",
           "reset_launches"]
