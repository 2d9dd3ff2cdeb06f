"""Data parallelism over torch.distributed ranks (counterpart of
nerf2mesh_tpu/parallel/sharding.py and of the shard_map steps in JAX's
utils/trainer.py).

JAX shards a step's ray batch (stage 0) or its crops (stage 1) over the
"data" axis of a device mesh, replicates the parameters, the optimizer
state and the occupancy grid, and reduces the gradients with pmean.  Here
each rank is a process: it draws its num_rays // world_size rays (in stage
1 its own image and crop) from its own generators, runs forward and
backward, and the ranks average their gradients with one flattened
all-reduce; each then takes the same Adam step.  The metrics that steer the
run (the adaptive ray count, the encoder's routing) are reduced first, as
JAX's pmean/psum give them (``reduce_metrics``), so every rank takes the
same decisions and the ranks stay bit-equal.

Launch: ``torchrun --nproc_per_node N -m nerf2mesh_tpu_torch.main ...``;
torchrun sets RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR
and MASTER_PORT.

Backend rule (``init_distributed``): on the CPU, gloo.  On CUDA, NCCL when
the host has a card for each of its local ranks (local rank r on
cuda:r), else gloo with the local ranks sharing the cards (local rank r on
cuda:(r mod cards)): NCCL refuses two ranks on one device.  Gloo moves CUDA
tensors through host memory; this module uses only all_reduce and
broadcast, which gloo takes on CUDA tensors.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# JAX's sharded steps reduce these metrics with pmean ...
MEAN_METRICS = ("loss", "psnr", "psnr_white")
# ... and these with psum (the counts the probes read); the other metrics
# stay the rank's own
SUM_METRICS = ("num_points", "pool_overflow", "encode_resid", "overflow")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The number of ranks; 1 without a process group."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def choose_backend(device, local_rank: int, local_world: int):
    """(backend, device) of a rank by the rule in the module docstring.
    device: None (the card) or "cpu"; a CUDA device names only the kind."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("init_distributed: no CUDA device found; pass "
                           "device='cpu' to train on the CPU")
    cards = torch.cuda.device_count()
    if cards >= local_world:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % cards)


def init_distributed(device=None, init_method: str = "env://",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    rank and world_size default to RANK and WORLD_SIZE (torchrun's);
    LOCAL_RANK and LOCAL_WORLD_SIZE default to them.  init_method "env://"
    reads MASTER_ADDR and MASTER_PORT; tests pass "file://<path>".  The
    backend and the device follow the module docstring's rule.  Local rank
    0 then builds the kernel library (on CUDA) and the host libraries while
    the other local ranks wait: concurrent builds are safe (each writes
    per-process temporaries and renames the result) but compile twice."""
    env = os.environ
    try:
        r = int(env["RANK"]) if rank is None else int(rank)
        n = int(env["WORLD_SIZE"]) if world_size is None else int(world_size)
    except KeyError as e:
        raise RuntimeError(
            f"init_distributed: {e.args[0]} is not set; launch with "
            "torchrun --nproc_per_node N -m nerf2mesh_tpu_torch.main ...") from e
    local_rank = int(env.get("LOCAL_RANK", r))
    local_world = int(env.get("LOCAL_WORLD_SIZE", n))
    backend, dev = choose_backend(device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=r,
                                world_size=n)
    if r == 0:
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        print(f"[dist] {n} ranks, backend {backend} ({cards} card(s) for "
              f"{local_world} local ranks); rank 0 on {dev}", flush=True)
    if local_rank == 0:
        if dev.type == "cuda":
            from ..kernels import load
            load()
        from ..utils.native import BUILD_DIR, build_library
        for name in ("meshops", "jpegdec", "imgdec", "webpdec"):
            build_library(name, BUILD_DIR)
    barrier()
    return dev


def barrier() -> None:
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _comm_device() -> torch.device:
    """Where a small collective's buffer lives: NCCL needs the card, gloo
    takes the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum t over the ranks, in place; returns t."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    off = 0
    with torch.no_grad():
        for t in tensors:
            k = t.numel()
            t.copy_(flat[off:off + k].view_as(t))
            off += k


def all_reduce_mean_grads(params: Iterable[torch.Tensor]) -> None:
    """Replace each parameter's gradient by its mean over the ranks: one
    all-reduce of all the gradients flattened into one buffer.  Every rank
    receives the same sum (ring reduce-scatter then all-gather), so the
    ranks' Adam steps stay bit-equal."""
    n = world_size()
    if n == 1:
        return
    grads = [p.grad for p in params]
    flat = _flat(grads)
    dist.all_reduce(flat)
    flat /= n
    _unflat(flat, grads)


def reduce_metrics(m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A step's metrics over the ranks: the mean of MEAN_METRICS, the sum
    of SUM_METRICS (in float64, so the counts stay exact), in one
    all-reduce; other keys, and None values, keep this rank's value."""
    n = world_size()
    if n == 1:
        return m
    keys = [k for k, v in m.items()
            if v is not None and (k in MEAN_METRICS or k in SUM_METRICS)]
    vals = [torch.as_tensor(m[k]) for k in keys]
    flat = torch.cat([v.reshape(-1).to(torch.float64) for v in vals])
    dist.all_reduce(flat)
    out, off = dict(m), 0
    for k, v in zip(keys, vals):
        part = flat[off:off + v.numel()]
        off += v.numel()
        if k in MEAN_METRICS:
            part = part / n
        out[k] = part.to(v.dtype).reshape(v.shape)
    return out


def broadcast_params(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite the tensors with rank src's, in one broadcast."""
    if world_size() == 1:
        return
    tensors = list(tensors)
    flat = _flat(tensors)
    dist.broadcast(flat, src)
    _unflat(flat, tensors)


def digest(arrays: Iterable) -> bytes:
    """sha256 of the arrays' (numpy or tensor) bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        if torch.is_tensor(a):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def check_equal(what: str, arrays: Iterable) -> None:
    """Raise RuntimeError on every rank unless all ranks hold bit-equal
    arrays (rank 0's digest is broadcast, and the verdict all-reduced)."""
    if world_size() == 1:
        return
    dev = _comm_device()
    mine = torch.from_numpy(np.frombuffer(digest(arrays), np.int64).copy()
                            ).to(dev)
    ref = mine.clone()
    dist.broadcast(ref, 0)
    bad = (ref != mine).any().to(torch.float32).reshape(1)
    dist.all_reduce(bad)
    if float(bad) > 0:
        raise RuntimeError(f"{what} differs between the ranks")
