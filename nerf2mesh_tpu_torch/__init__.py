"""nerf2mesh_tpu_torch: PyTorch + CUDA port of nerf2mesh_tpu for NVIDIA Hopper.

The JAX package ``nerf2mesh_tpu`` is the reference; each module here mirrors
the JAX module of the same path and public names, and tests/test_torch_*.py
hold the two against each other on the CPU.  Every Pallas kernel that a
ported path reaches is a hand-written CUDA kernel under ``csrc/``, built for
sm_90a at first use (``kernels/build.py``).  A wrapper runs its kernel for a
CUDA tensor and its plain PyTorch version for a CPU tensor.

Ported so far: both stages through the CLI (``python -m
nerf2mesh_tpu_torch.main``, then ``--stage 1``) and
``utils.trainer.Trainer``: stage-0 training, the eval render and metrics,
checkpoints (the JAX package's load too, both stages), the test video, the
stage-0 mesh export, stage 1 through a PyTorch rasterizer and the textured
export, on the block512 and the small ref tables, merged or separate (the
encode kernels at 1, 2 and 3 channels); SDF mode; COLMAP captures,
cascades and contraction; JPEG input and depth supervision; the SH and
frequency encoders; the dtu format and the single transforms.json,
``--vis_pose``, data-parallel training over torch.distributed ranks
(``parallel/distributed.py``), the HTTP viewer (``viewer.py``), the entry
analogue (``entry.py``) and the recipes (``scripts/``); Orbax ``.ocp``
checkpoints, zarr v2 and zarr3 (``utils/orbax.py`` over ``utils/ocdbt.py``,
``utils/zarr.py`` and a zstd codec, ``utils/zstd.py``) without orbax or
tensorstore; and, without Pillow, every JPEG Pillow reads (baseline,
progressive, arithmetic-coded, lossless, YCCK, any integral sampling
ratio), every PNG kind, BMP, TIFF (JPEG-compressed, old-style JPEG,
CCITT fax, LZMA, zstd, ThunderScan, BigTIFF, planar and subsampled
YCbCr, signed and float samples too), GIF, WebP, netpbm, TGA, QOI, JPEG
2000, SGI, PCX, DCX, ICO, CUR, DDS (every BCn codec), FTEX, BLP, PSD
and bare DIB frames (``data/png.read_image`` by signature).  Still
raising NotImplementedError (ROADMAP A6 (j)): the other formats Pillow
reads (AVIF, ICNS, IM, ...) and the JPEG 2000 features no
writer at hand makes; old-style JPEG TIFF in planes raises ValueError
(not read); the scripts that need model weights are not ported.
"""

__version__ = "0.1.0"

import torch as _torch

# Full fp32 products everywhere: the JAX sampler and get_rays run at
# Precision.HIGHEST on purpose (ops/sampling.py, data/rays.py), and the MLPs
# run in fp32 unless cfg.fp16.  PyTorch's TF32 defaults would keep ~3 digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
