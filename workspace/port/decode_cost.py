"""Where a small file's decode time goes on a host: the file's read (as
that checkout's read_image reads it: png.read_bytes where it exists, else
a buffered open().read()), the decode from bytes, and read_image, for the
TGA and small JPEG 2000 fixtures of the checkout at the given path.

    python3 workspace/port/decode_cost.py <checkout>

To compare two commits on one host, unpack the other with git archive into
a git-ignored directory and run other, this, this, other in one call."""
import glob
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
from nerf2mesh_tpu_torch.data import jpeg2000, tga  # noqa: E402
from nerf2mesh_tpu_torch.data import png  # noqa: E402
from nerf2mesh_tpu_torch.data.png import read_image  # noqa: E402

read_file = getattr(png, "read_bytes", None) or (
    lambda f: open(f, "rb").read())

fx = os.path.join(root, "nerf2mesh_tpu_torch", "fixtures", "formats")
sets = {"tga": sorted(glob.glob(fx + "/tga/*")),
        "j2k": [f for f in sorted(glob.glob(fx + "/jpeg2000/*"))
                if "512" not in f]}
dec = {"tga": tga.decode_tga, "j2k": jpeg2000.decode_jpeg2000}


def best(fn, files, reps=5):
    b = 1e9
    for _ in range(reps):
        t = time.perf_counter()
        for f in files:
            fn(f)
        b = min(b, time.perf_counter() - t)
    return b / len(files) * 1e6


t = time.perf_counter()
x = 0
for i in range(1000000):
    x += i
loop = (time.perf_counter() - t) * 1e3
for name, files in sets.items():
    for f in files:
        read_image(f)
    data = {f: open(f, "rb").read() for f in files}
    rd = best(read_file, files)
    dc = best(lambda f: dec[name](data[f]), files)
    ri = best(read_image, files)
    px = sum(read_image(f).shape[0] * read_image(f).shape[1] for f in files)
    print(f"{os.path.basename(root)} {name}: {len(files)} files {px} px; "
          f"read {rd:.1f} us, decode {dc:.1f} us, read_image {ri:.1f} us a "
          f"file; read_image {ri * len(files) / px * 1e3:.1f} ms per MP; "
          f"python 1e6-step loop {loop:.1f} ms", flush=True)
