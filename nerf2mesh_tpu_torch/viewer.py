"""Interactive viewer over HTTP (port of nerf2mesh_tpu/viewer.py, the
browser analog of the reference GUI, nerf/gui.py NeRFGUI).

The page (drag to orbit, wheel to zoom, sliders for dt_gamma, max_steps
and the box) asks the server for frames: ``/render?theta&phi&radius``
returns a PNG (data/png.py) rendered from the trainer's current state,
stage 0 through ``render_image(stochastic=True)`` (the 1-corner encode
estimate of training) and stage 1 through ``render_image_stage1``;
``/option?dtg&mst&bnd`` sets the render options; ``/status`` reports the
training thread.  A controller halves the frame size when a frame takes
longer than the budget (500 ms) and doubles it when it takes under a
quarter of it, leaving out the first frame at each new shape (its one-off
costs).  With a training dataset (``--viewer_train``, stage 0) a thread
trains 16 steps at a time until cfg.iters, then saves a checkpoint.  One
lock covers every use of the trainer's state (training, rendering, option
changes), and the CUDA work of the HTTP threads runs on the trainer's
device.

Usage:
    python -m nerf2mesh_tpu_torch.viewer <data dir> --workspace <ws> [flags]
then open http://localhost:7007/.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>nerf2mesh live viewer</title>
<style>body{margin:0;background:#111;color:#ccc;font-family:monospace}
#img{width:100vw;height:100vh;object-fit:contain;image-rendering:pixelated}
#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud">drag orbit / wheel zoom<br/><span id="train"></span><br/>
dt_gamma <input id="dtg" type="range" min="0" max="0.1" step="0.005" value="0" style="width:90px"/>
<span id="dtgv">0</span><br/>
max_steps <input id="mst" type="range" min="4" max="10" step="1" value="10" style="width:90px"/>
<span id="mstv">1024</span><br/>
bound <input id="bnd" type="range" min="0.1" max="1" step="0.05" value="1" style="width:90px"/>
<span id="bndv">1.0</span></div>
<img id="img"/>
<script>
for(const [id, vid, f] of [["dtg","dtgv",v=>v],["mst","mstv",v=>1<<v],["bnd","bndv",v=>v]]){
  const el=document.getElementById(id);
  el.addEventListener('change',async()=>{
    const v=f(parseFloat(el.value));
    document.getElementById(vid).textContent=v;
    await fetch(`/option?${id}=${v}`); refresh();
  });
}
let theta=1.2, phi=0.5, radius=2.5, busy=false, pending=false;
const img=document.getElementById('img'), hud=document.getElementById('hud');
async function refresh(){
  if(busy){pending=true;return} busy=true;
  const t0=performance.now();
  const r=await fetch(`/render?theta=${theta}&phi=${phi}&radius=${radius}`);
  const blob=await r.blob();
  img.src=URL.createObjectURL(blob);
  hud.textContent=`theta=${theta.toFixed(2)} phi=${phi.toFixed(2)} r=${radius.toFixed(2)} ${(performance.now()-t0).toFixed(0)}ms`;
  busy=false; if(pending){pending=false;refresh();}
}
let drag=false,px=0,py=0;
addEventListener('pointerdown',e=>{drag=true;px=e.clientX;py=e.clientY});
addEventListener('pointerup',()=>drag=false);
addEventListener('pointermove',e=>{if(!drag)return;
  phi-=(e.clientX-px)*0.01;
  theta=Math.min(3.1,Math.max(0.05,theta-(e.clientY-py)*0.01));
  px=e.clientX;py=e.clientY;refresh();});
addEventListener('wheel',e=>{radius*=Math.exp(e.deltaY*0.001);refresh();});
refresh();
setInterval(async()=>{
  const s=await(await fetch('/status')).json();
  if(s.step!==undefined){
    document.getElementById('train').textContent=
      `train ${s.step}/${s.iters} loss=${s.loss.toExponential(2)} `+
      `psnr=${s.psnr.toFixed(1)} ${s.steps_per_sec.toFixed(1)} it/s`+
      (s.done?' [done]':'');
    if(!s.done) refresh();
  }
},2000);
</script></body></html>"""


class ViewerServer:
    """The HTTP server over a Trainer (see the module docstring).  port 0
    picks a free port (self.port holds the one bound); ``start()`` serves
    from a background thread, ``serve()`` in the caller's, ``close()``
    stops the training thread and the server."""

    def __init__(self, trainer, dataset, port: int = 7007,
                 budget_ms: float = 500.0, train_dataset=None,
                 host: str = "0.0.0.0"):
        self.trainer = trainer
        self.dataset = dataset
        self.budget_ms = budget_ms
        self.downscale = 4            # dynamic, as gui.py:158-163
        self._shapes_seen = set()     # (stage, H, W) already rendered once
        self.lock = threading.Lock()
        self.train_dataset = train_dataset
        self.train_status = {}
        self.train_error: Optional[str] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.httpd = ThreadingHTTPServer((host, port), self._handler())
        self.port = self.httpd.server_address[1]

    def _on_device(self):
        dev = self.trainer.device
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def _train_loop(self):
        """16 training steps per turn of the lock (the reference GUI's train
        mode, gui.py:106-128) until cfg.iters or close(), then a
        checkpoint."""
        t = self.trainer
        try:
            with self._on_device():
                while not self._stop.is_set() and t.step < t.cfg.iters:
                    t0 = time.perf_counter()
                    with self.lock:
                        m = t.train_steps(self.train_dataset, 16)
                        loss, psnr = float(m["loss"]), float(m["psnr"])
                    self.train_status = {
                        "step": int(t.step), "iters": int(t.cfg.iters),
                        "loss": loss, "psnr": psnr,
                        "steps_per_sec": 16.0 / max(
                            time.perf_counter() - t0, 1e-6)}
                    time.sleep(0.005)     # let waiting renders take the lock
                with self.lock:
                    t.save_checkpoint()
            self.train_status = dict(self.train_status, done=True)
        except Exception:              # the server keeps serving frames
            self.train_error = traceback.format_exc()
            self.train_status = dict(self.train_status, error=True)
            print(f"[viewer] training stopped:\n{self.train_error}",
                  file=sys.stderr, flush=True)

    def set_option(self, q) -> None:
        import dataclasses
        t = self.trainer
        with self.lock:
            if "dtg" in q:
                t.render_spec = dataclasses.replace(
                    t.render_spec, dt_gamma=float(q["dtg"][0]))
            if "mst" in q:
                t.render_spec = dataclasses.replace(
                    t.render_spec, max_steps=int(float(q["mst"][0])))
            if "bnd" in q:
                b = t.cfg.bound * float(q["bnd"][0])
                t.update_aabb(np.array([-b] * 3 + [b] * 3, np.float32))

    def frame_shape(self):
        """(H, W) of the next frame at the controller's downscale."""
        ds = self.dataset
        return (max(ds.H // self.downscale, 32),
                max(ds.W // self.downscale, 32))

    def render_frame(self, theta: float, phi: float, radius: float) -> bytes:
        """One frame from the orbit pose as PNG bytes; adjusts the
        downscale to the budget."""
        from .data.png import encode_png
        from .data.rays import make_mvps, make_projection, orbit_pose
        t = self.trainer
        H, W = self.frame_shape()
        intr = self.dataset.intrinsics_for(0) / self.downscale
        pose = orbit_pose(theta, phi, radius)
        t0 = time.perf_counter()
        with self.lock, self._on_device():
            if t.cfg.stage > 0:
                proj = make_projection(H, W, float(intr[1]), t.cfg.min_near)
                mvp = make_mvps(proj, pose[None])[0]
                out = t.render_image_stage1(pose, mvp, intr, H, W)
            else:
                out = t.render_image(pose, intr, H, W, stochastic=True)
        dt_ms = (time.perf_counter() - t0) * 1000
        key = (t.cfg.stage, H, W)
        if key not in self._shapes_seen:
            self._shapes_seen.add(key)
        elif dt_ms > self.budget_ms and self.downscale < 16:
            self.downscale *= 2
        elif dt_ms < self.budget_ms / 4 and self.downscale > 1:
            self.downscale //= 2
        return encode_png((np.clip(out["image"], 0, 1) * 255).astype(np.uint8))

    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                kind = "application/json"
                if u.path == "/":
                    body, kind = _PAGE.encode(), "text/html"
                elif u.path == "/render":
                    body = viewer.render_frame(
                        float(q.get("theta", [1.2])[0]),
                        float(q.get("phi", [0.5])[0]),
                        float(q.get("radius", [2.5])[0]))
                    kind = "image/png"
                elif u.path == "/option":
                    # the reference GUI's sliders (gui.py:329-366)
                    viewer.set_option(q)
                    body = b"{}"
                elif u.path == "/status":
                    body = json.dumps(viewer.train_status).encode()
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", kind)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler

    def _start_training(self):
        if self.train_dataset is not None:
            th = threading.Thread(target=self._train_loop, daemon=True)
            th.start()
            self._threads.append(th)

    def start(self) -> int:
        """Serve from a background thread (and start training); returns
        the port."""
        self._start_training()
        th = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        th.start()
        self._threads.append(th)
        return self.port

    def serve(self) -> None:
        """Serve in this thread until interrupted."""
        self._start_training()
        print(f"[viewer] http://localhost:{self.port}/", flush=True)
        try:
            self.httpd.serve_forever()
        finally:
            self.close()

    def close(self, timeout: float = 600.0) -> None:
        """Stop the training thread (after its current 16 steps and its
        checkpoint) and the server; raises if a thread outlives
        timeout."""
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        for th in self._threads:
            th.join(timeout)
            if th.is_alive():
                raise RuntimeError(f"viewer thread {th.name} did not stop")
        self._threads = []


def main(argv=None, device=None, port: int = 7007):
    """The viewer of the checkpoint in --workspace (stage 1: its mesh
    too); --viewer_train trains stage 0 behind the frames."""
    from .config import parse_args
    from .main import dataset_loader
    from .utils.trainer import Trainer

    cfg = parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("nerf2mesh_tpu_torch.viewer: no CUDA device "
                             "found (from Python, main(argv, device='cpu'))")
        device = "cuda:0"
    load_dataset = dataset_loader(cfg)
    ds = load_dataset(cfg, split="val")
    trainer = Trainer(cfg, device=device)
    if cfg.stage > 0:
        # before the checkpoint load, so that a stage-1 checkpoint's offsets
        # find their parameter (JAX's viewer sets it up after the load and
        # drops them)
        trainer.setup_stage1(ds)
    if not trainer.load_checkpoint():
        print("[viewer] WARNING: no checkpoint found; rendering the untrained "
              "model", flush=True)
    train_ds = None
    if cfg.viewer_train:
        if cfg.stage > 0:
            print("[viewer] WARNING: --viewer_train trains stage 0 only",
                  flush=True)
        else:
            train_ds = load_dataset(cfg, split="train")
            if cfg.mark_untrained:
                trainer.mark_untrained(train_ds)
    ViewerServer(trainer, ds, port=port, train_dataset=train_ds).serve()


if __name__ == "__main__":
    main(sys.argv[1:])
