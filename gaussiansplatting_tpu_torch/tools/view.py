"""Interactive viewer on PyTorch: a small web page whose frames the card
renders on demand.  Counterpart of gaussiansplatting_tpu/tools/view.py (the
reference's live GLFW window, ``--view path.ply``, main.mm:231-297,
mtl_engine.mm:89-160,401-609) with the same page, routes (``/``,
``/state``, ``/frame``, ``/train``) and flags, plus ``--device``.

The browser sends orbit-camera state (drag = orbit, wheel = dolly,
shift-drag = pan) and the server renders each frame through the same tiled
pipeline used for training (ops/rasterize.py), then sends it as a JPEG.

  python -m gaussiansplatting_tpu_torch.tools.view --ply model.ply [--port 8000]
      [--width 800 --height 600] [--fov 60] [--sh-degree 0] [--device cuda]

Interactive training (the reference's train-while-displaying run loop,
mtl_engine.mm:98-155): pass a COLMAP dataset instead of (or with) a PLY and
the page gains a "train" button + auto-train toggle that drive the real
train step (densify / opacity-reset events on the reference cadence)
between frames:

  python -m gaussiansplatting_tpu_torch.tools.view --colmap scene/sparse/0 \
      --images scene/images [--checkpoint ckpt/latest.npz] [--iters 30000]

Then open http://localhost:8000/ (ssh -L 8000:localhost:8000 for remote).
``--device cuda`` (the default) exits with an error if CUDA is unavailable.
Frames are rendered in the HTTP server's handler threads through
train/graph.render_frame (on the card a replay of the render's CUDA graph,
the counterpart of the JAX viewer's ``jax.jit(render)``; it enters
``torch.no_grad`` itself, which a handler thread would not inherit); one
lock keeps the card to one render, capture or training call at a time, and
holds the graph caches to one caller.  The other handler threads build
their cameras on the card meanwhile, which is why the captures run in
``thread_local`` mode (train/graph.py).
"""

from __future__ import annotations

import argparse
import io
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>gaussiansplatting_tpu_torch viewer</title><style>
  body { margin:0; background:#111; color:#ccc; font:13px monospace; }
  #hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px 8px;
         border-radius:4px; pointer-events:none; }
  img { display:block; margin:0 auto; image-rendering:auto; }
</style></head><body>
<div id="hud">drag = orbit · wheel = dolly · shift-drag = pan · loading…</div>
<div id="trainbar" style="position:fixed;top:8px;right:8px;background:#000a;
     padding:6px 8px;border-radius:4px;display:none">
  <button id="tbtn">train 100</button>
  <label><input type="checkbox" id="tauto"> auto</label>
  <span id="tinfo"></span>
</div>
<img id="v" draggable="false">
<script>
const img = document.getElementById('v'), hud = document.getElementById('hud');
let st = null, busy = false, dirty = true, training = false;
const tbtn = document.getElementById('tbtn'), tauto = document.getElementById('tauto'),
      tinfo = document.getElementById('tinfo');
function trainOnce(n) {
  if (training) return;
  training = true;
  fetch('/train?n=' + n).then(r => r.json()).then(j => {
    tinfo.textContent = ' it ' + j.iteration + ' loss ' + j.loss.toFixed(4) +
      ' n ' + j.num_gaussians;
    training = false; dirty = true;
    if (tauto.checked) setTimeout(() => trainOnce(n), 0);
  }).catch(() => { training = false; });
}
tbtn.addEventListener('click', () => trainOnce(100));
tauto.addEventListener('change', () => { if (tauto.checked) trainOnce(100); });
fetch('/state').then(r => r.json()).then(s => {
  st = s;
  if (s.trainable) document.getElementById('trainbar').style.display = 'block';
  tick();
});
function url() {
  return '/frame?az=' + st.az.toFixed(4) + '&el=' + st.el.toFixed(4) +
    '&r=' + st.r.toFixed(4) + '&cx=' + st.cx.toFixed(4) +
    '&cy=' + st.cy.toFixed(4) + '&cz=' + st.cz.toFixed(4);
}
function tick() {
  if (!st || busy || !dirty) { requestAnimationFrame(tick); return; }
  busy = true; dirty = false;
  const t0 = performance.now();
  fetch(url()).then(r => r.blob()).then(b => {
    img.src = URL.createObjectURL(b);
    hud.textContent = 'az ' + st.az.toFixed(2) + ' el ' + st.el.toFixed(2) +
      ' r ' + st.r.toFixed(2) + ' · ' + (performance.now() - t0).toFixed(0) + ' ms';
    busy = false; requestAnimationFrame(tick);
  }).catch(() => { busy = false; requestAnimationFrame(tick); });
}
let drag = null;
img.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY, e.shiftKey]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag || !st) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {      // pan in the camera's screen plane
    const s = st.r * 0.002;
    const ca = Math.cos(st.az), sa = Math.sin(st.az);
    st.cx += (-sa * -dx) * s; st.cz += (ca * -dx) * s; st.cy += dy * s;
  } else {
    st.az -= dx * 0.01;
    st.el = Math.max(-1.5, Math.min(1.5, st.el + dy * 0.01));
  }
  drag = [e.clientX, e.clientY, drag[2]]; dirty = true;
});
window.addEventListener('wheel', e => {
  if (!st) return;
  st.r = Math.max(0.05, st.r * Math.exp(e.deltaY * 0.001)); dirty = true;
});
</script></body></html>"""


class ViewerState:
    """Shared render state: params + render config + scene framing."""

    def __init__(self, params, cfg, width, height, fov_deg, center, radius):
        self.params = params
        self.cfg = cfg
        self.device = params.means.device
        self.width = width
        self.height = height
        self.fy = height / (2.0 * math.tan(math.radians(fov_deg) / 2.0))
        self.center = center
        self.radius = radius
        self.lock = threading.Lock()  # one device program at a time
        # interactive-training fields (attach_trainer)
        self.tstate = None
        self.cameras = None
        self.gts = None
        self.extent = 1.0
        self.total_iters = 30_000
        self.iteration = 0

    def attach_trainer(self, tstate, cameras, gts, extent, total_iters,
                       iteration=0):
        """Enable the train button: the viewer drives the REAL train step
        (densify/reset on the reference cadence) between frames, matching
        the reference's interactive-training branch (mtl_engine.mm:98-155)."""
        self.tstate = tstate
        self.cameras = cameras
        self.gts = gts
        self.extent = extent
        self.total_iters = total_iters
        self.iteration = iteration
        self.params = tstate.params

    def train(self, n: int) -> dict:
        """Run n train iterations (view order fixed, reference parity) and
        return the last step's scalar metrics."""
        from gaussiansplatting_tpu_torch.train import trainer

        n = max(1, min(int(n), 1000))
        with self.lock:
            st = self.tstate
            metrics = None
            for _ in range(n):
                v = self.iteration % len(self.cameras)
                cam, gt = self.cameras[v], self.gts[v]
                st, metrics = trainer.train_step(
                    st, cam, gt, self.cfg, self.total_iters
                )
                self.iteration += 1
                if trainer.should_densify(self.iteration, self.cfg):
                    st, _ = trainer.densify_step(
                        st, self.extent, cam.fx, self.cfg
                    )
                if trainer.should_reset_opacity(self.iteration, self.cfg):
                    st = trainer.opacity_reset_step(st, self.cfg)
            self.tstate = st
            self.params = st.params
            return {
                "iteration": self.iteration,
                "loss": float(metrics.loss),
                "psnr": float(metrics.psnr),
                "num_gaussians": int(metrics.num_gaussians),
            }

    def camera(self, az, el, r, cx, cy, cz):
        """The orbit camera of one frame, on the model's device."""
        from gaussiansplatting_tpu_torch.core import camera as camera_mod

        return camera_mod.orbit_camera(
            np.array([cx, cy, cz], np.float32), r, azimuth=az, elevation=el,
            fx=self.fy, fy=self.fy, width=self.width, height=self.height,
            device=self.device,
        )

    def render(self, cam) -> np.ndarray:
        """One frame [H, W, 3] as a host array, under the lock
        (graph.render_frame: a graph replay on the card, no autograd)."""
        from gaussiansplatting_tpu_torch.train import graph

        with self.lock:
            img, _ = graph.render_frame(self.params, cam, self.cfg.raster)
            return img.cpu().numpy()

    def frame_jpeg(self, az, el, r, cx, cy, cz, quality=85) -> bytes:
        from PIL import Image

        arr = self.render(self.camera(az, el, r, cx, cy, cz))
        buf = io.BytesIO()
        Image.fromarray(
            np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
        ).save(buf, "JPEG", quality=quality)
        return buf.getvalue()


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif u.path == "/state":
                self._send(200, "application/json", json.dumps({
                    "az": 0.0, "el": 0.3, "r": state.radius,
                    "cx": float(state.center[0]),
                    "cy": float(state.center[1]),
                    "cz": float(state.center[2]),
                    "trainable": state.tstate is not None,
                }).encode())
            elif u.path == "/train":
                if state.tstate is None:
                    self._send(400, "application/json",
                               b'{"error": "no dataset attached"}')
                    return
                q = parse_qs(u.query)
                try:
                    n = int(q.get("n", ["100"])[0])
                except ValueError:
                    n = 100
                self._send(
                    200, "application/json",
                    json.dumps(state.train(n)).encode(),
                )
            elif u.path == "/frame":
                q = parse_qs(u.query)

                def f(k, d):
                    try:
                        return float(q[k][0])
                    except (KeyError, ValueError):
                        return d

                body = state.frame_jpeg(
                    f("az", 0.0), f("el", 0.3), f("r", state.radius),
                    f("cx", state.center[0]), f("cy", state.center[1]),
                    f("cz", state.center[2]),
                )
                self._send(200, "image/jpeg", body)
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def _framing(means):
    """(center, radius) of an orbit that frames the points: their mean and
    2.5x the 90th-percentile distance from it."""
    center = means.mean(axis=0)
    spread = float(np.percentile(np.linalg.norm(means - center, axis=1), 90))
    return center, max(spread * 2.5, 1e-3)


def build_state(ply, width, height, fov, sh_degree, pair_capacity, device="cuda"):
    from gaussiansplatting_tpu_torch.config import Config, RasterConfig
    from gaussiansplatting_tpu_torch.core import gaussians as gaussians_mod
    from gaussiansplatting_tpu_torch.io import ply as ply_mod

    cloud = ply_mod.load_gaussian_ply(ply)
    params = gaussians_mod.from_arrays(
        cloud.means, cloud.log_scales, cloud.quats, cloud.raw_opacities,
        cloud.sh, device=device,
    )
    # a PLY of two scales a row holds surfels
    cfg = Config(raster=RasterConfig(
        pair_capacity=pair_capacity, sh_degree=sh_degree,
        primitive=gaussians_mod.primitive_of(params),
    ))
    return ViewerState(params, cfg, width, height, fov, *_framing(cloud.means))


def build_training_state(args):
    """Dataset-backed viewer: params come from a checkpoint (if given) or
    SfM init, and the train button drives the real schedule.  ``args``
    carries the CLI's fields, ``device`` among them."""
    from gaussiansplatting_tpu_torch.config import Config, RasterConfig
    from gaussiansplatting_tpu_torch.io.dataset import load_colmap_scene
    from gaussiansplatting_tpu_torch.train import checkpoint as ckpt_mod
    from gaussiansplatting_tpu_torch.train import state as state_mod

    device = torch.device(args.device)
    cfg = Config(raster=RasterConfig(
        pair_capacity=args.pair_capacity, sh_degree=args.sh_degree
    ))
    scene = load_colmap_scene(
        args.colmap, args.images, cfg, downscale=args.downscale, device=device
    )
    iteration = 0
    if args.checkpoint:
        tstate, saved_cfg = ckpt_mod.load(args.checkpoint, device)
        if saved_cfg is not None:
            cfg = saved_cfg
        iteration = int(tstate.opt.t)
    else:
        tstate = state_mod.create(scene.params, seed=cfg.train.seed)

    params = tstate.params
    means = params.means.detach().cpu().numpy()
    alive = params.alive.cpu().numpy()
    state = ViewerState(
        params, cfg, args.width, args.height, args.fov,
        *_framing(means[alive] if alive.any() else means),
    )
    gts = [torch.from_numpy(g).to(device) for g in scene.gt_images]
    state.attach_trainer(
        tstate, scene.cameras, gts, scene.extent, args.iters, iteration
    )
    return state


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ply", default=None, help="view a PLY (no training)")
    p.add_argument("--colmap", default=None,
                   help="COLMAP sparse dir — enables interactive training")
    p.add_argument("--images", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="resume training state from this .npz")
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--iters", type=int, default=30_000,
                   help="total-iteration horizon for the LR schedule")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--sh-degree", type=int, default=0, choices=(0, 1, 2, 3),
                   help="SH degree to render at (the PLY must hold its bands)")
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--device", default="cuda",
                   help="torch device to render and train on (default cuda; no fallback)")
    return p


def main(argv=None) -> int:
    from gaussiansplatting_tpu_torch.tools.render import _device

    args = build_parser().parse_args(argv)
    _device(args.device)
    if args.colmap:
        if not args.images:
            raise SystemExit("error: --colmap needs --images")
        state = build_training_state(args)
    elif args.ply:
        state = build_state(
            args.ply, args.width, args.height, args.fov, args.sh_degree,
            args.pair_capacity, args.device,
        )
    else:
        raise SystemExit("error: pass --ply or --colmap/--images")
    srv = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(state))
    print(f"viewer at http://localhost:{args.port}/ "
          f"({state.width}x{state.height}, n={int(state.params.alive.sum())}, "
          f"{state.device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
