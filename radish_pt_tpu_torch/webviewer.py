"""Browser live preview over the port's ``Renderer``: the port of
``radish_pt_tpu/webviewer.py``, the graphical counterpart of the
reference's GLFW + ImGui window (``preview.cpp:137-367``,
``main.cpp:204-284``) for a headless host.

A single-file HTTP server (stdlib only) streams the display buffer as an
MJPEG ``multipart/x-mixed-replace`` stream and accepts the interactive
commands the reference binds to keys and the mouse:

* keyboard: w/s/a/d/q/e move, h/l yaw, j/k pitch, t/n/m/g/v cycle
  tracer/denoiser/tonemap/G-buffer view/denoiser AOV, [/] the luminance
  sigma, r reset accumulation, p save PNG
* mouse: drag orbits the camera (left), pans (middle) or zooms (right);
  the wheel dollies

Threading: the render loop runs on the calling thread; HTTP threads only
read the latest encoded JPEG under a condition variable and push key and
drag events onto a queue the loop drains between frames.  A frame is
computed on the renderer's device and comes to the host once, as uint8
(the JPEG encoder's input); frame k+1 is submitted before frame k is
fetched and encoded, so the fetch and the encode overlap the next frame.

Run:  python -m radish_pt_tpu_torch.viewer SCENE.txt --http 8000
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>radish_pt_tpu_torch</title><style>
body { background:#111; color:#ddd; font:13px monospace; margin:0;
       display:flex; flex-direction:column; align-items:center }
#view { margin:12px; max-width:95vw; image-rendering:pixelated;
        cursor:grab; border:1px solid #333 }
#stats { white-space:pre; padding:4px 12px }
#help { color:#777; padding:0 12px 12px }
</style></head><body>
<img id="view" src="/stream" draggable="false">
<div id="stats"></div>
<div id="help">left-drag: orbit &middot; middle-drag: pan &middot;
right-drag: zoom &middot; wheel: dolly &middot; wasdqe: move
&middot; hjkl: yaw/pitch &middot; t/n/m/g/v: tracer/denoiser/tonemap/gview/aov
&middot; [/]: luminance sigma &middot; r: reset &middot; p: save png</div>
<script>
const send = (path, body) => fetch(path, {method:'POST',
  headers:{'Content-Type':'application/json'}, body:JSON.stringify(body)});
addEventListener('keydown', e => {
  if ('wsadqehjkltnmgvrp[]'.includes(e.key)) send('/key', {key:e.key});
});
const view = document.getElementById('view');
view.addEventListener('contextmenu', e => e.preventDefault());
let drag = null;
view.addEventListener('pointerdown', e => {
  drag = [e.clientX, e.clientY, e.button];
  view.setPointerCapture(e.pointerId); });
view.addEventListener('pointermove', e => {
  if (!drag) return;
  const [x0, y0, btn] = drag; drag = [e.clientX, e.clientY, btn];
  send('/drag', {dx: e.clientX - x0, dy: e.clientY - y0, button: btn});
});
view.addEventListener('pointerup', () => drag = null);
view.addEventListener('wheel', e => { e.preventDefault();
  send('/drag', {dolly: e.deltaY > 0 ? -1 : 1}); }, {passive:false});
setInterval(async () => {
  const r = await fetch('/stats');
  document.getElementById('stats').textContent = await r.text();
}, 1000);
</script></body></html>"""


class _Shared:
    """Latest encoded frame + input event queue, shared with HTTP threads."""

    def __init__(self):
        self.cond = threading.Condition()
        self.jpeg = b""
        self.seq = 0
        self.stats = "{}"
        self.events: queue.Queue = queue.Queue()

    def publish(self, jpeg: bytes, stats: str):
        with self.cond:
            self.jpeg = jpeg
            self.stats = stats
            self.seq += 1
            self.cond.notify_all()

    def wait_frame(self, seen: int, timeout: float = 5.0):
        with self.cond:
            self.cond.wait_for(lambda: self.seq != seen, timeout=timeout)
            return self.jpeg, self.seq


def _make_handler(shared: _Shared):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/":
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stats":
                body = shared.stats.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/stream"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                seen = -1
                try:
                    while True:
                        jpeg, seen = shared.wait_frame(seen)
                        if not jpeg:
                            continue
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(jpeg)}\r\n\r\n".encode()
                        )
                        self.wfile.write(jpeg)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return
            else:
                self.send_error(404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                body = {}
            if self.path == "/key":
                shared.events.put(("key", body.get("key", "")))
            elif self.path == "/drag":
                shared.events.put(("drag", body))
            self.send_response(204)
            self.end_headers()

    return Handler


def encode_jpeg(img_u8: np.ndarray, quality: int = 85) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img_u8)).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def compute_frame(r, spp_per_frame: int = 1):
    """Submit one display frame's work on the renderer's device; returns
    (uint8 display image [H, W, 3] on the device, frames advanced).  ReSTIR
    with ``spp_per_frame`` > 1 and no denoiser runs the batched path
    (``step_batched_restir``: one block of frames, a CUDA graph on the
    card; on a mesh when W*H splits into its tiles)."""
    from .config import Denoiser, Tracer

    s = r.settings
    if (s.tracer == Tracer.RESTIR_DI and spp_per_frame > 1
            and s.denoiser == Denoiser.NONE and r.n_alloc == r.n_pixels):
        return r.step_batched_restir(spp_per_frame), spp_per_frame
    disp = None
    for _ in range(spp_per_frame):
        disp = r.step()
    return disp, spp_per_frame


def display_image(r, disp) -> np.ndarray:
    """The frame to stream, on the host: the selected denoiser AOV when
    one is live (the reference's Preview combo drives the display too),
    else ``disp``."""
    from .render import post
    from .utils import timing

    if r.settings.preview_aov != "composed":
        aov = r.preview_aov_image()
        if aov is not None:
            disp = post.to_display(aov.reshape(r.cam.height, r.cam.width, 3),
                                   tone_mapping=r.settings.tone_mapping)
    timing.host_sync()
    return disp.cpu().numpy()


def serve(r, port: int = 8000, spp_per_frame: int = 1, quality: int = 85,
          stop: threading.Event | None = None, host: str = "0.0.0.0",
          on_ready=None) -> int:
    """Serve ``Renderer`` ``r`` until Ctrl-C or ``stop`` is set.

    The render loop drains input events, steps the renderer and publishes
    JPEG frames; the accumulation goes on while the camera is still, as in
    the reference's preview loop.  ``port`` 0 takes a free port;
    ``on_ready(port)`` is called once the server listens."""
    from . import viewer as vw

    shared = _Shared()
    httpd = ThreadingHTTPServer((host, port), _make_handler(shared))
    httpd.daemon_threads = True  # an open /stream does not hold the shutdown
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    print(f"[webviewer: http://localhost:{port}/  (Ctrl-C to stop)]", flush=True)
    if on_ready is not None:
        on_ready(port)
    step = vw.move_step(r)

    def apply(kind, data):
        s = r.settings
        if kind == "drag":
            if "dolly" in data:
                vw.move(r, dz=step * 2.0 * float(data["dolly"]))
                return
            dx, dy = float(data.get("dx", 0)), float(data.get("dy", 0))
            button = int(data.get("button", 0))
            if button == 1:  # MIDDLE drag pans (main.cpp:249)
                vw.move(r, dx=-dx * step * 0.05, dy=dy * step * 0.05)
            elif button == 2:  # RIGHT drag zooms along the view axis (main.cpp:248)
                vw.move(r, dz=-dy * step * 0.05)
            else:  # LEFT drag orbits; cursorPosCallback pixels -> degrees
                vw.rotate(r, dyaw=dx * 0.25, dpitch=-dy * 0.25)
            return
        key = data
        if key in vw.MOVES:
            vw.move(r, *(c * step for c in vw.MOVES[key]))
        elif key in vw.TURNS:
            vw.rotate(r, *vw.TURNS[key])
        elif key == "t":
            s.tracer = vw.cycle(vw.tracers_of(r), s.tracer)
            r.reset_accumulation()
        elif key == "n":
            s.denoiser = vw.cycle(vw.DENOISERS, s.denoiser)
        elif key == "m":
            s.tone_mapping = vw.cycle(vw.TONEMAPS, s.tone_mapping)
        elif key == "g":
            s.gbuffer_view = vw.GVIEWS[(vw.GVIEWS.index(s.gbuffer_view) + 1)
                                       % len(vw.GVIEWS)]
        elif key == "v":
            aovs = type(r).PREVIEW_AOVS
            s.preview_aov = aovs[(aovs.index(s.preview_aov) + 1) % len(aovs)]
            print(f"[preview aov: {s.preview_aov}]")
        elif key in ("[", "]"):  # the luminance-sigma slider (preview.cpp:261-267)
            f = 0.8 if key == "[" else 1.25
            if s.denoiser == vw.Denoiser.EA_WAVELET:
                s.eaw_sig_luminance *= f
            else:
                s.svgf_sig_luminance *= f
        elif key == "r":
            r.reset_accumulation()
        elif key == "p":
            print(f"[saved {r.save()}]")

    ema_ms = ema_disp = None
    pending = None  # (device image, frames) in flight
    try:
        while stop is None or not stop.is_set():
            try:  # drain the input between frames (GLFW pollEvents)
                while True:
                    apply(*shared.events.get_nowait())
            except queue.Empty:
                pass
            t0 = time.time()
            nxt = compute_frame(r, spp_per_frame)
            if pending is None:
                pending, nxt = nxt, compute_frame(r, spp_per_frame)
            disp, n_frames = pending
            jpeg = encode_jpeg(display_image(r, disp)[:, ::-1], quality)
            dt_frame = (time.time() - t0) * 1e3
            dt = dt_frame / n_frames
            ema_ms = dt if ema_ms is None else 0.9 * ema_ms + 0.1 * dt
            ema_disp = dt_frame if ema_disp is None else 0.9 * ema_disp + 0.1 * dt_frame
            shared.publish(jpeg, f"{vw.stats_line(r)} | {1e3 / max(ema_ms, 1e-6):.1f} fps "
                                 f"({ema_ms:.1f} ms/frame, {ema_disp:.1f} ms/display)")
            pending = nxt
    except KeyboardInterrupt:
        print("\n[webviewer: stopped]")
    finally:
        httpd.shutdown()
        httpd.server_close()
    return 0
