"""The port's browser live preview (radish_pt_tpu_torch/webviewer.py):
the HTTP layer's three cases of tests/test_webviewer.py with a stub frame
source, then frames from a CPU ``Renderer`` at 16x16."""

import json
import os
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from radish_pt_tpu_torch import webviewer as wv  # noqa: E402

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


@pytest.fixture()
def server():
    shared = wv._Shared()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), wv._make_handler(shared))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield shared, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


def test_page_and_stats(server):
    shared, base = server
    shared.publish(b"xx", "iter 3 | 12.0 ms/frame")
    page = urllib.request.urlopen(f"{base}/", timeout=5).read()
    assert b"/stream" in page and b"keydown" in page
    stats = urllib.request.urlopen(f"{base}/stats", timeout=5).read()
    assert b"12.0 ms/frame" in stats


def test_stream_delivers_published_frame(server):
    shared, base = server
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :, 0] = 200
    jpeg = wv.encode_jpeg(img)
    shared.publish(jpeg, "{}")
    resp = urllib.request.urlopen(f"{base}/stream", timeout=30)
    head = resp.read(len(jpeg) + 200)
    assert b"image/jpeg" in head
    assert jpeg[:16] in head


def test_key_and_drag_enqueue(server):
    shared, base = server
    for path, body in (("/key", {"key": "w"}), ("/drag", {"dx": 3, "dy": -2})):
        req = urllib.request.Request(f"{base}{path}", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        assert urllib.request.urlopen(req, timeout=5).status == 204
    kinds = [shared.events.get_nowait(), shared.events.get_nowait()]
    assert kinds[0] == ("key", "w")
    assert kinds[1][0] == "drag" and kinds[1][1]["dx"] == 3


@pytest.fixture()
def renderer():
    from radish_pt_tpu_torch.render.renderer import Renderer
    from radish_pt_tpu_torch.scene.build import load_scene

    ds, cam, desc = load_scene(os.path.join(SCENES, "cornell_box.txt"), device="cpu")
    return Renderer(ds=ds, cam=cam.replace(width=16, height=16), desc=desc, device="cpu")


def test_compute_frame_over_cpu_renderer(renderer):
    """``compute_frame``: two frames of the path tracer a display, a uint8
    display tensor on the renderer's device; ReSTIR with more than one
    frame a display takes the batched path."""
    from radish_pt_tpu_torch.config import Tracer

    disp, n = wv.compute_frame(renderer, 2)
    assert n == 2 and renderer.state.iteration == 2
    assert disp.dtype == torch.uint8 and disp.shape == (16, 16, 3) and disp.device.type == "cpu"
    img = wv.display_image(renderer, disp)
    assert isinstance(img, np.ndarray) and img.max() > 0
    assert wv.encode_jpeg(img[:, ::-1])[:2] == b"\xff\xd8"
    renderer.settings.tracer = Tracer.RESTIR_DI
    renderer.last_runner = None
    wv.compute_frame(renderer, 2)
    assert renderer.last_runner is not None and renderer.state.iteration == 4


def test_serve_streams_renderer_frames(renderer):
    """``serve`` on port 0 streams JPEG frames of the renderer, applies a
    posted key, and stops when asked."""
    stop, ports = threading.Event(), []
    th = threading.Thread(target=wv.serve, args=(renderer,), daemon=True,
                          kwargs=dict(port=0, stop=stop, host="127.0.0.1",
                                      on_ready=ports.append))
    th.start()
    deadline = time.time() + 30
    while not ports and time.time() < deadline:
        time.sleep(0.01)
    base = f"http://127.0.0.1:{ports[0]}"
    head = urllib.request.urlopen(f"{base}/stream", timeout=30).read(800)
    assert b"image/jpeg" in head and b"\xff\xd8" in head
    req = urllib.request.Request(f"{base}/key", data=json.dumps({"key": "n"}).encode(),
                                 headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=5)
    while renderer.settings.denoiser == 0 and time.time() < deadline:
        time.sleep(0.01)
    stop.set()
    th.join(30)
    assert not th.is_alive() and renderer.settings.denoiser == 1
