"""Port parity, the viewer: `viewer/server` (frames and events over HTTP on a
free port, as tests/test_viewer.py), `core/camera`'s `Trackball` and
`Camera.set_direction` against the JAX package's on scripted pointer
sequences (eye and look-at within atol 1e-6), and `io/image.encode_jpeg`
decoded by PIL (present here, not on the card's machine): every size and
channel count decodes to the input's shape, and at 40x32 and 1200x800 the
PSNR lies within 0.5 dB of PIL's own encode at the same quality and the
byte count within 15 % of PIL's.
"""
import io
import json
import socket
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from optixpathtracer_tpu.core.camera import Camera as JaxCamera
from optixpathtracer_tpu.core.camera import Trackball as JaxTrackball
from optixpathtracer_tpu_torch.builder import compile_scene
from optixpathtracer_tpu_torch.core.camera import Camera, Trackball
from optixpathtracer_tpu_torch.core.materials import make_material
from optixpathtracer_tpu_torch.core.scene import HostScene
from optixpathtracer_tpu_torch.engine.renderer import Renderer
from optixpathtracer_tpu_torch.engine.wavefront import RenderConfig
from optixpathtracer_tpu_torch.io.image import encode_jpeg
from optixpathtracer_tpu_torch.lights.probe import build_probe
from optixpathtracer_tpu_torch.viewer.server import ViewerServer, run_interactive

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _renderer(w=32, h=24):
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    hs.add_box(make_material(color=(0.8, 0.3, 0.2)), pos=(0, 0.5, 0), extent=(0.5, 0.5, 0.5))
    cs = compile_scene(hs, CPU)
    probe = build_probe(np.full((8, 16, 3), 0.5, np.float32), CPU)
    cfg = RenderConfig(width=w, height=h, samples_per_launch=1, max_depth=1, traversal="cluster")
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=w / h)
    return Renderer(cs, probe, cfg, cam), cam


def _get(base, path):
    return urllib.request.urlopen(base + path, timeout=10).read()


def test_viewer_serves_frames_and_events():
    r, cam = _renderer()
    tb = Trackball(cam)
    server = ViewerServer(r, port=0, trackball=tb)
    server.start()
    try:
        server.publish(r.render())
        base = f"http://127.0.0.1:{server.port}"
        assert b"optixpathtracer_tpu" in _get(base, "/")
        jpg = _get(base, "/frame.jpg")
        assert jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"
        assert np.asarray(Image.open(io.BytesIO(jpg))).shape == (24, 32, 3)
        assert json.loads(_get(base, "/stats"))["frames"] == 1
        eye_before = cam.eye.copy()
        _get(base, "/event?type=wheel&d=1")
        assert server.camera_changed and not np.allclose(cam.eye, eye_before)  # zoom moved the eye
        server.camera_changed = False
        eye_before = cam.eye.copy()
        _get(base, "/event?type=down&x=5&y=5&b=0")
        _get(base, "/event?type=move&x=15&y=9&b=0")
        assert server.camera_changed and not np.allclose(cam.eye, eye_before)  # the orbit moved it
    finally:
        server.stop()


def test_trackball_orbit_preserves_distance():
    cam = Camera(eye=(3, 0, 0), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=45)
    tb = Trackball(cam)
    d0 = np.linalg.norm(cam.eye - cam.lookat)
    tb.start_tracking(0, 0)
    tb.update_tracking(40, 25, 200, 200)
    np.testing.assert_allclose(d0, np.linalg.norm(cam.eye - cam.lookat), rtol=1e-4)
    assert not np.allclose(cam.eye, (3, 0, 0))


SCRIPT = [("down", 10, 10), ("move", 30, 14), ("move", 52, -20), ("wheel", 1), ("move", 80, 40),
          ("wheel", -1), ("wheel", -1), ("down", 0, 0), ("move", -35, 60), ("move", -90, 250),
          ("move", 400, -300), ("wheel", 1)]


@pytest.mark.parametrize("gimbal_lock", [False, True])
@pytest.mark.parametrize("mode", ["lookat_fixed", "eye_fixed"])
def test_trackball_matches_jax(gimbal_lock, mode):
    """The same pointer script through both trackballs (the viewer's
    reference frame under gimbal lock): eye and look-at after every event
    within atol 1e-6; then `set_direction` on both cameras."""
    view = dict(eye=(3.0, 2.0, 4.0), lookat=(0.0, 0.4, 0.0), up=(0.0, 1.0, 0.0), fov_y=35.0,
                aspect_ratio=1.5)
    cams = Camera(**view), JaxCamera(**view)
    balls = Trackball(cams[0]), JaxTrackball(cams[1])
    for tb in balls:
        tb.view_mode = mode
        if gimbal_lock:
            tb.set_reference_frame((1, 0, 0), (0, 0, 1), (0, 1, 0))
            tb.gimbal_lock = True
    for ev in SCRIPT:
        for tb in balls:
            if ev[0] == "wheel":
                assert tb.wheel_event(ev[1])
            elif ev[0] == "down":
                tb.start_tracking(ev[1], ev[2])
            else:
                tb.update_tracking(ev[1], ev[2], 320, 200)
        for k in ("eye", "lookat"):
            np.testing.assert_allclose(getattr(cams[0], k), getattr(cams[1], k), rtol=0, atol=1e-6)
    d = np.array([0.2, -0.5, 0.84], np.float32)
    d /= np.linalg.norm(d)
    for c in cams:
        c.set_direction(d)
    np.testing.assert_allclose(cams[0].lookat, cams[1].lookat, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cams[0].direction(), d, atol=1e-6)


def test_stream_yields_a_multipart_jpeg_frame():
    """`/stream` while `run_interactive` renders: one multipart part, an
    image/jpeg of the frame's size."""
    r, cam = _renderer()
    with socket.socket() as s:  # a free port, known before the loop starts its server
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    loop = threading.Thread(target=run_interactive, args=(r, cam), kwargs=dict(port=port, max_frames=40))
    loop.start()
    try:
        while r.subframe_index == 0 and loop.is_alive():  # the server starts before the first frame
            loop.join(0.01)
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}/stream", timeout=10)
        assert resp.headers["Content-Type"] == "multipart/x-mixed-replace; boundary=frame"
        assert resp.readline() == b"--frame\r\n"
        assert resp.readline() == b"Content-Type: image/jpeg\r\n"
        size = int(resp.readline().split(b":")[1])
        assert resp.readline() == b"\r\n"
        jpg = resp.read(size)
        resp.close()
    finally:
        loop.join(60)
    assert not loop.is_alive() and r.subframe_index == 40
    assert np.asarray(Image.open(io.BytesIO(jpg))).shape == (24, 32, 3)


# ---- encode_jpeg against PIL ----------------------------------------------

@pytest.fixture(scope="module")
def frames():
    """A rendered 120x80 frame scaled to 1200x800 by nearest neighbour, and
    seeded noise of that size (RGB uint8); the cases crop their centres."""
    r, _ = _renderer(120, 80)
    rendered = np.repeat(np.repeat(r.render()[..., :3], 10, axis=0), 10, axis=1)
    noise = np.random.default_rng(5).integers(0, 256, (800, 1200, 3)).astype(np.uint8)
    return {"rendered": np.ascontiguousarray(rendered), "noise": noise}


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("quality", [50, 85, 95])
@pytest.mark.parametrize("size", [(1, 1), (33, 17), (40, 32), (1200, 800)])
@pytest.mark.parametrize("grey", [False, True])
@pytest.mark.parametrize("content", ["rendered", "noise"])
def test_encode_jpeg_against_pil(frames, content, grey, size, quality):
    w, h = size
    y0, x0 = (800 - h) // 2, (1200 - w) // 2  # a centred crop: the rendered boxes, not the sky
    img = frames[content][y0:y0 + h, x0:x0 + w]
    img = np.ascontiguousarray(img[..., 1] if grey else img)
    ours = encode_jpeg(img, quality)
    dec = np.asarray(Image.open(io.BytesIO(ours)))
    assert dec.shape == img.shape
    if size in ((40, 32), (1200, 800)):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=quality)
        pil = buf.getvalue()
        ref = np.asarray(Image.open(io.BytesIO(pil)))
        assert abs(_psnr(dec, img) - _psnr(ref, img)) <= 0.5
        assert abs(len(ours) - len(pil)) <= 0.15 * len(pil)


def test_encode_jpeg_takes_float_tensors_as_publish_converts_them(frames):
    """A float tensor in [0, 1] (values outside it clipped) encodes as the
    uint8 frame `(clip(x, 0, 1) * 255).astype(uint8)`; an RGBA frame as its
    RGB; the tables are PIL's at the same quality."""
    rgb = frames["rendered"][:32, :40]
    f = rgb.astype(np.float32) / 255.0 + 1e-4
    f[0, 0] = [-1.0, 2.0, 0.5]
    want = (np.clip(f, 0, 1) * 255).astype(np.uint8)
    assert encode_jpeg(torch.as_tensor(f)) == encode_jpeg(want)
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 7, np.uint8)], -1)
    assert encode_jpeg(rgba, 70) == encode_jpeg(rgb, 70)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=70)
    ours, pil = _segments(encode_jpeg(rgb, 70)), _segments(buf.getvalue())
    for marker in (0xDB, 0xC4, 0xC0, 0xDA):  # DQT, DHT, SOF0, SOS: PIL's tables and layout
        assert ours[marker] == pil[marker], hex(marker)


def _segments(data: bytes) -> dict:
    """marker -> the concatenated bodies of its segments, up to the scan."""
    out, i = {}, 2
    while True:
        marker, n = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        out[marker] = out.get(marker, b"") + data[i + 4:i + 2 + n]
        if marker == 0xDA:
            return out
        i += 2 + n
