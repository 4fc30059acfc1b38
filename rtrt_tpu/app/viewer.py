"""Interactive HTTP viewer: MJPEG-less live stream + keyboard/mouse input.

The presentation shell: where the reference blits the CUDA surface into a
Vulkan swapchain with external semaphores
(reference: src/main.cu:1295-1395, 2300-2422), a headless host has no
display —
the equivalent "DCN to the display" (SURVEY.md §5.8) is a device->host
frame copy streamed over HTTP to a browser.  Pure stdlib (http.server);
frames are sent as PNG (our zlib writer) over a multipart stream, and the
page forwards WASD/mouse to the Engine's input API + renders the runtime
parameter panel generically from PARAM_REGISTRY (the reference's
reflection-driven ImGui panel, src/ui.cpp:20-108).

Usage: python -m rtrt_tpu.app.viewer --scene terrain --port 8000
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!DOCTYPE html>
<html><head><title>rtrt_tpu</title><style>
body { background:#111; color:#ccc; font-family:monospace; margin:0; display:flex }
#view { image-rendering:pixelated; width:75vw; }
#panel { padding:12px; width:25vw; overflow-y:auto }
.row { margin:4px 0 } input[type=range] { width:140px }
</style></head><body>
<img id="view" src="/stream">
<div id="panel"><h3>rtrt_tpu</h3><div id="stats"></div><div id="params"></div>
<p>WASD move, C/X up/down, drag to look.</p></div>
<script>
const send = (o) => fetch('/input', {method:'POST', body:JSON.stringify(o)});
onkeydown = e => send({key:e.key, down:true});
onkeyup = e => send({key:e.key, down:false});
let dragging=false, lx=0, ly=0;
const v = document.getElementById('view');
v.onmousedown = e => {dragging=true; lx=e.clientX; ly=e.clientY};
onmouseup = () => dragging=false;
onmousemove = e => { if(dragging){ send({cursor:[e.clientX, e.clientY]}); } };
fetch('/params').then(r=>r.json()).then(ps=>{
  const d = document.getElementById('params');
  for (const p of ps) {
    const row = document.createElement('div'); row.className='row';
    row.innerHTML = `${p.label}: <input type=range min=${p.min} max=${p.max}
      step=${(p.max-p.min)/200} value=${p.value}
      oninput="send({param:'${p.path}', value:parseFloat(this.value)})">`;
    d.appendChild(row);
  }
});
setInterval(()=>fetch('/stats').then(r=>r.json()).then(s=>{
  document.getElementById('stats').innerText =
    `${s.fps.toFixed(1)} fps @ ${s.w}x${s.h}`;}), 1000);
</script></body></html>"""


class ViewerServer:
    """Runs the Engine in a render thread; serves frames + accepts input."""

    def __init__(self, engine, port: int = 8000):
        self.engine = engine
        self.port = port
        self._latest_png = b""
        self._lock = threading.Lock()
        self._running = True

    def _render_loop(self):
        from ..utils.image import write_png
        min_dt = 1.0 / max(self.engine.settings.frame_cap_fps, 1.0)
        while self._running:
            self.engine.timer.update_with_limiter(min_dt)  # 75-fps cap analog
            img = self.engine.render_frame(dt=max(self.engine.timer.delta,
                                                  1e-3))
            buf = io.BytesIO()
            # write_png wants a path; reuse its encoder via a temp buffer
            import numpy as np
            from ..utils import image as im
            import struct, zlib
            a = np.asarray(img)
            h, w = a.shape[:2]

            def chunk(tag, data):
                body = tag + data
                return struct.pack(">I", len(data)) + body + \
                    struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

            raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))
            png = (b"\x89PNG\r\n\x1a\n"
                   + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                   + chunk(b"IDAT", zlib.compress(raw, 1))
                   + chunk(b"IEND", b""))
            with self._lock:
                self._latest_png = png

    def serve(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "multipart/x-mixed-replace; boundary=f")
                    self.end_headers()
                    try:
                        while viewer._running:
                            with viewer._lock:
                                png = viewer._latest_png
                            if png:
                                self.wfile.write(
                                    b"--f\r\nContent-Type: image/png\r\n"
                                    + f"Content-Length: {len(png)}\r\n\r\n".encode()
                                    + png + b"\r\n")
                            time.sleep(0.05)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                elif self.path == "/params":
                    from ..utils.config import PARAM_REGISTRY, get_param
                    ps = [dict(path=p, label=lab, min=lo, max=hi,
                               value=float(get_param(viewer.engine.params, p)))
                          for (p, lab, _w, lo, hi, _l) in PARAM_REGISTRY]
                    body = json.dumps(ps).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stats":
                    body = json.dumps(dict(
                        fps=viewer.engine.timer.fps,
                        w=viewer.engine.render_w,
                        h=viewer.engine.render_h)).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path == "/input":
                    n = int(self.headers.get("Content-Length", 0))
                    msg = json.loads(self.rfile.read(n))
                    if "key" in msg:
                        viewer.engine.key_event(msg["key"], msg["down"])
                    elif "cursor" in msg:
                        viewer.engine.cursor_event(*msg["cursor"])
                    elif "param" in msg:
                        from ..utils.config import set_param
                        viewer.engine.params = set_param(
                            viewer.engine.params, msg["param"], msg["value"])
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_error(404)

        t = threading.Thread(target=self._render_loop, daemon=True)
        t.start()
        server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        print(f"viewer at http://localhost:{self.port}/")
        try:
            server.serve_forever()
        finally:
            self._running = False


def main(argv=None):
    p = argparse.ArgumentParser(description="rtrt_tpu interactive viewer")
    p.add_argument("--config", default=None)
    p.add_argument("--scene", default="demo")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=270)
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)

    import dataclasses
    from ..engine.engine import Engine
    from ..utils.config import GlobalSettings, load_config

    settings = dataclasses.replace(
        load_config(args.config), scene=args.scene,
        render_width=args.width, render_height=args.height)
    ViewerServer(Engine(settings), args.port).serve()


if __name__ == "__main__":
    main()
