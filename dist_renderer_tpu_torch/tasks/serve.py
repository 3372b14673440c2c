"""A small render server: loads a decoder once and answers JSON render
requests over HTTP, one render on the card at a time.

    python -m dist_renderer_tpu_torch.tasks.serve --fast --port 8765 --img 256 &
    curl -s localhost:8765/health
    curl -s -X POST localhost:8765/render -d '{"azimuth": 30, "elevation": 20}' \\
        -o view.png                                  # depth/normal/sil panel
    curl -s -X POST localhost:8765/render -d '{"format": "json"}' | head -c 200

Request fields (all optional): latent (list[float]), azimuth, elevation,
distance, format ("png" panel | "json" raw arrays).
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch


def build_engine(args):
    """-> (do_render(latent, azimuth, elevation, distance), latent0, dcfg).
    Renders once at start-up, so the first request finds the kernels
    built."""
    from dist_renderer_tpu_torch.models.decoder import make_precise_sdf
    from dist_renderer_tpu_torch.ops.renderer import make_march_factory, render
    from dist_renderer_tpu_torch.tasks.common import (
        default_camera, load_task_decoder, make_render_cfg, synchronize,
        task_device,
    )

    dev = task_device(args)
    params, latent0, dcfg = load_task_decoder(args)
    cfg = make_render_cfg(args)
    sdf_fn = make_precise_sdf(params, dcfg)
    factory = make_march_factory(params, dcfg, cfg)
    lock = threading.Lock()  # one render on the card at a time

    def do_render(latent, azimuth, elevation, distance):
        cam = default_camera(args.img, distance, (elevation, azimuth), dev)
        with lock, torch.no_grad():
            out = render(sdf_fn, torch.as_tensor(latent, dtype=torch.float32,
                                                 device=dev), cam, cfg, factory)
            synchronize(dev)
        return out

    do_render(latent0, 30.0, 20.0, 2.2)
    return do_render, latent0, dcfg


def make_handler(do_render, latent0, args, device_name: str):
    """The HTTP handler class: GET /health, POST /render. A failed request
    answers 400 with the error."""
    from dist_renderer_tpu_torch.utils.viz import png_bytes, render_panel

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, json.dumps({
                    "status": "ok", "latent_size": int(latent0.shape[0]),
                    "img": args.img, "device": device_name}).encode())
            else:
                self._send(404, b'{"error": "use GET /health or POST /render"}')

        def do_POST(self):
            if self.path != "/render":
                self._send(404, b'{"error": "POST /render"}')
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                out = do_render(
                    req["latent"] if "latent" in req else latent0,
                    float(req.get("azimuth", 30.0)),
                    float(req.get("elevation", 20.0)),
                    float(req.get("distance", 2.2)))
                if req.get("format", "png") == "json":
                    self._send(200, json.dumps({
                        "depth": out.depth.cpu().tolist(),
                        "mask": out.mask.cpu().to(torch.int32).tolist(),
                    }).encode())
                else:
                    self._send(200, png_bytes(render_panel(out)), "image/png")
            except Exception as e:  # noqa: BLE001 (report, keep serving)
                self._send(400, json.dumps({"error": str(e)}).encode())

    return Handler


def main(argv=None):
    from dist_renderer_tpu_torch.tasks.common import add_common_args, task_device

    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args(argv)

    do_render, latent0, _ = build_engine(args)
    dev = task_device(args)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    srv = ThreadingHTTPServer((args.host, args.port),
                              make_handler(do_render, latent0, args, name))
    print(f"serving on http://{args.host}:{args.port}  (GET /health, POST /render)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
