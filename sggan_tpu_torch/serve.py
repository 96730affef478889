"""HTTP translate service, port of ``sggan_tpu/serve.py``.

POST a PNG to /translate and receive the translated PNG; GET /healthz for
liveness.  Same routes, resize, input convention and uint8 conversion as
the JAX service.

    python -m sggan_tpu_torch.serve --use_resnet --img_height 256 \
        --img_width 512 --port 8000

Every generator the CLI selects serves: the ResNet (``--use_resnet``),
the pix2pix U-Net (``--use_pix2pix``, batch norm on its moving stats) or
the default U-Net.

The JAX service's checkpoints (Orbax) and AOT artifacts (StableHLO) need
JAX to read, so this service serves a fresh init drawn from
``--data_seed`` (``checkpoint_loaded: false``, as the JAX service reports
when it finds no checkpoint), or a ``state_dict`` that a caller converts
from JAX parameters with ``utils.bridge.params_from_jax``.  ``--export``
and ``--artifact`` are refused until the export is ported.

The device is explicit.  The CLI serves on ``cuda``; a missing GPU is an
error, never a quiet move to the CPU.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional

import numpy as np
import torch
from PIL import Image

from .config import Config, build_parser, config_from_namespace
from .train import evaluate

_EXPORT_TODO = ("not ported yet (ROADMAP Queue 1: AOT export via "
                "torch.export)")


class _Service:
    def __init__(self, cfg: Config, device="cuda",
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is visible")
        gen = evaluate.build_generator(cfg)
        self.loaded = state_dict is not None
        if self.loaded:
            gen.load_state_dict(state_dict)
        self.gen = gen.to(self.device).eval()
        # the pix2pix batch norms' fresh moving stats, as the JAX
        # service's fresh train state holds them; {} for the other nets
        self.gen_bn = gen.init_bn_state(self.device)
        self.device_name = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        self._lock = threading.Lock()
        h, w = cfg.image_height, cfg.image_width
        # warm the kernel build and cuDNN's algorithm choice
        self._fn(np.zeros((1, h, w, 3), np.float32))

    def _fn(self, x: np.ndarray) -> np.ndarray:
        return evaluate.generate(self.cfg, self.gen, x, self.device,
                                 gen_bn=self.gen_bn)

    def translate_png(self, png_bytes: bytes) -> bytes:
        img = Image.open(io.BytesIO(png_bytes)).convert("RGB")
        h, w = self.cfg.image_height, self.cfg.image_width
        img = img.resize((w, h), Image.BILINEAR)
        x = np.asarray(img, np.float32)[None] / 255.0
        with self._lock:  # one device stream
            fake = self._fn(x)
        out = ((fake[0] + 1.0) / 2.0 * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(out).save(buf, format="PNG")
        return buf.getvalue()


def make_handler(service: _Service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({
                    "ok": True, "checkpoint_loaded": service.loaded,
                    "artifact": False,
                    "backend": service.device.type,
                    "device": service.device_name,
                    "image_size": list(service.cfg.image_size),
                }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/translate":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            try:
                out = service.translate_png(data)
            except Exception as e:
                self.send_error(400, f"{type(e).__name__}: {e}")
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

    return Handler


def serve(cfg: Config, port: int = 8000, block: bool = True, device="cuda",
          state_dict: Optional[Mapping[str, torch.Tensor]] = None):
    service = _Service(cfg, device=device, state_dict=state_dict)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(service))
    print(f"serving on :{httpd.server_address[1]} "
          f"(device={service.device_name} "
          f"checkpoint_loaded={service.loaded})")
    if block:
        httpd.serve_forever()
    return httpd


def main(argv=None):
    p = build_parser()
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--artifact", default=None,
                   help=f"AOT-exported generator artifact: {_EXPORT_TODO}")
    p.add_argument("--export", action="store_true",
                   help=f"export the artifact and exit: {_EXPORT_TODO}")
    ns = p.parse_args(argv)
    if ns.export or ns.artifact:
        p.error(f"--export/--artifact: {_EXPORT_TODO}")
    serve(config_from_namespace(ns), ns.port, device="cuda")


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
