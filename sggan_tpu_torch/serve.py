"""HTTP translate service, port of ``sggan_tpu/serve.py``.

POST a PNG to /translate and receive the translated PNG; GET /healthz for
liveness.  Same routes, resize, input convention and uint8 conversion as
the JAX service.  The deployment artifact is a ``torch.export`` program of
the whole test-time generator (``utils/export.py``) that reloads and runs
without the model's Python: pass it as ``--artifact``.  Without one the
service builds the trainer's generator from the latest checkpoint.

    # one-time: bake checkpoint + test-time input convention into a file
    python -m sggan_tpu_torch.serve --export --artifact gen.pt2 \
        --checkpoint_dir ./checkpoint --dataset_dir city --use_resnet
    # serve it
    python -m sggan_tpu_torch.serve --artifact gen.pt2 --use_resnet

As the JAX service does, it serves the latest ``cp-NNNN.pt`` under
``--checkpoint_dir`` (``checkpoint_loaded: true``) or, with none, the
trainer's fresh init: the EMA shadow under ``--gen_ema``, the generator
of ``--which_direction`` under ``--loss_mode cycle``, the pix2pix batch
norms on their moving stats (``Trainer.generate``).

The device is explicit.  The CLI serves on ``cuda``; a missing GPU is an
error, never a quiet move to the CPU.  An artifact runs on the device it
was exported on.  On the card either forward is one CUDA graph of the
(1, H, W, 3) request, captured at start-up, the analog of the JAX
service's compiled forward; requests take the lock that serialises them
on the one graph.
"""

from __future__ import annotations

import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch
from PIL import Image

from .config import Config, build_parser, config_from_namespace


def _trainer(cfg: Config, device):
    """The test-phase trainer with the latest checkpoint loaded, and
    whether one was found (serve.py:84-93)."""
    from .train.trainer import Trainer
    from .utils import checkpoint as ckpt

    trainer = Trainer(cfg.replace(phase="test"), device)
    restored = ckpt.load(trainer.state, cfg.checkpoint_dir, cfg.dataset_dir,
                         pool=False)
    if restored is not None:
        trainer.state = restored
    return trainer, restored is not None


def export_artifact(cfg: Config, path: str, device="cuda") -> bool:
    """Load the latest checkpoint and export the whole test-time generator
    (``round(x * 255)`` under ``--test_uint8_input``, model.py:555-561;
    ``--eval_sharpen``) at (1, H, W, 3) f32 on ``device`` to ``path``:
    what ``Trainer.generate`` serves.  Returns checkpoint_loaded."""
    from .train import evaluate
    from .utils import export as gexport

    trainer, loaded = _trainer(cfg, device)
    gen, gen_bn = evaluate.eval_generator(trainer), trainer.state.gen_bn

    class TestTimeForward(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gen = gen

        def forward(self, x):  # x: (1, H, W, 3) float32 in [0, 1]
            if cfg.test_uint8_input:
                x = torch.round(x * 255.0)
            y = evaluate.gen_forward(cfg, self.gen, x, gen_bn)
            if cfg.eval_sharpen != 1.0:
                y = evaluate.sharpen(y, cfg.eval_sharpen)
            return y

    x = torch.zeros((1, cfg.image_height, cfg.image_width, 3),
                    dtype=torch.float32, device=trainer.device)
    gexport.save(path, gexport.export_fn(TestTimeForward(), x),
                 meta={"checkpoint_loaded": loaded})
    return loaded


class _Service:
    def __init__(self, cfg: Config, device="cuda",
                 artifact: Optional[str] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is visible")
        h, w = cfg.image_height, cfg.image_width
        self.artifact = bool(artifact) and os.path.exists(artifact)
        if self.artifact:
            # deployment path: the exported program, no model Python, the
            # checkpoint and input convention baked in at export time
            from .utils import export as gexport
            program = gexport.load(artifact, self.device)
            if program.input_shapes != [(1, h, w, 3)]:
                raise ValueError(f"{artifact} takes {program.input_shapes}, "
                                 f"not the configured (1, {h}, {w}, 3)")
            self.loaded = bool(program.meta.get("checkpoint_loaded"))
            self._fn = lambda x: program(x).cpu().numpy()
        else:
            from .train import evaluate
            trainer, self.loaded = _trainer(cfg, self.device)
            # what Trainer.generate runs, taken once, through its graphs
            self.gen = evaluate.eval_generator(trainer)
            self.gen_bn = trainer.state.gen_bn
            self._fn = lambda x: evaluate.generate(
                cfg, self.gen, x, self.device, gen_bn=self.gen_bn,
                graphs=trainer.fwd_graphs)
        self.device_name = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu")
        self._lock = threading.Lock()
        # warm the kernel build and cuDNN's algorithm choice, and on the
        # card capture the forward's CUDA graph
        self._fn(np.zeros((1, h, w, 3), np.float32))

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
                    "artifact": service.artifact,
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
          artifact: Optional[str] = None):
    service = _Service(cfg, device=device, artifact=artifact)
    httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(service))
    print(f"serving on :{httpd.server_address[1]} "
          f"(device={service.device_name} "
          f"checkpoint_loaded={service.loaded} artifact={service.artifact})")
    if block:
        httpd.serve_forever()
    return httpd


def main(argv=None, device="cuda"):
    p = build_parser()
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--artifact", default=None,
                   help="torch.export generator artifact; used when the "
                        "file exists, created by --export")
    p.add_argument("--export", action="store_true",
                   help="export the artifact to --artifact and exit")
    ns = p.parse_args(argv)
    cfg = config_from_namespace(ns)
    if ns.export:
        if not ns.artifact:
            p.error("--export requires --artifact PATH")
        loaded = export_artifact(cfg, ns.artifact, device)
        print(f"exported {ns.artifact} (checkpoint_loaded={loaded})")
        return
    serve(cfg, ns.port, device=device, artifact=ns.artifact)


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
