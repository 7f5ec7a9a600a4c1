"""Batch scoring service (counterpart of serve.py): a training run's weights
loaded once and kept on the card, videos scored over HTTP.

    python -m dfd_clip_tpu_torch.serve <run_dir> [--port 8123] [--host 127.0.0.1]
        [--weight_mode best] [--cfg_name setting] [--batch_size 8]
        [--device cuda|cpu] [--video_backend auto|opencv|synthetic]

  POST /score            body: raw video bytes        -> {"p_fake": ...}
  POST /score_path       body: {"path": "/x.mp4"}     -> {"p_fake": ...}
  GET  /healthz                                       -> {"ok": true}

An unknown endpoint answers 404, a video that cannot be scored 400 with
``{"error": ...}``. Videos are expected face-cropped (the offline
pipeline's output). ``synthetic://`` paths (data/video.py) need no decoder.

A ``Scorer`` holds a detector's params on the card, serialises device use
with a lock and scores decoded frames (``score_frames``) or a video
(``score_video``). It is built from a model and params, from a run's
settings already read (``from_preset``) or from the run directory
(``from_run_dir``, the one place ``yaml`` is imported). The encoder's
kernel paths are the detector's (``Detector(..., encoder_kernels=EncoderKernels(...))``, the
JAX serve path's DFD_FUSED_BLOCK, DFD_MEGAKERNEL and DFD_INT8_ATTN).
"""

from __future__ import annotations

import argparse
import json
import logging
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from os import path
from typing import Optional

import numpy as np

from .config import CN
from .models.detector import Detector
from .scoring import resolve_deepfake_task, score_frames, score_video


class Scorer:
    """Thread-safe single-flight scoring of decoded frames and videos."""

    def __init__(self, model: Detector, params, *, task: int = 0, batch_size: int = 16,
                 clip_duration: Optional[float] = None, video_backend: str = "auto"):
        self.model = model
        self.params = model.prepare_params(params)
        self.task = task
        self.batch_size = batch_size
        self.clip_duration = clip_duration
        self.video_backend = video_backend
        self._lock = threading.Lock()

    @classmethod
    def from_preset(cls, preset: CN, run_dir: str, weight_mode: str = "best",
                    batch_size: int = 8, device="cuda",
                    video_backend: str = "auto") -> "Scorer":
        """A run's settings (``preset``, its ``setting.yaml`` as a CfgNode)
        and weights (``<run_dir>/<weight_mode>_weights.pt``): the model
        config merged over the defaults, the pretrained encoder, the
        checkpoint laid over them, the Deepfake head resolved."""
        from .inference import load_model_params, load_pretrained_encoder

        model_cfg = Detector.get_default_config().merge_from_other_cfg(preset.model)
        model = Detector(model_cfg, preset.data.num_frames, device=device)
        wrapper = CN(new_allowed=True)
        wrapper.model = model_cfg
        load_pretrained_encoder(model, wrapper)
        return cls(model, load_model_params(model, run_dir, weight_mode),
                   task=resolve_deepfake_task(preset), batch_size=batch_size,
                   clip_duration=preset.data.clip_duration, video_backend=video_backend)

    @classmethod
    def from_run_dir(cls, run_dir: str, cfg_name: str = "setting", **kwargs) -> "Scorer":
        """``from_preset`` on ``<run_dir>/<cfg_name>.yaml``."""
        import yaml

        with open(path.join(run_dir, f"{cfg_name}.yaml")) as f:
            preset = CN(yaml.safe_load(f), new_allowed=True)
        return cls.from_preset(preset, run_dir, **kwargs)

    def predict(self, params, x, m):
        return self.model.predict(params, x, m)[0][self.task]

    def score_frames(self, frames: np.ndarray) -> float:
        """(N, H, W, 3) uint8 frames -> mean softmax P(fake) over windows."""
        return score_frames(frames, self.predict, self.params,
                            num_frames=self.model.num_frames,
                            batch_size=self.batch_size, lock=self._lock)

    def score_video(self, video_path: str) -> float:
        """Every clip_duration window of a video -> mean softmax P(fake)."""
        if self.clip_duration is None:
            raise ValueError("score_video needs the run's clip_duration")
        return score_video(video_path, self.predict, self.params,
                           num_frames=self.model.num_frames, clip_duration=self.clip_duration,
                           batch_size=self.batch_size, lock=self._lock,
                           video_backend=self.video_backend)


def make_handler(scorer: Scorer):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            else:
                self._reply(404, {"error": "unknown endpoint"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                if self.path == "/score":
                    with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
                        f.write(body)
                        f.flush()
                        p = scorer.score_video(f.name)
                elif self.path == "/score_path":
                    p = scorer.score_video(json.loads(body)["path"])
                else:
                    self._reply(404, {"error": "unknown endpoint"})
                    return
                self._reply(200, {"p_fake": p})
            except Exception as e:  # the client learns why its video was not scored
                logging.exception("scoring failed")
                self._reply(400, {"error": str(e)})

        def log_message(self, fmt, *args):
            logging.info("%s " + fmt, self.address_string(), *args)

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(description="Deepfake scoring service (PyTorch/CUDA port)")
    parser.add_argument("run_dir", type=str)
    parser.add_argument("--port", type=int, default=8123)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--weight_mode", default="best")
    parser.add_argument("--cfg_name", default="setting")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default: raises without a card) or cpu")
    parser.add_argument("--video_backend", default="auto",
                        choices=("auto", "opencv", "synthetic"))
    args = parser.parse_args(argv)

    logging.basicConfig(level="INFO")
    scorer = Scorer.from_run_dir(args.run_dir, args.cfg_name, weight_mode=args.weight_mode,
                                 batch_size=args.batch_size, device=args.device,
                                 video_backend=args.video_backend)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(scorer))
    logging.info("serving on %s:%d", args.host, args.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
