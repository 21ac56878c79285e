"""HTTP inference server for a trained run.

Counterpart of ``deepsensornz_tpu/infer/server.py``, with its endpoints and
JSON:

- ``GET  /health``  → ``{"status": "ok", "variable": ...}``;
- ``POST /predict`` → body ``{"times": ["2020-01-01T00:00", ...]}``; the run's
  persisted TaskLoader builds the tasks at those times, ``predict_grid``
  predicts on the DEM coarsened by ``highres_factor``, and the response
  holds the mean/std grids (lists, sea cells ``-9999.0``) with their
  coordinates. A bad request gets 400.

The model runs on ``device`` (``None``: the card; without one the service
raises unless ``device="cpu"``). Requests are served one at a time under a
lock. As in the JAX service, the maps cross to the host quantised to int16
(at most half a step of 1/65535 of each map's range off) in chunks of 24
times with 8 download threads; ``transfer_dtype=None`` serves float32.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from deepsensornz_tpu_torch.infer.predict import Predictor
from deepsensornz_tpu_torch.pipeline.validate import load_run


class PredictService:
    """A trained run behind request-driven gridded prediction."""

    def __init__(self, model_dir: str, dem, highres_factor: int = 10,
                 transfer_dtype: str | None = "int16", batch_chunk: int | None = 24,
                 download_threads: int = 8, device=None):
        self.run = load_run(model_dir, device=device)
        self.dem = dem
        self.pred_grid = dem.coarsen(highres_factor)
        self.predictor = Predictor(
            self.run["model"], self.run["data_processor"], self.run["task_loader"].target_var_IDs,
            transfer_dtype=transfer_dtype, batch_chunk=batch_chunk,
            download_threads=download_threads,
            # the shipped recalibration: without it every response would
            # report the raw spread
            std_scale=self.run.get("std_scale", 1.0))
        self.lock = threading.Lock()

    def predict(self, times: list[str]) -> dict:
        tl = self.run["task_loader"]
        ts = np.asarray([np.datetime64(t) for t in times])
        with self.lock:
            task = tl(list(ts), seed_override=42)
            pred = self.predictor.predict_grid(task, self.pred_grid,
                                               aux_at_targets=tl.aux_at_targets, times=ts)
        mean = pred["mean"]
        return {
            "variable": self.run["variable"],
            "times": [str(t) for t in ts],
            "latitude": mean.coords["latitude"].tolist(),
            "longitude": mean.coords["longitude"].tolist(),
            "mean": np.nan_to_num(mean.data, nan=-9999.0).tolist(),
            "std": np.nan_to_num(pred["std"].data, nan=-9999.0).tolist(),
            "missing_value": -9999.0,
        }


def make_handler(service: PredictService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok", "variable": service.run["variable"]})
            else:
                self._send(404, {"error": "unknown endpoint"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown endpoint"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                times = req["times"]
                if not isinstance(times, list) or not times:
                    raise ValueError("'times' must be a non-empty list")
                self._send(200, service.predict(times))
            except Exception as e:  # noqa: BLE001 -- reported to the client
                self._send(400, {"error": str(e)})

        def log_message(self, *a):  # quiet
            pass

    return Handler


def serve(model_dir: str, dem, port: int = 8500, highres_factor: int = 10,
          warmup_time: str | None = None, device=None) -> HTTPServer:
    """Build the service, optionally warm it with one prediction, and
    return a ready HTTPServer (call ``serve_forever``)."""
    service = PredictService(model_dir, dem, highres_factor, device=device)
    if warmup_time is not None:
        service.predict([warmup_time])
    httpd = HTTPServer(("0.0.0.0", port), make_handler(service))
    httpd.service = service
    return httpd
