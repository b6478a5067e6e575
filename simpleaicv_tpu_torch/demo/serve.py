"""Multi-task model server of the PyTorch port over ``demo/predictors.py``
(counterpart of ``demo/serve.py``): the standard library's HTTP server, the
same twelve tasks, JSON keys and queries as the JAX server, on the card.

    python -m simpleaicv_tpu_torch.demo.serve --tasks classification,detection --port 8000

    GET  /                 HTML index: upload form per loaded task
    GET  /healthz          {"status": "ok", "tasks": [...]}
    POST /predict/<task>   body = raw JPEG/PNG bytes (or multipart file)
                           -> JSON (classification/detection/recognition)
                           -> PNG  (mask/matte tasks, ?format=png)

Tasks and their predictor constructor kwargs can be overridden with
--config '{"classification": {"network": "resnet18", "input_size": 64}}'
(checkpoints via {"trained_model_path": ...}, the port's ``best``).
``--device`` (default ``cuda``) is every predictor's device unless its
config names one; without a card the server raises unless given
``--device cpu``. Requests run on a pool of kept threads
(``KeptThreadsHTTPServer``): each is decoded there, then runs under its
task's lock.
"""

from __future__ import annotations

import argparse
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..models.common import resolve_device
from . import predictors as P
from .codec import decode_image, encode_png, strip_multipart

__all__ = ["ModelServer", "KeptThreadsHTTPServer", "make_handler",
           "build_server", "main"]

_TASK_BUILDERS = {}


def _register(name):
    def deco(fn):
        _TASK_BUILDERS[name] = fn
        return fn
    return deco


def _png(arr):
    return ("image/png", encode_png(arr))


def _label_map_json(mask):
    """The shape and the histogram of a uint8 label map (``np.unique``'s
    classes and counts, by ``np.bincount``: no sort of the pixels)."""
    counts = np.bincount(mask.ravel(), minlength=1)
    return {"mask_shape": list(mask.shape),
            "class_histogram": {int(k): int(counts[k])
                                for k in np.flatnonzero(counts)}}


@_register("classification")
def _build_classification(**kw):
    p = P.ClassificationPredictor(**kw)

    def run(img, query):
        topk = int(query.get("topk", 5))
        return {"topk": [{"class_index": int(i), "prob": float(s)}
                         for i, s in p(img, topk=topk)]}
    return run


@_register("detection")
def _build_detection(**kw):
    p = P.DetectionPredictor(**kw)

    def run(img, query):
        thr = float(query.get("score_threshold", 0.3))
        boxes, classes, scores = p(img, score_threshold=thr)
        return {"detections": [
            {"box": [float(v) for v in b], "class_index": int(c),
             "score": float(s)}
            for b, c, s in zip(boxes, classes, scores)]}
    return run


def _label_map_run(p):
    def run(img, query):
        mask = p(img)
        if query.get("format") == "png":
            return _png(mask)
        return _label_map_json(mask)
    return run


@_register("semantic_segmentation")
def _build_semseg(**kw):
    return _label_map_run(P.SemanticSegmentationPredictor(**kw))


def _binary_run(p):
    def run(img, query):
        alpha = p(img)
        if query.get("format") == "png":
            return _png((np.clip(alpha, 0.0, 1.0) * 255).astype(np.uint8))
        a = np.asarray(alpha, np.float64)
        return {"alpha_shape": list(a.shape), "alpha_mean": float(a.mean())}
    return run


@_register("salient_object_detection")
def _build_salient(**kw):
    return _binary_run(P.BinarySegmentationPredictor(**kw))


@_register("human_matting")
def _build_matting(**kw):
    return _binary_run(P.HumanMattingPredictor(**kw))


@_register("face_detection")
def _build_face_detection(**kw):
    p = P.FaceDetectionPredictor(**kw)

    def run(img, query):
        thr = float(query.get("score_threshold", 0.3))
        boxes, _, scores = p(img, score_threshold=thr)
        return {"faces": [{"box": [float(v) for v in b], "score": float(s)}
                          for b, s in zip(boxes, scores)]}
    return run


@_register("face_parsing")
def _build_face_parsing(**kw):
    return _label_map_run(P.ParsingPredictor(**kw))


@_register("human_parsing")
def _build_human_parsing(**kw):
    kw.setdefault("network", "resnet50_pfan_human_parsing")
    return _label_map_run(P.ParsingPredictor(**kw))


@_register("instance_segmentation")
def _build_instance_segmentation(**kw):
    p = P.InstanceSegmentationPredictor(**kw)

    def run(img, query):
        thr = float(query.get("score_threshold", 0.3))
        masks, classes, scores = p(img, score_threshold=thr)
        return {"instances": [
            {"class_index": int(c), "score": float(s),
             "mask_pixels": int(np.asarray(m).sum())}
            for m, c, s in zip(masks, classes, scores)]}
    return run


@_register("text_detection")
def _build_text_detection(**kw):
    p = P.TextDetectionPredictor(**kw)

    def run(img, query):
        boxes, scores = p(img)
        return {"polygons": [
            {"points": np.asarray(b, np.float64).tolist(),
             "score": float(s)} for b, s in zip(boxes, scores)]}
    return run


@_register("interactive_segmentation")
def _build_sam(**kw):
    p = P.SAMPredictor(**kw)

    def run(img, query):
        # ?box=x1,y1,x2,y2: the circle-target flow (the drawn region's
        # bounding rectangle as a box prompt); otherwise ?points=x,y;x,y,
        # click prompts in image coordinates (at most 9)
        rawbox = query.get("box", "")
        if rawbox.count(",") == 3:
            box = [float(v) for v in rawbox.split(",")]
            mask = p.predict_box(img, box)
            if query.get("format") == "png":
                return _png(mask * 255)
            return {"mask_shape": list(mask.shape),
                    "mask_pixels": int(mask.sum()), "box": box}
        pts = []
        for tok in query.get("points", "").split(";"):
            if "," in tok:
                x, y = tok.split(",", 1)
                pts.append((float(x), float(y)))
        if not pts:
            h, w = img.shape[:2]
            pts = [(w / 2.0, h / 2.0)]       # default: a click at the centre
        mask = p(img, pts)
        if query.get("format") == "png":
            return _png(mask * 255)
        return {"mask_shape": list(mask.shape),
                "mask_pixels": int(mask.sum()),
                "points": [[float(x), float(y)] for x, y in pts]}
    return run


@_register("text_recognition")
def _build_text_recognition(**kw):
    p = P.TextRecognitionPredictor(**kw)

    def run(img, query):
        return {"text": p(img)}
    return run


class ModelServer:
    """Lazy-building, lock-guarded registry of task -> predict callables."""

    def __init__(self, task_configs):
        self.task_configs = dict(task_configs)
        self._runners = {}
        self._locks = {}
        self._build_lock = threading.Lock()

    @property
    def tasks(self):
        return sorted(self.task_configs)

    def warm(self):
        for t in self.tasks:
            self._get(t)

    def _get(self, task):
        with self._build_lock:
            if task not in self._runners:
                if task not in self.task_configs:
                    raise KeyError(task)
                kw = dict(self.task_configs[task] or {})
                self._runners[task] = _TASK_BUILDERS[task](**kw)
                self._locks[task] = threading.Lock()
        return self._runners[task], self._locks[task]

    def predict(self, task, body, content_type, query):
        run, lock = self._get(task)
        img = decode_image(strip_multipart(body, content_type))
        with lock:
            return run(img, query)


_INDEX_HTML = """<!doctype html><title>simpleaicv_tpu_torch serve</title>
<h1>simpleaicv_tpu_torch model server</h1>
{forms}
<p>POST an image to /predict/&lt;task&gt; — JSON out (masks: ?format=png).</p>
"""

_FORM = """<h2>{task}</h2>
<form action="/predict/{task}" method="post" enctype="multipart/form-data">
<input type="file" name="file"><input type="submit" value="predict">
</form>"""


def make_handler(server: ModelServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; tests capture stderr
            pass

        def _send(self, code, ctype, payload):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _send_json(self, code, obj):
            self._send(code, "application/json",
                       json.dumps(obj).encode("utf-8"))

        def do_GET(self):
            if self.path == "/healthz":
                return self._send_json(200, {"status": "ok",
                                             "tasks": server.tasks})
            if self.path == "/":
                forms = "".join(_FORM.format(task=t) for t in server.tasks)
                return self._send(200, "text/html",
                                  _INDEX_HTML.format(forms=forms)
                                  .encode("utf-8"))
            self._send_json(404, {"error": "not found"})

        def do_POST(self):
            if not self.path.startswith("/predict/"):
                return self._send_json(404, {"error": "not found"})
            rest = self.path[len("/predict/"):]
            task, _, qs = rest.partition("?")
            query = dict(kv.split("=", 1) for kv in qs.split("&") if "=" in kv)
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            try:
                out = server.predict(task, body,
                                     self.headers.get("Content-Type"), query)
            except KeyError:
                return self._send_json(
                    404, {"error": f"unknown task {task!r}",
                          "tasks": server.tasks})
            except ValueError as e:
                return self._send_json(400, {"error": str(e)})
            if isinstance(out, tuple):              # (content_type, bytes)
                return self._send(200, out[0], out[1])
            self._send_json(200, out)

    return Handler


class KeptThreadsHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` whose requests run on a few kept threads
    (``WORKERS``), not on a new thread each: a thread's first CUDA work
    costs 60 to 130 ms on the card, which a new thread a request pays on
    every request. ``process_request_thread`` reports a request's errors
    and closes its socket itself."""

    WORKERS = 8

    def __init__(self, address, handler):
        super().__init__(address, handler)
        self._pool = ThreadPoolExecutor(self.WORKERS,
                                        thread_name_prefix="serve")

    def process_request(self, request, client_address):
        self._pool.submit(self.process_request_thread, request,
                          client_address)

    def server_close(self):
        super().server_close()
        self._pool.shutdown(wait=True)


def build_server(tasks, config=None, host="127.0.0.1", port=8000,
                 device="cuda"):
    """(the HTTP server, its ``ModelServer``) for ``tasks``; ``config`` maps
    a task to its predictor's keywords, ``device`` is every predictor's
    unless its keywords name one. Raises for a CUDA device without a
    card."""
    cfg = dict(config or {})
    task_configs = {t: dict(cfg.get(t) or {}) for t in tasks}
    unknown = [t for t in task_configs if t not in _TASK_BUILDERS]
    if unknown:
        raise SystemExit(f"unknown tasks {unknown}; "
                         f"available: {sorted(_TASK_BUILDERS)}")
    for kw in task_configs.values():
        resolve_device(kw.setdefault("device", device))
    model_server = ModelServer(task_configs)
    httpd = KeptThreadsHTTPServer((host, port), make_handler(model_server))
    return httpd, model_server


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tasks", default="classification",
                    help="comma list of " + ",".join(sorted(_TASK_BUILDERS)))
    ap.add_argument("--config", default="{}",
                    help="JSON: {task: predictor-kwargs}")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    httpd, model_server = build_server(
        [t.strip() for t in args.tasks.split(",") if t.strip()],
        json.loads(args.config), args.host, args.port, args.device)
    model_server.warm()                        # build every model first
    print(f"serving {model_server.tasks} on "
          f"http://{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
