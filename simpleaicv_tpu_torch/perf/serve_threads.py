"""Where a served request's time goes on the card: the HTTP server's
``predict`` for a task in this thread, in a new thread a call and in one
kept thread, and the same request over a socket to a server that starts a
thread a request (``ThreadingHTTPServer``, the JAX server's) and to the
port's ``KeptThreadsHTTPServer``.

    python -m simpleaicv_tpu_torch.perf.serve_threads
    python -m simpleaicv_tpu_torch.perf.serve_threads --tasks classification

Each task at its predictor's defaults (bf16) on a 1280x720 JPEG (a 48x400
strip for text_recognition); each way's median, least and most ms over 8
calls after 3, by the host clock, with the card's name and power limit.
Needs a card.
"""

from __future__ import annotations

import argparse
import io
import subprocess
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import torch

TASKS = ("classification", "text_recognition", "semantic_segmentation")


def _photo(h, w, seed):
    """A photo-like uint8 RGB image: ramps and noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    ramps = np.stack([xx * 0.2, yy * 0.3, (xx + yy) * 0.1], -1) % 256
    noise = np.random.RandomState(seed).randint(0, 64, (h, w, 3))
    return (ramps * 0.75 + noise).astype(np.uint8)


def _jpeg(image):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "image/jpeg"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def _in_new_thread(fn):
    out = []
    thread = threading.Thread(target=lambda: out.append(fn()))
    thread.start()
    thread.join()
    return out[0]


def _serving(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return thread, f"http://127.0.0.1:{httpd.server_address[1]}/predict/"


def main(argv=None):
    from ..demo import serve
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tasks", default=",".join(TASKS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_threads: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    tasks = [t for t in args.tasks.split(",") if t]
    kept, model_server = serve.build_server(tasks, {}, port=0, device="cuda")
    model_server.warm()
    fresh = ThreadingHTTPServer(("127.0.0.1", 0),
                                serve.make_handler(model_server))
    servers = [kept, fresh]
    (kept_thread, kept_url), (fresh_thread, fresh_url) = (
        _serving(h) for h in servers)
    pool = ThreadPoolExecutor(1)
    try:
        for task in tasks:
            body = _jpeg(_photo(48, 400, 2) if task == "text_recognition"
                         else _photo(720, 1280, 0))

            def run(task=task, body=body):
                return model_server.predict(task, body, "image/jpeg", {})

            ways = {
                "this thread": run,
                "a new thread a call": lambda: _in_new_thread(run),
                "one kept thread": lambda: pool.submit(run).result(),
                "HTTP, a thread a request": lambda: _post(fresh_url + task,
                                                          body),
                "HTTP, kept threads": lambda: _post(kept_url + task, body)}
            for _ in range(3):
                for fn in ways.values():
                    fn()
            for name, fn in ways.items():
                ms = []
                for _ in range(8):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    ms.append((time.perf_counter() - t0) * 1e3)
                print(f"{task}, {name} [{card}]: median "
                      f"{np.median(ms):.2f} ms, least {min(ms):.2f}, most "
                      f"{max(ms):.2f}", flush=True)
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        kept_thread.join(timeout=60)
        fresh_thread.join(timeout=60)
        pool.shutdown()


if __name__ == "__main__":
    main()
