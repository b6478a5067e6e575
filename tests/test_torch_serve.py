"""The port's HTTP server (``simpleaicv_tpu_torch/demo/serve.py``) against
the JAX package's (``demo/serve.py``): both started with ``port=0`` in
threads, on the same tiny configurations and the same seeded weights, all
twelve tasks, real sockets and ``urllib``. The same request gets the same
status, keys and shapes, the same ``topk`` order, histograms and text, and
numbers within the tolerances of ``tests/test_torch_predictors.py``. Also:
multipart and raw bodies, 404 and 400, concurrent requests, ``?format=png``,
the SAM ``?points`` and ``?box`` queries, and the codec
(``demo/codec.py``) against ``cv2.imdecode`` and ``cv2.imencode``."""

import io
import json
import sys
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from simpleaicv_tpu_torch.demo import codec
from simpleaicv_tpu_torch.demo import predictors as port_predictors
from simpleaicv_tpu_torch.demo import serve as port_serve

from _torch_port import (jax_f32, load_jax_demo, one_torch_thread, seed_both,
                         skip_jax_init, zero_fill)

PROB_ATOL = 5e-6
SCORE_RTOL = 1e-5
ALPHA_ATOL = 1e-6

# tiny configurations of the twelve tasks, and each one's weight seed
TASKS = {
    "classification": (0, dict(network="resnet18", num_classes=7,
                               input_size=64)),
    "detection": (0, dict(network="resnet18_fcos", num_classes=5,
                          input_size=128)),
    "semantic_segmentation": (0, dict(network="resnet18_deeplabv3plus",
                                      num_classes=5, input_size=64)),
    "salient_object_detection": (0, dict(
        network="resnet18_pfan_segmentation", input_size=64)),
    "human_matting": (0, dict(network="resnet18_pfan_matting",
                              input_size=64)),
    "face_detection": (0, dict(network="resnet18_retinaface",
                               input_size=64)),
    "face_parsing": (0, dict(network="resnet18_pfan_face_parsing",
                             num_classes=5, input_size=64)),
    "human_parsing": (1, dict(network="resnet18_pfan_human_parsing",
                              input_size=64)),
    "instance_segmentation": (0, dict(network="resnet18_yolact",
                                      decoder="YOLACTDecoder", num_classes=4,
                                      input_size=64)),
    "text_detection": (2, dict(network="resnet18_dbnet", input_size=64,
                               decoder_kwargs=dict(hard_border_threshold=0.5,
                                                   box_score_threshold=0.5))),
    "interactive_segmentation": (3, dict(
        network="sam_b", image_size=64, image_encoder_embedding_planes=64,
        image_encoder_block_nums=2, image_encoder_head_nums=2,
        image_encoder_window_size=2, image_encoder_global_attn_indexes=[1],
        prompt_encoder_embedding_planes=64)),
    "text_recognition": (0, dict(backbone="resnet18", input_h=32,
                                 input_w=128)),
}


def _jpeg(image, flags=()):
    ok, buf = cv2.imencode(".jpg", image[..., ::-1], list(flags))
    assert ok
    return bytes(buf.tobytes())


def _image(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


BODY = _jpeg(_image(50, 70, 0))
TALL = _jpeg(_image(90, 41, 1))
STRIP = _jpeg(_image(20, 150, 2))


def _predictor(run):
    """The predictor a task builder's ``run`` closes over."""
    return next(c.cell_contents for c in run.__closure__
                if hasattr(c.cell_contents, "model")
                or hasattr(c.cell_contents, "variables"))


def _serve(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers():
    """(JAX server URL, port server URL, port ModelServer): every task
    built on both sides, the port's on the CPU in f32, both on one draw of
    weights a task."""
    jax_predictors = load_jax_demo("predictors")
    jax_serve = load_jax_demo("serve")
    with one_torch_thread(), pytest.MonkeyPatch.context() as mp:
        # the JAX builders import "predictors" from demo/ by that name
        mp.setitem(sys.modules, "predictors", jax_predictors)
        mp.setattr(port_predictors, "init_params", zero_fill)
        config = {t: kw for t, (_, kw) in TASKS.items()}
        jhttpd, jms = jax_serve.build_server(list(TASKS), config, port=0)
        port_config = {t: dict(kw, dtype="float32")
                       for t, (_, kw) in TASKS.items()}
        thttpd, tms = port_serve.build_server(list(TASKS), port_config,
                                              port=0, device="cpu")
        with skip_jax_init(jax_predictors):
            jms.warm()
        tms.warm()
        for task, (seed, _) in TASKS.items():
            seed_both(_predictor(jms._runners[task]),
                      _predictor(tms._runners[task]), seed)
        urls = _serve(jhttpd), _serve(thttpd)
        try:
            yield urls + (tms,)
        finally:
            for httpd in (jhttpd, thttpd):
                httpd.shutdown()
                httpd.server_close()


def _post(url, body, content_type="image/jpeg"):
    """(status, content type, payload: JSON or bytes)."""
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, ctype, data = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        status, ctype, data = e.code, e.headers["Content-Type"], e.read()
    if ctype == "application/json":
        data = json.loads(data)
    return status, ctype, data


def _both(servers, path, body, content_type="image/jpeg"):
    jax_url, port_url, _ = servers
    with jax_f32():
        want = _post(jax_url + path, body, content_type)
    got = _post(port_url + path, body, content_type)
    assert got[0] == want[0] and got[1] == want[1], (got, want)
    return want[2], got[2]


def _match_boxes(want, got, key, factor):
    """Every JAX box matched by a port box of the same class within one
    truncation step (1 / factor) and a score within SCORE_RTOL."""
    assert len(want[key]) == len(got[key]) > 0
    free = list(got[key])
    for w in want[key]:
        hit = next(g for g in free
                   if g.get("class_index") == w.get("class_index")
                   and abs(g["score"] - w["score"]) <= SCORE_RTOL * w["score"]
                   and max(abs(a - b) for a, b in zip(g["box"], w["box"]))
                   <= 1 / factor + 1e-4)
        free.remove(hit)


def _agree(task, want, got, image_hw):
    assert set(got) == set(want), (task, sorted(got), sorted(want))
    if task == "classification":
        assert [e["class_index"] for e in got["topk"]] == \
            [e["class_index"] for e in want["topk"]]
        for g, w in zip(got["topk"], want["topk"]):
            assert abs(g["prob"] - w["prob"]) <= PROB_ATOL
    elif task in ("detection", "face_detection"):
        size = TASKS[task][1]["input_size"]
        _match_boxes(want, got, "detections" if task == "detection"
                     else "faces", size / max(image_hw))
    elif "mask_shape" in want and "class_histogram" in want:
        assert got == want and want["mask_shape"] == list(image_hw)
    elif "alpha_shape" in want:
        assert got["alpha_shape"] == want["alpha_shape"] == list(image_hw)
        assert abs(got["alpha_mean"] - want["alpha_mean"]) <= ALPHA_ATOL
    elif task == "instance_segmentation":
        assert len(got["instances"]) == len(want["instances"]) > 0
        for g, w in zip(got["instances"], want["instances"]):
            assert g["class_index"] == w["class_index"]
            assert g["mask_pixels"] == w["mask_pixels"]
            assert abs(g["score"] - w["score"]) <= SCORE_RTOL * w["score"]
    elif task == "text_detection":
        assert len(got["polygons"]) == len(want["polygons"]) > 0
        for g, w in zip(got["polygons"], want["polygons"]):
            np.testing.assert_allclose(g["points"], w["points"], atol=1e-4)
            assert abs(g["score"] - w["score"]) <= SCORE_RTOL * w["score"]
    else:  # the SAM masks' statistics and the recognised text
        assert got == want


# -- the endpoints against the JAX server ---------------------------------

@pytest.mark.parametrize("task", sorted(TASKS))
def test_endpoint_matches_jax(servers, task):
    bodies = [(STRIP, (20, 150))] if task == "text_recognition" else \
        [(BODY, (50, 70)), (TALL, (90, 41))]
    for body, hw in bodies:
        want, got = _both(servers, f"/predict/{task}", body)
        _agree(task, want, got, hw)
        if task == "text_recognition":
            assert isinstance(got["text"], str) and got["text"]


@pytest.mark.parametrize("task,query", [
    ("classification", "?topk=3"),
    ("detection", "?score_threshold=0.5"),
    ("face_detection", "?score_threshold=0.2"),
    ("instance_segmentation", "?score_threshold=0.6"),
    ("interactive_segmentation", "?points=10,12;30,20;60,40"),
    ("interactive_segmentation", "?box=8,10,36,40")])
def test_queries_match_jax(servers, task, query):
    want, got = _both(servers, f"/predict/{task}{query}", BODY)
    _agree(task, want, got, (50, 70))
    if task == "classification":
        assert len(got["topk"]) == 3
    if "points" in query:
        assert got["points"] == [[10.0, 12.0], [30.0, 20.0], [60.0, 40.0]]
    if "box" in query:
        assert got["box"] == [8.0, 10.0, 36.0, 40.0]


@pytest.mark.parametrize("task,query", [
    ("semantic_segmentation", ""), ("human_parsing", ""),
    ("salient_object_detection", ""), ("human_matting", ""),
    ("interactive_segmentation", "&box=8,10,36,40")])
def test_png_format_matches_jax(servers, task, query):
    """``?format=png``: the port's PNG decodes (by cv2) to the JAX
    server's mask, and to the port predictor's own answer."""
    want, got = _both(servers, f"/predict/{task}?format=png{query}", BODY)
    assert got[:8] == b"\x89PNG\r\n\x1a\n"
    decode = lambda b: cv2.imdecode(np.frombuffer(b, np.uint8),  # noqa: E731
                                    cv2.IMREAD_UNCHANGED)
    mask, jax_mask = decode(got), decode(want)
    assert mask.shape == jax_mask.shape == (50, 70) and mask.dtype == np.uint8
    image = codec.decode_image(BODY)
    p = _predictor(servers[2]._runners[task])
    if task == "interactive_segmentation":
        own = p.predict_box(image, [8.0, 10.0, 36.0, 40.0]) * 255
    elif task in ("salient_object_detection", "human_matting"):
        own = (np.clip(p(image), 0.0, 1.0) * 255).astype(np.uint8)
    else:
        own = p(image)
    np.testing.assert_array_equal(mask, own)
    if task in ("salient_object_detection", "human_matting"):
        # alphas within 1e-6 may cross a level of the uint8 cast
        assert np.abs(mask.astype(int) - jax_mask).max() <= 1
        assert np.mean(mask == jax_mask) >= 0.999
    else:
        np.testing.assert_array_equal(mask, jax_mask)


def test_multipart_and_raw_bodies_agree(servers):
    boundary = "xBOUNDARYx"
    payload = (f"--{boundary}\r\nContent-Disposition: form-data; "
               f'name="file"; filename="a.jpg"\r\n'
               f"Content-Type: image/jpeg\r\n\r\n").encode() \
        + BODY + f"\r\n--{boundary}--\r\n".encode()
    ctype = f"multipart/form-data; boundary={boundary}"
    want, got = _both(servers, "/predict/classification", payload, ctype)
    _agree("classification", want, got, (50, 70))
    raw = _post(servers[1] + "/predict/classification", BODY)[2]
    assert raw == got
    status, _, out = _post(servers[1] + "/predict/classification",
                           b"--xBOUNDARYx\r\n\r\nno file\r\n", ctype)
    assert status == 400 and "no file part" in out["error"]


def test_healthz_index_404_and_400_match_jax(servers):
    jax_url, port_url, _ = servers
    for url in (jax_url, port_url):
        with urllib.request.urlopen(url + "/healthz") as r:
            assert json.loads(r.read()) == {"status": "ok",
                                            "tasks": sorted(TASKS)}
        with urllib.request.urlopen(url + "/") as r:
            page = r.read().decode()
        assert all(f"/predict/{t}" in page for t in TASKS)
    for path, body in (("/predict/nope", BODY), ("/elsewhere", BODY),
                       ("/predict/classification", b"not an image")):
        want, got = _both(servers, path, body)
        assert set(got) == set(want)
    assert _post(port_url + "/predict/nope", BODY)[0] == 404
    assert _post(port_url + "/predict/classification", b"x")[0] == 400


def test_requests_run_on_kept_threads(servers):
    """The port's server answers on a pool of kept threads, not on a new
    thread a request (a thread's first CUDA work is slow on the card)."""
    port_url, model_server = servers[1], servers[2]
    run, _ = model_server._get("classification")
    seen = set()

    def recording(img, query):
        seen.add(threading.get_ident())
        return run(img, query)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(model_server._runners, "classification", recording)
        for _ in range(3 * port_serve.KeptThreadsHTTPServer.WORKERS):
            assert _post(port_url + "/predict/classification", BODY)[0] \
                == 200
    assert 1 <= len(seen) <= port_serve.KeptThreadsHTTPServer.WORKERS


def test_concurrent_requests(servers):
    """Requests on the server's kept threads (grad mode is thread-local),
    the per-task lock around the model: concurrent posts to three tasks
    all succeed and give the serial answers."""
    port_url = servers[1]
    paths = ["/predict/classification", "/predict/semantic_segmentation",
             "/predict/interactive_segmentation?points=20,20"]
    serial = {p: _post(port_url + p, BODY) for p in paths}
    results = []

    def post(path):
        results.append((path, _post(port_url + path, BODY)))

    threads = [threading.Thread(target=post, args=(p,))
               for p in paths * 3]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(results) == 9
    assert all(out == serial[path] for path, out in results)


def test_server_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.build_server(["classification"], port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.main(["--tasks", "classification", "--port", "0"])


# -- the codec against cv2 ------------------------------------------------

def _cv2_decode(body):
    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _smooth(h, w, seed):
    """A photo-like image (ramps plus noise): JPEG's rounding shows on it
    as it would on a photograph."""
    yy, xx = np.mgrid[0:h, 0:w]
    ramps = np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1) % 256
    noise = np.random.RandomState(seed).randint(0, 128, (h, w, 3))
    return (ramps * 0.5 + noise).astype(np.uint8)


@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba", "grey16"])
def test_decode_png_matches_cv2_exactly(kind):
    """16-bit samples too: cv2's IMREAD_COLOR keeps their high byte."""
    image = _smooth(61, 83, 0)
    arr = {"grey": image[..., 0], "rgb": image[..., ::-1],
           "rgba": np.dstack([image[..., ::-1], image[..., 1]]),
           "grey16": image[..., 0].astype(np.uint16) * 257 + 99}[kind]
    ok, buf = cv2.imencode(".png", arr)
    body = bytes(buf.tobytes())
    got = codec.decode_image(body)
    assert got.dtype == np.uint8 and got.shape == (61, 83, 3)
    np.testing.assert_array_equal(got, _cv2_decode(body))


@pytest.mark.parametrize("progressive", [0, 1])
def test_decode_jpeg_matches_cv2(progressive):
    """PIL's libjpeg and OpenCV's may round the IDCT and the chroma
    upsampling apart; on this box they agree on every value. The share
    of differing values is printed and bounded at 1e-3, each within a
    level."""
    body = _jpeg(_smooth(121, 163, 1), (
        cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
        cv2.IMWRITE_JPEG_QUALITY, 90))
    got, want = codec.decode_image(body), _cv2_decode(body)
    assert got.shape == want.shape == (121, 163, 3)
    diff = np.abs(got.astype(int) - want)
    share = float(np.mean(diff > 0))
    print(f"progressive={progressive}: {share:.6f} of the values differ, "
          f"by at most {diff.max()}")
    assert share <= 1e-3 and diff.max() <= 1


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_decode_applies_exif_orientation_as_cv2(orientation):
    """cv2's IMREAD_COLOR applies the EXIF orientation; so does the codec
    (orientations 6 and 8 swap the image's height and width)."""
    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(_smooth(40, 64, 2)).save(buf, "JPEG", exif=exif,
                                             quality=95)
    body = buf.getvalue()
    got, want = codec.decode_image(body), _cv2_decode(body)
    assert got.shape == want.shape == ((64, 40, 3) if orientation in (6, 8)
                                       else (40, 64, 3))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(33, 47), (33, 47, 3)])
def test_encode_png_decodes_as_cv2_encodes(shape):
    """The codec's PNG holds the pixels cv2's does: a grey mask as it is,
    an RGB image in RGB order (cv2 reads a PNG to BGR)."""
    image = np.random.RandomState(4).randint(0, 256, shape).astype(np.uint8)
    back = cv2.imdecode(np.frombuffer(codec.encode_png(image), np.uint8),
                        cv2.IMREAD_UNCHANGED)
    if image.ndim == 3:
        back = back[..., ::-1]
    ok, buf = cv2.imencode(".png", image)
    assert ok
    np.testing.assert_array_equal(back, image)
    np.testing.assert_array_equal(cv2.imdecode(buf, cv2.IMREAD_UNCHANGED),
                                  image)


@pytest.mark.parametrize("body", [b"", b"not an image", BODY[:200],
                                  b"\x89PNG\r\n\x1a\n" + b"\x00" * 40])
def test_decode_raises_value_error_on_bad_bytes(body):
    with pytest.raises(ValueError, match="not a decodable image"):
        codec.decode_image(body)
