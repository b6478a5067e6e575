"""Single-image predictors of the PyTorch port, the serving layer
(counterpart of ``demo/predictors.py``).

Each predictor builds one model on its device (the CUDA card unless
``device="cpu"``; it raises when there is no card), in ``dtype`` (bf16 by
default), with weights drawn from a ``torch.Generator`` seeded with
``seed``, or the port's ``best`` checkpoint at ``trained_model_path``
(parameters and BatchNorm statistics; ``core.weights.load_jax_params``
carries JAX trees across). The constructors keep the JAX predictors'
keywords, so the JAX server's ``--config`` JSON serves here unchanged.
Each ``__call__`` runs under its own ``torch.no_grad()``: grad mode is
thread-local, and the HTTP server answers requests on threads of its own.

The pre- and post-processing runs on the predictor's device and needs no
OpenCV:
  * the square resize and the letterbox are ``F.interpolate(mode=
    "bilinear", align_corners=False, antialias=False)``, the taps of cv2
    ``INTER_LINEAR`` on float input (resize first, then / 255);
  * the resize back of a label map or mask is a gather at cv2
    ``INTER_NEAREST``'s rows and columns, ``floor(x / (dst / src))`` in
    double precision (``nearest_indices``); ``F.interpolate``'s nearest
    mode takes the scale in single precision and parts from cv2 by a row
    or a column at thousands of sizes;
  * an alpha goes back bilinearly, as cv2 ``INTER_LINEAR`` on f32;
  * a drawn region's bounding rectangle is a numpy nonzero box, as cv2
    ``boundingRect`` computes it.
The decoders return numpy arrays, so the instance masks are resized on
the host, through one gather that composes the JAX predictor's two
nearest resizes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import models  # noqa: F401  (registers the models and decoders)
from ..core.checkpoint import load_checkpoint_tensors
from ..core.registry import BACKBONES, DECODERS, MODELS
from ..data.raster import bounding_rect, nearest_indices
from ..data.text_detection import DBNetDecoder
from ..data.text_recognition import CTCTextLabelConverter
from ..models.common import init_params, resolve_device
from ..models.text_recognition import CTCModel

__all__ = ["ClassificationPredictor", "DetectionPredictor",
           "FaceDetectionPredictor", "SemanticSegmentationPredictor",
           "ParsingPredictor", "BinarySegmentationPredictor",
           "HumanMattingPredictor", "InstanceSegmentationPredictor",
           "TextDetectionPredictor", "TextRecognitionPredictor",
           "SAMPredictor", "letterbox", "square_resize", "nearest_indices",
           "resize_nearest", "bounding_rect"]


def _as_dtype(dtype) -> torch.dtype:
    """A torch dtype, or its name as a JSON config gives it."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _served(model, device, seed, trained_model_path):
    """``model`` with the weights of a port checkpoint, every parameter and
    buffer (a strict load), or else seeded ones, in eval mode on
    ``device``."""
    if trained_model_path:
        model.load_state_dict(load_checkpoint_tensors(trained_model_path))
    else:
        init_params(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def _resized(image_rgb: np.ndarray, hw, device):
    """[h, w, 3] image -> [hw[0], hw[1], 3] f32 in [0, 1] on ``device``."""
    image = np.ascontiguousarray(image_rgb)
    if image.dtype != np.uint8:
        image = image.astype(np.float32)
    img = torch.from_numpy(image).to(device).float().permute(2, 0, 1)[None]
    resized = F.interpolate(img, size=tuple(hw), mode="bilinear",
                            align_corners=False, antialias=False)
    return resized[0].permute(1, 2, 0) / 255.0


def square_resize(image_rgb: np.ndarray, size: int, device):
    """[h, w, 3] image -> [1, size, size, 3] f32 in [0, 1] on ``device``
    (the JAX predictors' ``cv2.resize(img, (s, s)) / 255``)."""
    return _resized(image_rgb, (size, size), device)[None]


def letterbox(image_rgb: np.ndarray, size: int, device):
    """[h, w, 3] image -> ([size, size, 3] f32 canvas in [0, 1] on
    ``device`` with the image resized into its top-left corner, factor,
    (nh, nw))."""
    h, w = image_rgb.shape[:2]
    factor = size / max(h, w)
    nh, nw = int(round(h * factor)), int(round(w * factor))
    canvas = torch.zeros(size, size, 3, device=device)
    canvas[:nh, :nw] = _resized(image_rgb, (nh, nw), device)
    return canvas, factor, (nh, nw)


def resize_nearest(mask, hw):
    """[..., h, w] tensor -> [..., hw[0], hw[1]] at cv2 ``INTER_NEAREST``'s
    places, on the tensor's device."""
    iy, ix = (torch.from_numpy(nearest_indices(s, d)).to(mask.device)
              for s, d in zip(mask.shape[-2:], hw))
    return mask.index_select(-2, iy).index_select(-1, ix)


def _rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """cv2.COLOR_RGB2GRAY on uint8: BT.601 weights in 15-bit fixed point,
    rounded (equal to OpenCV on all 2^24 colours)."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(
        np.uint8)


class ClassificationPredictor:
    """Softmax probabilities of a square-resized image; the top ``topk``
    as (class, probability), in the JAX predictor's order (numpy's
    ``argsort`` of the negated probabilities)."""

    def __init__(self, network="resnet50", num_classes=1000, input_size=224,
                 trained_model_path="", device="cuda", dtype=torch.bfloat16,
                 seed=0):
        self.device = resolve_device(device)
        self.input_size = input_size
        self.model = _served(
            BACKBONES.create(network, num_classes=num_classes,
                             dtype=_as_dtype(dtype)),
            self.device, seed, trained_model_path)

    @torch.no_grad()
    def __call__(self, image_rgb: np.ndarray, topk: int = 5):
        x = square_resize(image_rgb, self.input_size, self.device)
        probs = torch.softmax(self.model(x).float(), -1)[0].cpu().numpy()
        idx = np.argsort(-probs)[:topk]
        return [(int(i), float(probs[i])) for i in idx]


class DetectionPredictor:
    """Letterboxed dense detection (FCOS or RetinaNet and their decoders):
    (boxes [K, 4] in image pixels, classes [K], scores [K]) above
    ``score_threshold``, as numpy."""

    def __init__(self, network="resnet50_fcos", decoder="FCOSDecoder",
                 num_classes=80, input_size=800, trained_model_path="",
                 decoder_kwargs=None, device="cuda", dtype=torch.bfloat16,
                 seed=0):
        self._setup(network, {"num_classes": num_classes}, decoder,
                    input_size, trained_model_path, decoder_kwargs, device,
                    dtype, seed)

    def _setup(self, network, model_kwargs, decoder, input_size,
               trained_model_path, decoder_kwargs, device, dtype, seed):
        self.device = resolve_device(device)
        self.input_size = input_size
        self.model = _served(
            MODELS.create(network, dtype=_as_dtype(dtype), **model_kwargs),
            self.device, seed, trained_model_path)
        self.decoder = DECODERS.create(decoder, **(decoder_kwargs or {}))

    @torch.no_grad()
    def __call__(self, image_rgb: np.ndarray, score_threshold: float = 0.3):
        canvas, factor, _ = letterbox(image_rgb, self.input_size, self.device)
        scores, classes, boxes = self.decoder(self.model(canvas[None]))
        keep = scores[0] > score_threshold
        return boxes[0][keep] / factor, classes[0][keep], scores[0][keep]


class FaceDetectionPredictor(DetectionPredictor):
    """RetinaFace: one face class, so no ``num_classes``."""

    def __init__(self, network="resnet50_retinaface",
                 decoder="RetinaFaceDecoder", input_size=1024,
                 trained_model_path="", decoder_kwargs=None, device="cuda",
                 dtype=torch.bfloat16, seed=0):
        self._setup(network, {}, decoder, input_size, trained_model_path,
                    decoder_kwargs, device, dtype, seed)


class SemanticSegmentationPredictor:
    """The argmax label map of a square-resized image, resized back
    nearest: uint8 [h, w]."""

    def __init__(self, network="resnet50_deeplabv3plus", num_classes=150,
                 input_size=512, trained_model_path="", device="cuda",
                 dtype=torch.bfloat16, seed=0):
        self.device = resolve_device(device)
        self.input_size = input_size
        self.model = _served(
            MODELS.create(network, num_classes=num_classes,
                          dtype=_as_dtype(dtype)),
            self.device, seed, trained_model_path)

    @torch.no_grad()
    def __call__(self, image_rgb: np.ndarray) -> np.ndarray:
        x = square_resize(image_rgb, self.input_size, self.device)
        mask = torch.argmax(self.model(x), -1)[0].to(torch.uint8)
        return resize_nearest(mask, image_rgb.shape[:2]).cpu().numpy()


class ParsingPredictor(SemanticSegmentationPredictor):
    """Face and human parsing on the PFAN parsing heads (19 classes unless
    told otherwise, for human parsing too, as the JAX server builds it)."""

    def __init__(self, network="resnet50_pfan_face_parsing", num_classes=19,
                 input_size=512, trained_model_path="", device="cuda",
                 dtype=torch.bfloat16, seed=0):
        super().__init__(network=network, num_classes=num_classes,
                         input_size=input_size,
                         trained_model_path=trained_model_path, device=device,
                         dtype=dtype, seed=seed)


class BinarySegmentationPredictor:
    """PFAN's sigmoid map (a matting model's fused alpha, its last output)
    of a square-resized image, resized back bilinearly: f32 [h, w]."""

    def __init__(self, network="resnet50_pfan_segmentation", input_size=832,
                 trained_model_path="", output_head=None, device="cuda",
                 dtype=torch.bfloat16, seed=0):
        self.device = resolve_device(device)
        self.input_size = input_size
        self.output_head = output_head
        self.model = _served(MODELS.create(network, dtype=_as_dtype(dtype)),
                             self.device, seed, trained_model_path)

    @torch.no_grad()
    def __call__(self, image_rgb: np.ndarray) -> np.ndarray:
        out = self.model(square_resize(image_rgb, self.input_size,
                                       self.device))
        if isinstance(out, (tuple, list)):  # matting: (global, local, fused)
            out = out[-1]
        alpha = F.interpolate(out[..., 0].float()[None],
                              size=image_rgb.shape[:2], mode="bilinear",
                              align_corners=False, antialias=False)
        return alpha[0, 0].cpu().numpy()


class HumanMattingPredictor(BinarySegmentationPredictor):
    """The fused alpha of the PFAN matting model's three heads."""

    def __init__(self, network="resnet50_pfan_matting", input_size=832,
                 trained_model_path="", device="cuda", dtype=torch.bfloat16,
                 seed=0):
        super().__init__(network=network, input_size=input_size,
                         trained_model_path=trained_model_path, device=device,
                         dtype=dtype, seed=seed)


class InstanceSegmentationPredictor:
    """Letterboxed SOLOv2 or YOLACT (``num_classes + 1`` with the
    background for YOLACT): (uint8 [h, w] masks, classes [K], scores [K])
    above ``score_threshold``."""

    def __init__(self, network="resnet50_solov2", decoder="SOLOV2Decoder",
                 num_classes=80, input_size=1024, trained_model_path="",
                 decoder_kwargs=None, device="cuda", dtype=torch.bfloat16,
                 seed=0):
        self.device = resolve_device(device)
        self.input_size = input_size
        classes = num_classes + 1 if "yolact" in network else num_classes
        self.model = _served(
            MODELS.create(network, num_classes=classes,
                          dtype=_as_dtype(dtype)),
            self.device, seed, trained_model_path)
        self.decoder = DECODERS.create(decoder, **(decoder_kwargs or {}))

    @torch.no_grad()
    def __call__(self, image_rgb: np.ndarray, score_threshold: float = 0.3):
        h, w = image_rgb.shape[:2]
        s = self.input_size
        canvas, _, (nh, nw) = letterbox(image_rgb, s, self.device)
        masks, labels, scores = self.decoder(self.model(canvas[None]))
        keep = scores[0] > score_threshold
        kept = masks[0][keep]
        # the JAX predictor's resize to s x s, crop to (nh, nw) and resize
        # to (h, w), all nearest, as one gather
        iy = nearest_indices(kept.shape[1], s)[nearest_indices(nh, h)]
        ix = nearest_indices(kept.shape[2], s)[nearest_indices(nw, w)]
        out_masks = [m[np.ix_(iy, ix)].astype(np.uint8) for m in kept]
        return out_masks, labels[0][keep], scores[0][keep]


class TextDetectionPredictor:
    """Letterboxed DBNet and ``DBNetDecoder``: (polygons [K_i, 2] f32 in
    image pixels, scores)."""

    def __init__(self, network="resnet50_dbnet", input_size=1024,
                 trained_model_path="", decoder_kwargs=None, device="cuda",
                 dtype=torch.bfloat16, seed=0):
        self.device = resolve_device(device)
        self.input_size = input_size
        self.model = _served(MODELS.create(network, dtype=_as_dtype(dtype)),
                             self.device, seed, trained_model_path)
        self.decoder = DBNetDecoder(**(decoder_kwargs or {}))

    @torch.no_grad()
    def __call__(self, image_rgb: np.ndarray):
        canvas, factor, _ = letterbox(image_rgb, self.input_size, self.device)
        boxes, scores = self.decoder(self.model(canvas[None]))[0]
        return [np.asarray(b, np.float32) / factor for b in boxes], scores


class TextRecognitionPredictor:
    """CTC greedy decode of a line resized to ``input_h`` high (at most
    ``input_w`` wide) on a zero canvas; ``chars`` defaults to printable
    ASCII."""

    def __init__(self, backbone="resnet50", encoder="BiLSTMEncoder",
                 chars=None, str_max_length=80, input_h=32, input_w=512,
                 trained_model_path="", device="cuda", dtype=torch.bfloat16,
                 seed=0):
        self.device = resolve_device(device)
        if chars is None:
            chars = [chr(c) for c in range(32, 127)]
        self.converter = CTCTextLabelConverter(chars, str_max_length)
        self.input_h, self.input_w = input_h, input_w
        self.model = _served(
            CTCModel(backbone_type=backbone, encoder_type=encoder,
                     num_classes=self.converter.num_classes,
                     dtype=_as_dtype(dtype)),
            self.device, seed, trained_model_path)

    @torch.no_grad()
    def __call__(self, image_rgb: np.ndarray) -> str:
        h, w = image_rgb.shape[:2]
        nw = min(int(round(w * self.input_h / h)), self.input_w)
        canvas = torch.zeros(1, self.input_h, self.input_w, 3,
                             device=self.device)
        canvas[0, :, :nw] = _resized(image_rgb, (self.input_h, nw),
                                     self.device)
        idxs = torch.argmax(self.model(canvas), -1).cpu().numpy()
        return self.converter.decode(idxs)[0]


class SAMPredictor:
    """Point-, box- and drawn-region-prompted SAM masks: one image and one
    prompt a request, letterboxed, encoded, decoded with the prompt, and
    the best of the four masks (by predicted IoU) binarised and resized
    back to the image's shape.

    ``network`` names a registered SAM (``sam_b``, ``sam_l``, ``sam_h``).
    """

    def __init__(self, network="sam_b", image_size=1024,
                 trained_model_path="", device="cuda", dtype=torch.bfloat16,
                 seed=0, **model_kwargs):
        self.device = resolve_device(device)
        self.image_size = image_size
        self.model = _served(
            MODELS.create(network, image_size=image_size,
                          dtype=_as_dtype(dtype), **model_kwargs),
            self.device, seed, trained_model_path)

    @torch.no_grad()
    def mask_logits(self, image_rgb: np.ndarray, points_xy=None,
                    box_xyxy=None):
        """Logits [S, S] of the best mask for a point or a box prompt in
        image coordinates, with the letterbox's (nh, nw)."""
        s = self.image_size
        canvas, factor, (nh, nw) = letterbox(image_rgb, s, self.device)
        prompts = {"prompt_point": None, "prompt_box": None,
                   "prompt_mask": None}
        if box_xyxy is not None:
            box = [float(v) * factor for v in box_xyxy]
            prompts["prompt_box"] = torch.tensor([box], device=self.device)
        else:
            pts = np.full((1, 9, 3), -1.0, np.float32)
            for i, (x, y) in enumerate(list(points_xy)[:9]):
                pts[0, i] = [x * factor, y * factor, 1.0]
            prompts["prompt_point"] = torch.from_numpy(pts).to(self.device)
        masks, ious = self.model(canvas[None], prompts, (0, 1, 2, 3))
        best = torch.argmax(ious[0])
        return masks[0, best], (nh, nw)

    def _binary_mask(self, logits, nhw, hw) -> np.ndarray:
        nh, nw = nhw
        mask = (logits > 0).to(torch.uint8)[:nh, :nw]
        return resize_nearest(mask, hw).cpu().numpy()

    def __call__(self, image_rgb: np.ndarray, points_xy) -> np.ndarray:
        """uint8 {0, 1} mask [h, w] for up to 9 positive clicks (x, y)."""
        logits, nhw = self.mask_logits(image_rgb, points_xy=points_xy)
        return self._binary_mask(logits, nhw, image_rgb.shape[:2])

    def predict_box(self, image_rgb: np.ndarray, box_xyxy) -> np.ndarray:
        """uint8 {0, 1} mask [h, w] for a box prompt (x1, y1, x2, y2)."""
        logits, nhw = self.mask_logits(image_rgb, box_xyxy=box_xyxy)
        return self._binary_mask(logits, nhw, image_rgb.shape[:2])

    def predict_region(self, image_rgb: np.ndarray,
                       region_mask: np.ndarray) -> np.ndarray:
        """Drawn-region prompt: the bounding rectangle of the region's
        nonzero pixels becomes the box prompt."""
        m = np.asarray(region_mask)
        if m.ndim == 3:
            m = _rgb_to_gray_u8(m.astype(np.uint8))
        x, y, bw, bh = bounding_rect(m > 0)
        return self.predict_box(image_rgb, (x, y, x + bw, y + bh))
