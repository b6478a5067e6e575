#!/usr/bin/env python3
"""Drives the PyTorch port (``simpleaicv_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases training,seg_train [--tree DIR]

The second form runs only the named phases (``phase_<name>``, each given
the card alone) after the device phase, in a new process from ``DIR``'s
``chip_smoke.py`` and package (default: this checkout), and prints no
kernels line: two trees' phases compared in one run on one card.

Phases, each of which raises (exit code 1) on failure:
  1. device: requires a CUDA card and prints its name and power limit;
  2. kernels: builds every hand kernel from the sources in the checkout (one
     nvcc per source, started together) and holds the flash-attention ones
     against their plain PyTorch versions on the card, at the shapes the
     main paths give them and at edge shapes, and times each beside its
     plain version, a PyTorch library call and its bound;
  3. serving: serves SAM-B 1024x1024 interactive-segmentation requests
     through ``SAMPredictor`` on the card, counts the kernel launches of
     that run, and compares the masks with the same requests on the plain
     path;
  3b. http_serving: starts the port's HTTP server (``demo/serve.py``) with
     all twelve tasks at their predictors' defaults (full widths, bf16) on
     the card and posts JPEG bodies over real sockets (1280x720 and
     720x1280 images, a 48x400 strip for recognition; point, box and PNG
     requests to SAM-B): 2 warm-up and 8 timed requests a task, the host
     clock's median and maximum latency, one profiled request's device
     busy time and idle share, K4 4 times a SAM request and no hand kernel
     on the other endpoints, the responses' keys and shapes; then one
     small f32 request a task on the card (TF32 off) against the CPU;
  4. training: takes ViT-B/16 224x224 bf16 train steps at batch 128 through
     the engine's ``make_train_step`` (flash attention, the AdamW recipe
     with layer-wise lr decay and a warm-up cosine schedule), counts the
     kernel launches of that run, profiles one step, and compares one
     more engine step's loss and gradients, on the whole batch, with the
     einsum attention path;
  5. SAM training: takes SAM-B 1024x1024 train steps at batch 8 through the
     same ``make_train_step`` (bf16 encoder with gradient checkpointing and
     flash attention, ``SAMMultiLevelLoss``, the sa_1b/sam_b recipe's AdamW
     and schedule) on batches from the port's synthetic dataset and
     collater, in the trainer's per-batch loop: one prompt kind per batch, a
     point batch taking two optimizer steps with a no-grad prediction and a
     new click between them. It counts the rel-pos kernels' launches of
     every step, profiles one step, and compares one more step's loss and
     gradients with the einsum attention path;
  6. MSDA kernels: holds the multi-scale deformable attention kernels (K7
     and its backward, each tiled or its narrow variant) against their
     plain versions at edge shapes, through the module with 2-D and 4-D
     reference points, and at DINO-DETR's encoder and decoder launches at
     batch 2 (the plain version run over chunks of queries), and times them
     there beside their bound, the reference's grid_sample composition and
     their narrow variants (K7 in alternating rounds); then DCNv2
     (``ops/dcnv2.py``) at a detection head's shape, x [2, 100, 100, 256],
     3x3, 256 out, forward and backward through K7 and K7b (8 heads of 32,
     one level, one point a query; no narrow launch) against the same
     layer on the plain sampler, timed beside it (path ``dcnv2``);
  7. DINO-DETR training: takes resnet50_dinodetr 1024x1024 train steps at
     batch 2 through ``make_train_step`` (the res50_dinodetr_yoloresize1024
     recipe's DINODETRLoss, AdamW with the backbone at 1e-5 and clipping at
     0.1, MultiStepLR) on batches from the port's synthetic dataset and
     collater, counts the MSDA kernels' launches of every step, times the
     host's Hungarian matchings, profiles one step, and compares one step at
     batch 1 with the same model on the plain MSDA; then 3 steps with
     ``matcher="auction"`` (the auction on the card), each matching held
     to the Hungarian one on the same costs within n_gt * eps of its total
     (path ``dino_auction_train``);
  7b. export: ``torch.library.opcheck`` on the seven kernels' operators on
     the card; ViT-B/16 with flash attention (224^2, batch 8), SAM-B's
     image encoder (1024^2) and DINO-DETR R50 (1024^2, batch 1) exported
     through ``tools/convert_to_export.py``'s functions, saved, loaded and
     run, K1 12, K4 4 and K7 12 launches (paths ``export_vit``,
     ``export_sam``, ``export_dino``), each held to the eager model; one
     exported run traced by ``core/tracing.py::trace``, whose Chrome trace
     must name K1's kernel;
  8. probes: holds the roofline probes P1-P3 against their plain versions
     (P1 and P2 through their streams and their narrow variants) at
     ResNet-50's layer-1 and layer-2 1x1 shapes and a ragged M, times P1
     and P2 in alternating rounds beside their narrow variants and library
     calls, and runs the probes, counting their launches;
  9. ResNet-50 training: takes bench.py's step (batch 128, 224x224, bf16)
     through ``make_train_step``, profiles one step, checks and times
     training-mode ``F.batch_norm`` (cuDNN on fp16, PyTorch's own kernels
     on bf16) beside the port's ``bn_train`` at the probes' shapes, and
     compares an f32 batch-8 step with the CPU;
 10. CLIs: trains a scratch imagenet/resnet50 recipe through the train CLI
     (2 epochs, then a resume to 3) and evaluates it through the test CLI;
 11. SAM CLIs: trains SAM-B 1024x1024 (the sa_1b/sam_b recipe's fields,
     32 synthetic images, 1 epoch with its per-dataset IoU) through
     ``tools.train_interactive_segmentation`` and evaluates its best
     checkpoint through ``tools.test_interactive_segmentation``, in this
     process, counting the rel-pos kernels' launches;
 12. DINO-DETR CLIs: trains DINO-DETR R50 1024x1024 (the
     res50_dinodetr_yoloresize1024 recipe's fields at batch 2, 16 synthetic
     images, 1 epoch with its COCO evaluation) through
     ``tools.train_detr_detection`` and evaluates its best checkpoint
     through ``tools.test_detection``, in this process, counting the MSDA
     kernels' launches;
 13. DeepLabV3+ training (seg_train): takes resnet50_deeplabv3plus 512x512
     bf16 train steps at batch 16 with 150 classes through
     ``make_train_step`` (the ade20k recipe's SegCELoss, AdamW and PolyLR)
     on a resident batch with ignored pixels, profiles one step, replays
     each BatchNorm call of a step and the f32 logits path (prediction
     convolution, the align-corners resize, the loss) alone for their
     shares, and times the logits' resize beside ``F.interpolate``;
 14. segmentation CLIs (seg_cli): trains DeepLabV3+ R50 (the ade20k
     recipe's fields and train transforms, 32 synthetic 640x640 images, 1
     epoch with its mIoU evaluation) through
     ``tools.train_semantic_segmentation`` and evaluates its best through
     ``tools.test_semantic_segmentation``, in this process;
 15. PFAN (pfan_train, pfan_cli): takes PFAN R50 832x832 train steps at
     batch 8 on a resident batch, then trains it (the combined/resnet50_pfan
     recipe's fields, 32 synthetic images, 1 epoch) through
     ``tools.train_salient_object_detection`` and evaluates its best
     through ``tools.test_salient_object_detection``;
 16. seg_learns: trains resnet18_deeplabv3plus on 64 synthetic 64x64
     images for 12 epochs and fails unless its best mIoU reaches 60;
 17. fcos_train: takes FCOS R50 train steps on the coco recipe's 1333x1333
     canvas at batch 8 (FCOSLoss, AdamW, MultiStepLR) on a resident batch,
     profiles one step and replays the loss alone;
 18. retina_train: the same for RetinaNet R50 (RetinaLoss) and RetinaFace
     R50 at 1024x1024 (the widerface recipe, RetinaFaceLoss);
 19. sapiens_train: takes Sapiens-0.3B face-parsing steps at 512x512,
     batch 8 (the CelebAMask-HQ recipe: SegCELoss + SegIoULoss, AdamW,
     CosineLR), profiles one step and replays the einsum attention and the
     parsing head alone;
 20. dense_parity: holds one f32 step of FCOS R50 and of Sapiens-0.3B at
     256x256 on the card (TF32 off) against the CPU, and the FCOS decoder
     on the card against the CPU on the same predictions;
 21. dense_cli: trains and tests fake_synthetic/resnet18_fcos and
     resnet18_retinaface through their CLIs, and Sapiens-0.3B through the
     face-parsing CLIs on 16 synthetic images, in this process;
 22. fcos_learns: trains resnet18_fcos on 64 synthetic 96x96 images for 16
     epochs and fails unless its best mAP reaches 30;
 23. moe_train: takes ViT-MoE-B/16 224x224 bf16 train steps at batch 128
     (the imagenet/vit_moe_base_patch16 recipe's model fields: global pool,
     drop-path 0.1, 8 experts, top-2, capacity factor 1.25; flash attention
     on; OneHotLabelCELoss plus 0.01 x the MoE auxiliary loss; AdamW with
     layer decay 0.75 and no decay on the router; CosineLR) on a resident
     batch, counts K1-K3 (12 launches each a step, none narrow), prints the
     share of token choices dropped past capacity, profiles one step,
     replays the routing alone (router, positions, dispatch and combine)
     for its share, and holds one MoE layer's index dispatch against the
     one-hot form at batch 16;
 24. mae_train: the imagenet/vit_base_mae recipe (ViT-B/16 encoder, 8-block
     512-wide decoder, mask ratio 0.75, MAEMSELoss, AdamW at beta2 0.95) at
     batch 256, cut from 1024, on a resident batch;
 25. kd_train: the imagenet/resnet152_to_resnet50_kd recipe (frozen R152
     teacher, R50 student, CE + KD at T 1, SGD 0.1) at batch 128, cut from
     256, and fails if the teacher's BatchNorm statistics move;
 26. deviceaug_train: the ResNet-50 step at batch 128 on resident uint8
     batches through ``make_train_step``'s ``augment_fn``, with the
     imagenet/vit_base_patch16_deviceaug pipeline (RandAugment(2, 9),
     erasing 0.25, mixup/cutmix) and with AutoAugment v0, times the
     augmentation alone beside the step, and holds the card's augmented
     batch against the CPU's on the same draws;
 27. cls_cli: trains fake_synthetic/vit_moe_tiny, resnet18_kd, tiny_vit_mae
     and resnet18_deviceaug through the port's train CLIs in this process,
     and tests vit_moe_tiny and resnet18_deviceaug through
     ``tools.test_classification``.
 28. sam_distill_train: SAMDistillModel(sam_b, sam_b) at 1024^2, batch 8,
     SAMDistillLoss on point and box prompts, the teacher frozen (the
     sa_1b/sam_b recipe's AdamW), through the distillation CLI's loss
     function: K4/K5/K6 8/4/4 a step, the teacher unmoved;
 29. sam_encoder_distill_train: the same pair through
     SAMDistillEncoderModel and SAMDistillMSELoss: 8/4/4 a step;
 30. sam_matting_train: sam_b_matting1 at 1024^2, batch 8, with
     SAMMattingOneLevelLoss (mask_threshold 0.5) through the matting CLI's
     loss function: 4/4/4 a step; one checked step of sam_b_matting2 with
     SAMMattingMultiLevelAssignLoss;
 31. pfan_matting_train: resnet50_pfan_matting at 832^2, batch 8, the
     seven-loss stack, both BatchNorm kinds replayed alone for their
     shares;
 32. matting_cli: fake_synthetic/tiny_sam_distill, tiny_sam_encoder_distill,
     tiny_sam_matting and resnet18_pfan_matting through their CLIs, then
     SAM-B matting 1024^2 through the SAM-matting train and test CLIs in
     this process (16/8/8 launches of K4/K5/K6).
 33. solov2_train: resnet50_solov2 at coco/res50_solov2's fields (1024^2,
     80 classes, SOLOV2Loss, AdamW, MultiStepLR) on a resident batch from
     the port's collater, batch 16 or the largest cut that fits (each cut
     printed), profiles one step and replays the loss alone;
 34. yolact_train: the same for resnet50_yolact at coco/res50_yolact's
     fields (81 classes, 65,472 anchors, YOLACTLoss), batch 64 or the
     largest cut that fits;
 35. inst_parity: one f32 SOLOv2 R50 step at 256^2 on the card (TF32 off)
     against the CPU, and both decoders on the card against the CPU on the
     same predictions;
 36. inst_cli: fake_synthetic/resnet18_solov2 and resnet18_yolact through
     the instance-segmentation CLIs in this process;
 37. ddpm_train: the celebahq/ddpm_64 UNet at 64^2, batch 64, f32, then the
     1000-step DDPM sampler on 4 images and a 50-step DDIM one on 16, the
     InceptionV3 features and FID/IS arithmetic on seeded weights (time
     only);
 38. diffusion_cli: fake_synthetic/tiny_ddpm through the diffusion CLIs,
     the PNGs they write read back;
 39. ddpm_learns: the tiny DDPM on 64 two-mode 16x16 images for 90 epochs,
     failing unless 64 samples reproduce both modes (the JAX test's
     bounds on the two shares); the mean distance to the nearer mode
     printed beside the JAX test's 0.33 for that draw and ten.
 40. dbnet_train: resnet50_dbnet at 1024^2 (combined/convformerm36_dbnet's
     fields with the R50 trunk: DBNetLoss, AdamW, PolyLR) on resident
     batches from the port's synthetic dataset, map generator and collater,
     batch 16 or the largest cut that fits; the map generator's ms a
     sample, the loss replayed alone and its OHEM sort alone;
 41. ctc_train: CTCModel (OCR R50 trunk, TransformerEncoder, 12,112
     classes) at 32 x 512 (combined/convformerm36_ctc's fields), batch 512
     or the largest cut that fits; 4 labels longer than the 64 steps allow,
     whose CTC loss must be 0; the loss replayed alone;
 42. dbnet_learns: resnet18_dbnet on 32 synthetic 128x128 images for 20
     epochs, failing unless its best polygon F1 reaches 40 (the JAX test's
     bound), the F1 of every epoch printed;
 43. ocr_parity: one f32 step of resnet18_dbnet at 256^2 and of the
     resnet18 BiLSTM CTC model at 32 x 256 on the card (TF32 off) against
     the CPU, and DBNetDecoder on the card's maps of phase 42's model
     against the CPU's;
 44. ocr_cli: fake_synthetic/resnet18_dbnet and resnet18_ctc through the
     OCR train and test CLIs in this process.
 45. prepared_data: the port's ``prepare_dataset`` on the host: a folder
     of 24 image/PNG-mask pairs at mixed sizes (902 x 2276 and 1280 x 720
     among them) through ``sam-masks`` for train and test, RCTW- and
     ART-style trees through ``rctw``/``art``, ``text-lines`` and
     ``char-table``, LIP- and CelebAMask-HQ-style trees through ``lip``
     and ``celebamask-hq`` (each subcommand's seconds and ms an image);
     then SAM-B 1024^2 at batch 8 for an epoch on the converted SA-1B
     tree and its evaluation through the SAM train and test CLIs in this
     process (K4, K5 and K6 each launched, none narrow), the OCR and
     parsing outputs read back through the port's readers, and one step
     each of resnet18_dbnet and the resnet18 BiLSTM CTC model on the card
     from them (no hand kernel);
 46. parallel: a world of ``min(cards, 4)`` ranks under NCCL through the
     port's launcher (one card: a world of one in this process through a
     ``FileStore``): three ViT-B/16 b128 flash steps through the
     distributed engine, each rank its rows (in a world of one equal bit
     for bit to the same steps without a process group, which run twice
     to show they repeat; K1-K3 12 launches a step each); one epoch of
     ViT-B/16 b128 flash (3 steps and a 128-image evaluation) through the
     classification train CLI's ``Trainer`` with both checkpoints (K1-K3
     12 a step, K1 12 more for the evaluation); ``pipeline_vit``
     on ViT-B/16 with flash, eval b128, 4 microbatches over ``world``
     stages against the plain forward (K1 12 a microbatch over all
     stages), ring attention at [2, 12, 4096, 64] f32 over the world
     against full attention with dq, dk, dv, and one FSDP2 step of the
     multichip check's ResNet-18 against the plain step.
Phases 23-34, 37, 40 and 41 print images/s, ms a step, peak memory, the
idle share and the top rows of one profiled step where they train on a
resident batch. The paths of phases 13-22, 24-27, 31 and 33-44 and the
four fake_synthetic configs of phase 32 (16 tokens in their global layer)
launch no hand kernel, which each checks.
The script prints each phase's seconds and its total time.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from simpleaicv_tpu_torch.core.engine import (EngineConfig,
                                              create_train_state,
                                              make_train_step)
from simpleaicv_tpu_torch.core.optim import OptimizerConfig, build_optimizer
from simpleaicv_tpu_torch.core.registry import (BACKBONES, DECODERS, LOSSES,
                                                MODELS)
from simpleaicv_tpu_torch.core.schedule import SchedulerConfig
from simpleaicv_tpu_torch.core.trainer import (
    optimizer_config_from_reference, scheduler_config_from_reference)
from simpleaicv_tpu_torch.data.binary_segmentation import (BinarySegCollater,
                                                           BinarySegResize)
from simpleaicv_tpu_torch.data.datasets import (FakeClassificationDataset,
                                                FakeDetectionDataset)
from simpleaicv_tpu_torch.data.instance_segmentation import (
    FakeInstanceSegmentationDataset, InstanceNormalize,
    InstanceSegmentationResize, SOLOV2InstanceSegmentationCollater,
    YOLACTInstanceSegmentationCollater)
from simpleaicv_tpu_torch.data.detection import (DetectionCollater,
                                                 DetectionResize,
                                                 DETRDetectionCollater,
                                                 Normalize)
from simpleaicv_tpu_torch.data.interactive_segmentation import (
    FakeSAMSegmentationDataset, SAMBatchCollater, SAMMattingCollater)
from simpleaicv_tpu_torch.data.matting import (FakeHumanMattingDataset,
                                               HumanMattingCollater,
                                               MattingNormalize)
from simpleaicv_tpu_torch.data.text_detection import (
    DBNetDecoder, FakeTextDetectionDataset, TextDetectionCollater)
from simpleaicv_tpu_torch.data.text_recognition import (
    CTCTextLabelConverter, FakeTextRecognitionDataset,
    KeepRatioResizeTextRecognitionCollater)
from simpleaicv_tpu_torch.data.segmentation import (
    FakeSegmentationDataset, SegNormalize, SemanticSegmentationCollater)
from simpleaicv_tpu_torch.data.transforms import Compose
from simpleaicv_tpu_torch.demo import codec as serve_codec
from simpleaicv_tpu_torch.demo import predictors as serve_predictors
from simpleaicv_tpu_torch.demo import serve as http_serve
from simpleaicv_tpu_torch.demo.predictors import SAMPredictor, bounding_rect
from simpleaicv_tpu_torch.diffusion import (DDIMSampler, DDPMSampler,
                                            DDPMTrainer)
from simpleaicv_tpu_torch.evaluation import fid_is
from simpleaicv_tpu_torch.losses import dinodetr as dino_loss
from simpleaicv_tpu_torch.models.common import BatchNorm, init_params
from simpleaicv_tpu_torch.models.text_recognition import CTCModel
from simpleaicv_tpu_torch.models.detection import dinodetr
from simpleaicv_tpu_torch.models.interactive_segmentation.light_sam import (
    SAMDistillEncoderModel, SAMDistillModel)
from simpleaicv_tpu_torch.ops import _build
from simpleaicv_tpu_torch.ops import flash_attention as fa
from simpleaicv_tpu_torch.ops import dcnv2, msda
from simpleaicv_tpu_torch.ops.fused_bn import FusedBatchNorm, bn_train
from simpleaicv_tpu_torch.ops.upsample import resize_bilinear
from simpleaicv_tpu_torch.perf import bw_probe, matmul_probe
from simpleaicv_tpu_torch.perf.msda_split import (DINO_BATCH, DINO_LEVELS,
                                                  DINO_POINTS, launch_inputs)
from simpleaicv_tpu_torch.perf.timing import alternating_ms as _alternating
from simpleaicv_tpu_torch.perf.timing import bound as _bound
from simpleaicv_tpu_torch.perf.timing import cuda_ms as _cuda_ms
from simpleaicv_tpu_torch.data import device_augment as dev_aug
from simpleaicv_tpu_torch.parallel import moe
from simpleaicv_tpu_torch.tasks import binary_segmentation as bseg_task
from simpleaicv_tpu_torch.tasks import diffusion as diff_task
from simpleaicv_tpu_torch.tasks import instance_segmentation as inst_task
from simpleaicv_tpu_torch.tasks import distillation as kd_task
from simpleaicv_tpu_torch.tasks import mae as mae_task
from simpleaicv_tpu_torch.tasks import matting as matting_task
from simpleaicv_tpu_torch.tasks import detection as det_task
from simpleaicv_tpu_torch.tasks import interactive_segmentation as sam_task
from simpleaicv_tpu_torch.tasks import semantic_segmentation as seg_task
from simpleaicv_tpu_torch.tasks import text_detection as text_det_task
from simpleaicv_tpu_torch.tasks import text_recognition as text_rec_task
from simpleaicv_tpu_torch.tasks.classification import make_loss_fn
from simpleaicv_tpu_torch.tasks.detection import make_detr_loss_fn
from simpleaicv_tpu_torch.core import tracing
from simpleaicv_tpu_torch.tools import convert_to_export as export_tool
from simpleaicv_tpu_torch.tools import test_classification as cls_test_cli
from simpleaicv_tpu_torch.tools import test_detection as det_test_cli
from simpleaicv_tpu_torch.tools import train_classification as cls_train_cli
from simpleaicv_tpu_torch.tools import train_distill_classification as \
    kd_train_cli
from simpleaicv_tpu_torch.tools import train_mae_self_supervised as \
    mae_train_cli
from simpleaicv_tpu_torch.tools import test_face_detection as \
    face_det_test_cli
from simpleaicv_tpu_torch.tools import test_face_parsing as \
    face_parsing_test_cli
from simpleaicv_tpu_torch.tools import test_interactive_segmentation as \
    sam_test_cli
from simpleaicv_tpu_torch.tools import train_detection as dense_train_cli
from simpleaicv_tpu_torch.tools import train_detr_detection as det_train_cli
from simpleaicv_tpu_torch.tools import train_face_detection as \
    face_det_train_cli
from simpleaicv_tpu_torch.tools import train_face_parsing as \
    face_parsing_train_cli
from simpleaicv_tpu_torch.tools import train_interactive_segmentation as \
    sam_train_cli
from simpleaicv_tpu_torch.tools import \
    train_interactive_segmentation_distill as sam_encoder_distill_cli
from simpleaicv_tpu_torch.tools import \
    train_interactive_segmentation_distill_sam as sam_distill_cli
from simpleaicv_tpu_torch.tools import test_human_matting as \
    human_matting_test_cli
from simpleaicv_tpu_torch.tools import train_human_matting as \
    human_matting_cli
from simpleaicv_tpu_torch.tools import test_interactive_matting as \
    sam_matting_test_cli
from simpleaicv_tpu_torch.tools import train_interactive_matting as \
    sam_matting_cli
from simpleaicv_tpu_torch.tools import test_salient_object_detection as \
    sod_test_cli
from simpleaicv_tpu_torch.tools import test_semantic_segmentation as \
    seg_test_cli
from simpleaicv_tpu_torch.tools import train_salient_object_detection as \
    sod_train_cli
from simpleaicv_tpu_torch.tools import train_semantic_segmentation as \
    seg_train_cli
from simpleaicv_tpu_torch.tools import test_diffusion_model as \
    diffusion_test_cli
from simpleaicv_tpu_torch.tools import test_instance_segmentation as \
    inst_test_cli
from simpleaicv_tpu_torch.tools import train_diffusion_model as \
    diffusion_train_cli
from simpleaicv_tpu_torch.tools import test_text_detection as \
    text_det_test_cli
from simpleaicv_tpu_torch.tools import test_text_recognition as \
    text_rec_test_cli
from simpleaicv_tpu_torch.tools import train_text_detection as \
    text_det_train_cli
from simpleaicv_tpu_torch.tools import train_text_recognition as \
    text_rec_train_cli
from simpleaicv_tpu_torch.tools import train_instance_segmentation as \
    inst_train_cli

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def _relpos_inputs(bh, k_h, k_w, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    n = k_h * k_w
    q, k, v = (torch.randn(bh, n, d, generator=g).to("cuda", dtype)
               for _ in range(3))
    rel_h = torch.randn(bh, n, k_h, generator=g).cuda()
    rel_w = torch.randn(bh, n, k_w, generator=g).cuda()
    return q, k, v, rel_h, rel_w


# (name, BH, k_h, k_w, d): SAM-B and SAM-H global layers at 1024^2, a
# non-square grid, and a tail (N = 100 is no multiple of the 64-query tile;
# k_w = 10 and d = 40 are padded inside the kernels).
RELPOS_SHAPES = [("sam_b", 12, 64, 64, 64), ("sam_h", 16, 64, 64, 80),
                 ("grid_8x16", 4, 8, 16, 32), ("tail_10x10", 3, 10, 10, 40)]


# SAM training's batch (the sa_1b/sam_b recipe's), and with it the rel-pos
# kernels' shape on the training path: 12 heads x 8 images in one launch
SAM_BATCH = 8
SAM_TRAIN_BH = 12 * SAM_BATCH


def _relpos_bwd_inputs(bh, k_h, k_w, d, dtype, seed):
    """(q, k, v, rel_h, rel_w, dO, lse, delta) as the backward gets them:
    the forward kernel's o and lse, delta = rowsum(dO * o) in f32."""
    q, k, v, rel_h, rel_w = _relpos_inputs(bh, k_h, k_w, d, dtype, seed)
    g = torch.Generator().manual_seed(seed + 100)
    do = torch.randn(bh, k_h * k_w, d, generator=g).to("cuda", dtype)
    o, lse = fa._flash_relpos_fwd_cuda(q, k, v, rel_h, rel_w)
    delta = (do.float() * o.float()).sum(dim=-1)
    return q, k, v, rel_h, rel_w, do, lse, delta


def _by_head_chunks(plain_fn, args, chunk=16):
    """The plain version on ``chunk`` heads of the same inputs at a time, the
    outputs joined: its f32 [BH, N, N] scores and their copies are 1 GB each
    at 16 heads of SAM-B and would crowd the card at a batch's 96. Every
    head is independent, so the result is the plain version's own."""
    outs = [plain_fn(*(a[i:i + chunk] for a in args))
            for i in range(0, args[0].shape[0], chunk)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(col) for col in zip(*outs))


def _sdpa_bias(rel_h, rel_w, bh, n):
    """The materialised bf16 [B, 12, N, N] bias of the library call."""
    return (rel_h[..., :, None] + rel_w[..., None, :]).to(
        torch.bfloat16).reshape(bh // 12, 12, n, n)


def _relpos_bwd_times(card, bh, errs):
    """K5 and K6 at SAM-B's global layer (bf16, N 4096, d 64) with ``bh``
    heads in one launch: the kernels, their narrow variants (the mma.sync
    kernels, fed 4-byte aligned copies) and the library call timed in
    turns, 5 rounds of 20 launches (medians, with each reading's rounds),
    then the plain versions and the bounds."""
    k_h = k_w = d = 64
    n, dtype = k_h * k_w, torch.bfloat16
    args = _relpos_bwd_inputs(bh, k_h, k_w, d, dtype, seed=49)
    q, k, v, rel_h, rel_w, do = args[:6]
    narrow = (*(_unaligned(t) for t in (q, k, v)), rel_h, rel_w,
              _unaligned(do), *args[6:])
    if (_bwd_variant(args), _bwd_variant(narrow)) != ("tma", "narrow"):
        raise RuntimeError("the timed inputs miss the kernels' variants")
    # the library call: SDPA with the materialised bf16 bias and its autograd
    # backward, which gives dq, dk, dv and the bias gradient in one call
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql, kl, vl = (t.reshape(bh // 12, 12, n, d).detach().requires_grad_()
                  for t in (q, k, v))
    bias = _sdpa_bias(rel_h, rel_w, bh, n).requires_grad_()
    o_lib = sdpa(ql, kl, vl, attn_mask=bias)
    times = _alternating({
        "dq": lambda: fa._flash_relpos_dq_cuda(*args),
        "dkv": lambda: fa._flash_relpos_dkv_cuda(*args),
        "library": lambda: torch.autograd.grad(
            o_lib, (ql, kl, vl, bias), do.reshape(ql.shape),
            retain_graph=True),
        "dq_narrow": lambda: fa._flash_relpos_dq_cuda(*narrow),
        "dkv_narrow": lambda: fa._flash_relpos_dkv_cuda(*narrow)})
    del o_lib, bias, ql, kl, vl, narrow
    library_ms = statistics.median(times["library"])
    tensor = bh * n * d * 2                       # one bf16 [BH, N, d]
    tables = bh * n * (k_h + k_w) * 4             # rel_h and rel_w, f32
    rows = bh * n * 4                             # one f32 [BH, N]
    pairs = 2.0 * n * n * d * bh                  # one product's operations
    cases = [
        ("flash_attention_relpos_dq", "dq", 276,
         fa.flash_attention_relpos_dq_reference,
         3 * pairs, 5 * tensor + 2 * tables + 2 * rows,
         max(errs[key] for key in ("dq", "drh", "drw"))),
        ("flash_attention_relpos_dkv", "dkv", 312,
         fa.flash_attention_relpos_dkv_reference,
         4 * pairs, 6 * tensor + tables + 2 * rows,
         max(errs["dk"], errs["dv"])),
    ]
    kernels = []
    for name, key, line, plain_fn, flops, nbytes, err in cases:
        ms = statistics.median(times[key])
        narrow_ms = statistics.median(times[f"{key}_narrow"])
        plain_ms = _cuda_ms(lambda: _by_head_chunks(plain_fn, args), 5)
        bound_ms, bound_by = _bound(flops, nbytes, dtype)
        print(f"{name} SAM-B bf16 BH={bh} [{card}]: kernel "
              f"{_spread(times[key])} ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{bound_ms / ms:.3f} of the bound), sdpa+bias backward "
              f"{_spread(times['library'])}, narrow variant (mma.sync) "
              f"{_spread(times[f'{key}_narrow'])} "
              f"({flops / narrow_ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}",
              flush=True)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "simpleaicv_tpu_torch/ops/csrc/flash_relpos_bwd.cu",
            "replaces": f"simpleaicv_tpu/ops/flash_attention.py:{line}",
            "launches": None, "shape": f"BH={bh} N={n} d={d} bf16",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "ms_rounds": times[key],
            "library_ms_rounds": times["library"],
            "narrow_variant_ms": narrow_ms})
    return kernels


def _bwd_variant(args):
    """The rel-pos backward kernels' variant for (q, k, v, rel_h, rel_w,
    dO, lse, delta)."""
    q, k, v, _, rel_w, do = args[:6]
    return fa._relpos_bwd_variant(q, k, v, do, rel_w)


def _relpos_bwd_check(name, args, want_variant, errs_out=None):
    """K5 and K6 on ``args`` against their plain versions: launched twice,
    the two giving the same bits, through the variant ``want_variant``.
    Returns the names of the outputs that disagree."""
    names = ("dq", "drh", "drw", "dk", "dv")
    if _bwd_variant(args) != want_variant:
        raise RuntimeError(f"{name}: the backward takes the "
                           f"{_bwd_variant(args)} kernels, not "
                           f"{want_variant}")
    narrow_before = dict(fa.NARROW_LAUNCHES)
    got = (*fa._flash_relpos_dq_cuda(*args),
           *fa._flash_relpos_dkv_cuda(*args))
    again = (*fa._flash_relpos_dq_cuda(*args),
             *fa._flash_relpos_dkv_cuda(*args))
    narrow = {k: fa.NARROW_LAUNCHES[k] - narrow_before[k]
              for k in ("flash_attention_relpos_dq",
                        "flash_attention_relpos_dkv")}
    if set(narrow.values()) != {2 if want_variant == "narrow" else 0}:
        raise RuntimeError(f"{name}: narrow launches {narrow}")
    want = (*_by_head_chunks(fa.flash_attention_relpos_dq_reference, args),
            *_by_head_chunks(fa.flash_attention_relpos_dkv_reference, args))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = {key: (a.float() - w.float()).abs().max().item()
            for key, a, w in zip(names, got, want)}
    # drh and drw are f32 whatever the inputs: 1e-4; dq, dk, dv as the
    # plain flash kernels' gradients
    tols = {key: _flash_atol(key, w, w.dtype) for key, w in zip(names, want)}
    q, d = args[0], args[0].shape[-1]
    k_h, k_w = args[3].shape[-1], args[4].shape[-1]
    print(f"kernel check relpos bwd {name} ({want_variant}) "
          f"BH={q.shape[0]} grid={k_h}x{k_w} d={d} {str(q.dtype)[6:]}: "
          + " ".join(f"max|{key}-ref|={e:.3e} (atol {tols[key]:.3e})"
                     for key, e in errs.items())
          + f"; two launches {'the same' if same else 'DIFFERENT'} bits",
          flush=True)
    if errs_out is not None:
        errs_out.update(errs)
    return ([f"{name} {q.dtype} {key}" for key, e in errs.items()
             if not e <= tols[key]] + ([] if same else [f"{name} repeat"]))


def phase_relpos_bwd_kernels(card):
    """K5 and K6 (rel-pos dq with drh and drw, and dk/dv) against their plain
    versions at the four rel-pos shapes and at the training path's (SAM-B's
    global layer for a batch of 8, bf16), and their narrow variants on rows
    4 bytes off 16-byte alignment and at d 42; each case launched twice for
    the same bits. Then their times at the training path's shape and,
    beside them, for one image."""
    shape_errs, failed = {}, []
    cases = [(*shape, dtype, 40 + i)
             for i, shape in enumerate(RELPOS_SHAPES)
             for dtype in (torch.float32, torch.bfloat16)]
    cases.append(("sam_b_train", SAM_TRAIN_BH, 64, 64, 64, torch.bfloat16,
                  48))
    for name, bh, k_h, k_w, d, dtype, seed in cases:
        args = _relpos_bwd_inputs(bh, k_h, k_w, d, dtype, seed)
        errs = {}
        # SAM-B's global layers (k_w 64, d 64) take the TMA kernels
        want = ("f32" if dtype == torch.float32 else
                "tma" if k_w == 64 and d <= 64 else "narrow")
        failed += _relpos_bwd_check(name, args, want, errs)
        if dtype == torch.bfloat16:
            shape_errs[name] = errs
        del args
    # the narrow variants (mma.sync, 4-byte staging): inputs whose rows are
    # 4-byte but not 16-byte aligned, and a d that is no multiple of 8
    for name, bh, k_h, k_w, d, offset in (("sam_b_unaligned", 12, 64, 64, 64,
                                           2),
                                          ("d42_8x14", 5, 8, 14, 42, 0)):
        args = _relpos_bwd_inputs(bh, k_h, k_w, d, torch.bfloat16, 50)
        if offset:
            args = (*(_unaligned(t, offset) for t in args[:3]), *args[3:5],
                    _unaligned(args[5], offset), *args[6:])
        failed += _relpos_bwd_check(name, args, "narrow")
        del args
    if failed:
        raise RuntimeError(f"the rel-pos backward kernels disagree with "
                           f"their plain versions at {failed}")

    print("library call: the autograd backward of "
          "scaled_dot_product_attention with the materialised bf16 bias, "
          "which computes dq, dk, dv and the bias gradient in one call, "
          "stands beside both rel-pos backward kernels", flush=True)
    kernels = _relpos_bwd_times(card, SAM_TRAIN_BH, shape_errs["sam_b_train"])
    one_image = _relpos_bwd_times(card, 12, shape_errs["sam_b"])
    for kernel, other in zip(kernels, one_image):
        kernel["other_shapes"] = [_reading(other)]
    return kernels


def _reading(kernel):
    """The measured part of a kernel's entry, for a second shape."""
    return {key: kernel[key] for key in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "ms_rounds", "library_ms_rounds",
        "mma_sync_variant_ms", "narrow_variant_ms", "p1_stream_ms")
        if key in kernel}


def _flash_inputs(b, h, n, d, dtype, seed, offset=0):
    """q, k, v as ViT hands them over ([B, H, N, d] views of one fused
    [B, N, 3, H, d] projection, whose storage starts ``offset`` elements
    into its buffer) and dO as autograd hands it back (a [B, H, N, d] view
    of [B, N, H, d] storage)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g, device="cuda").to(dtype)
    if offset:
        qkv = _unaligned(qkv, offset)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    do = torch.randn(b, n, h, d, generator=g, device="cuda").to(dtype)
    return q, k, v, do.transpose(1, 2)


def _flash_all(q, k, v, do):
    """(o, lse, dq, dk, dv) through the kernels' wrappers."""
    o, lse = fa._flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(dim=-1)
    return (o, lse, fa._flash_dq_cuda(q, k, v, do, lse, delta),
            *fa._flash_dkv_cuda(q, k, v, do, lse, delta))


def _flash_all_plain(q, k, v, do):
    o, lse = fa.flash_attention_reference(q, k, v)
    return (o, lse, *fa.flash_attention_backward_reference(q, k, v, o, lse,
                                                           do))


def _flash_atol(key, want, dtype):
    """Tolerance for output ``key`` of the flash kernels against its plain
    version ``want``. f32 tensors (lse always is one): 1e-4. bf16 o: 8e-3,
    one bf16 step of a value in [1, 2) and two steps below 1, where nearly
    all of o lies; it differs from its plain version by the rounding of one
    f32 result to a neighbour. bf16 gradients: two bf16 steps at the tensor's
    largest value (a step there is at most 2^-7 of it), since they also carry
    the rounding of p or ds to bf16 before the product, where kernel and
    plain version may land a step apart."""
    if dtype == torch.float32 or key == "lse":
        return 1e-4
    if key == "o":
        return 8e-3
    return 2 * 2.0**-7 * want.float().abs().max().item()


def _flash_bwd_check(name, args, want_variant):
    """K2 and K3 on (q, k, v, dO, lse, delta) against their plain versions:
    launched twice, the two giving the same bits, through the variant
    ``want_variant``. Returns the names of the outputs that disagree."""
    if fa._flash_bwd_variant(*args[:4]) != want_variant:
        raise RuntimeError(f"{name}: the backward takes the "
                           f"{fa._flash_bwd_variant(*args[:4])} kernels, "
                           f"not {want_variant}")
    narrow_before = dict(fa.NARROW_LAUNCHES)
    got = (fa._flash_dq_cuda(*args), *fa._flash_dkv_cuda(*args))
    again = (fa._flash_dq_cuda(*args), *fa._flash_dkv_cuda(*args))
    narrow = {k: fa.NARROW_LAUNCHES[k] - narrow_before[k]
              for k in ("flash_attention_dq", "flash_attention_dkv")}
    if set(narrow.values()) != {2 if want_variant == "narrow" else 0}:
        raise RuntimeError(f"{name}: narrow launches {narrow}")
    want = (fa.flash_attention_dq_reference(*args),
            *fa.flash_attention_dkv_reference(*args))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    keys = ("dq", "dk", "dv")
    errs = {key: (a.float() - w.float()).abs().max().item()
            for key, a, w in zip(keys, got, want)}
    # at N 1 the softmax runs over one key, so dq and dk are 0: the plain
    # version and the kernels both give the f32 rounding of dP - delta,
    # which two bf16 steps at that largest value do not resolve; there they
    # are held to the f32 tolerance
    q = args[0]
    one_key = q.shape[-2] == 1
    tols = {key: 1e-4 if one_key and key != "dv"
            else _flash_atol(key, w, w.dtype) for key, w in zip(keys, want)}
    print(f"kernel check flash bwd {name} ({want_variant}) "
          f"B={q.shape[0]} H={q.shape[1]} N={q.shape[2]} d={q.shape[3]}: "
          + " ".join(f"max|{key}-ref|={e:.3e} (atol {tols[key]:.3e})"
                     for key, e in errs.items())
          + f"; two launches {'the same' if same else 'DIFFERENT'} bits",
          flush=True)
    return ([f"{name} {key}" for key, e in errs.items() if not e <= tols[key]]
            + ([] if same else [f"{name} repeat"]))


def _flash_fwd_check(name, q, k, v, want_variant):
    """K1 on (q, k, v) against its plain version: launched twice, the two
    giving the same bits, through the variant ``want_variant``, with a
    narrow launch counted exactly when that variant is the narrow one.
    Returns the names of the outputs that disagree."""
    if fa._flash_fwd_variant(q, k, v) != want_variant:
        raise RuntimeError(f"{name}: the forward takes its "
                           f"{fa._flash_fwd_variant(q, k, v)} kernel, not "
                           f"{want_variant}")
    narrow_before = fa.NARROW_LAUNCHES["flash_attention_fwd"]
    got, again = fa._flash_fwd_cuda(q, k, v), fa._flash_fwd_cuda(q, k, v)
    narrow = fa.NARROW_LAUNCHES["flash_attention_fwd"] - narrow_before
    if narrow != (2 if want_variant == "narrow" else 0):
        raise RuntimeError(f"{name}: {narrow} narrow forward launches")
    want = fa.flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = {key: (a.float() - w.float()).abs().max().item()
            for key, a, w in zip(("o", "lse"), got, want)}
    tols = {key: _flash_atol(key, w, q.dtype)
            for key, w in zip(("o", "lse"), want)}
    print(f"kernel check flash fwd {name} ({want_variant}) B={q.shape[0]} "
          f"H={q.shape[1]} N={q.shape[2]} d={q.shape[3]}: "
          + " ".join(f"max|{key}-ref|={e:.3e} (atol {tols[key]:.3e})"
                     for key, e in errs.items())
          + f"; two launches {'the same' if same else 'DIFFERENT'} bits",
          flush=True)
    return ([f"{name} {key}" for key, e in errs.items() if not e <= tols[key]]
            + ([] if same else [f"{name} fwd repeat"]))


def _flash_edges():
    """K1, K2 and K3 at the edges of their tiling (token counts below, at
    and past the 64-row tiles and the 128- and 256-row items, at d 40 and
    64; one
    head, 133 heads, ViT-B/16's 1536), all through the persistent wgmma
    kernels, and their other variants at d 80 and d 128 (K1's mma.sync
    kernel with 16-byte copies, K2's and K3's narrow ones) and at a fused
    projection 4 bytes off 16-byte alignment (the narrow variants); each
    case launched twice for the same bits."""
    cases = [(f"n{n}_d{d}", 2, 3, n, d, 0, "tma", "tma")
             for n in (1, 5, 16, 17, 64, 65, 128, 129, 197, 208, 257, 300)
             for d in (40, 64)]
    cases += [("bh1", 1, 1, 197, 64, 0, "tma", "tma"),
              ("bh133", 7, 19, 197, 64, 0, "tma", "tma"),
              ("vit_b_b128", 128, 12, 197, 64, 0, "tma", "tma"),
              ("vit_h_d80", 1, 16, 257, 80, 0, "wide_sync", "narrow"),
              ("d128", 1, 2, 130, 128, 0, "wide_sync", "narrow"),
              ("vit_b_unaligned", 2, 12, 197, 64, 2, "narrow", "narrow")]
    failed = []
    for i, (name, b, h, n, d, offset, fwd, bwd) in enumerate(cases):
        q, k, v, do = _flash_inputs(b, h, n, d, torch.bfloat16, seed=60 + i,
                                    offset=offset)
        failed += _flash_fwd_check(name, q, k, v, fwd)
        o, lse = fa.flash_attention_reference(q, k, v)
        delta = (do.float() * o.float()).sum(dim=-1)
        failed += _flash_bwd_check(name, (q, k, v, do, lse, delta), bwd)
        del q, k, v, do, o, lse, delta
    if failed:
        raise RuntimeError(f"the flash kernels disagree with their plain "
                           f"versions at {failed}")


def phase_flash_kernels(card):
    """K1-K3 (flash forward, dq, dk/dv) against their plain versions, also
    at the edges of their tiling, then their times at the ViT-B/16
    batch-128 training shape."""
    # (name, B, H, N, d, offset): ViT-B/16 at batch 128, ViT-H/14 (d 80, N
    # 257), a multiple of the tiles, a tail (N = 5, d = 40 padded in the
    # kernel), and ViT-B/16's inputs 4 bytes off 16-byte alignment, which
    # the bf16 forward reads with its narrow variant (4-byte copies)
    shapes = [("vit_b_b128", 128, 12, 197, 64, 0), ("vit_h", 8, 16, 257, 80, 0),
              ("n256", 2, 4, 256, 64, 0), ("tail_n5", 2, 3, 5, 40, 0),
              ("vit_b_unaligned", 16, 12, 197, 64, 2)]
    names = ("o", "lse", "dq", "dk", "dv")
    main_errs, failed = None, []
    for i, (name, b, h, n, d, offset) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            args = _flash_inputs(b, h, n, d, dtype, seed=20 + i,
                                 offset=offset)
            if dtype == torch.bfloat16:
                assert fa._vector_loads(*args[:3]) == (offset == 0)
            got = _flash_all(*args)
            want = _flash_all_plain(*args)
            torch.cuda.synchronize()
            errs = {key: (a.float() - w.float()).abs().max().item()
                    for key, a, w in zip(names, got, want)}
            tols = {key: _flash_atol(key, w, dtype)
                    for key, w in zip(names, want)}
            print(f"kernel check flash {name} B={b} H={h} N={n} d={d} "
                  f"{str(dtype)[6:]}: " + " ".join(
                      f"max|{key}-ref|={e:.3e} (atol {tols[key]:.3e})"
                      for key, e in errs.items()), flush=True)
            failed += [f"{name} {dtype} {key}" for key, e in errs.items()
                       if not e <= tols[key]]
            if name == "vit_b_b128" and dtype == torch.bfloat16:
                main_errs = errs
            del args, got, want
    if failed:
        raise RuntimeError(f"flash attention kernels disagree with their "
                           f"plain versions at {failed}")
    _flash_edges()

    # times at the training shape: ViT-B/16, batch 128, bf16
    _, b, h, n, d, _ = shapes[0]
    bh, dtype = b * h, torch.bfloat16
    q, k, v, do = _flash_inputs(b, h, n, d, dtype, seed=29)
    o, lse = fa._flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(dim=-1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = sdpa(ql, kl, vl)
    # the forward kernel, its narrow variant (4-byte copies) and SDPA's
    # forward in turns
    narrow = _flash_inputs(b, h, n, d, dtype, seed=29, offset=2)
    if (fa._flash_fwd_variant(q, k, v), fa._flash_fwd_variant(*narrow[:3]),
            fa._flash_bwd_variant(q, k, v, do),
            fa._flash_bwd_variant(*narrow)) != ("tma", "narrow", "tma",
                                                 "narrow"):
        raise RuntimeError("the timed inputs miss the kernels' variants")
    fwd_times = _alternating({
        "kernel": lambda: fa._flash_fwd_cuda(q, k, v),
        "library": lambda: sdpa(q, k, v),
        "narrow": lambda: fa._flash_fwd_cuda(*narrow[:3])})
    # the backward kernels, their narrow variants (the mma.sync kernels, fed
    # 4-byte aligned copies) and SDPA's backward in turns
    bwd_times = _alternating({
        "dq": lambda: fa._flash_dq_cuda(q, k, v, do, lse, delta),
        "dkv": lambda: fa._flash_dkv_cuda(q, k, v, do, lse, delta),
        "library": lambda: torch.autograd.grad(
            o_lib, (ql, kl, vl), do, retain_graph=True),
        "dq_narrow": lambda: fa._flash_dq_cuda(*narrow, lse, delta),
        "dkv_narrow": lambda: fa._flash_dkv_cuda(*narrow, lse, delta)})
    del narrow
    tensor, rows = bh * n * d * 2, bh * n * 4  # one bf16 tensor, one f32 row
    pairs = 2.0 * n * n * d * bh               # one product's operations
    # (name, source, line, rounds, library rounds, plain version, flops,
    # bytes, error)
    cases = [
        ("flash_attention_fwd", "flash_fwd.cu", 34, fwd_times["kernel"],
         fwd_times["library"],
         lambda: fa.flash_attention_reference(q, k, v),
         2 * pairs, 4 * tensor + rows,
         max(main_errs["o"], main_errs["lse"])),
        ("flash_attention_dq", "flash_bwd.cu", 64, bwd_times["dq"],
         bwd_times["library"],
         lambda: fa.flash_attention_dq_reference(q, k, v, do, lse, delta),
         3 * pairs, 5 * tensor + 2 * rows, main_errs["dq"]),
        ("flash_attention_dkv", "flash_bwd.cu", 88, bwd_times["dkv"],
         bwd_times["library"],
         lambda: fa.flash_attention_dkv_reference(q, k, v, do, lse, delta),
         4 * pairs, 6 * tensor + 2 * rows,
         max(main_errs["dk"], main_errs["dv"])),
    ]
    print("library call: scaled_dot_product_attention forward for the "
          "forward kernel; its autograd backward, which computes dq, dk and "
          "dv in one call, stands beside both backward kernels", flush=True)
    # what the wrapper and autograd do around the kernels, per layer
    dq, dk, dv = (t.transpose(1, 2) for t in _flash_all(q, k, v, do)[2:])
    delta_ms = _cuda_ms(lambda: (do.float() * o.float()).sum(dim=-1), 20)
    stack_ms = _cuda_ms(lambda: torch.stack((dq, dk, dv), dim=2), 20)
    print(f"around the kernels, ViT-B/16 b128 bf16 [{card}]: delta = "
          f"rowsum(dO * o) in f32 {delta_ms:.4f} ms; stacking dq, dk, dv "
          f"into the qkv gradient (the one copy left on the path) "
          f"{stack_ms:.4f} ms", flush=True)
    del dq, dk, dv
    kernels = []
    for name, source, line, rounds, lib_rounds, plain_fn, flops, nbytes, \
            err in cases:
        ms, lib = statistics.median(rounds), statistics.median(lib_rounds)
        plain_ms = _cuda_ms(plain_fn, 5)
        bound_ms, bound_by = _bound(flops, nbytes, dtype)
        print(f"{name} ViT-B/16 b128 bf16 [{card}]: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library {lib:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} "
              f"({nbytes / ms / 1e9:.3f} TB/s, {flops / ms / 1e9:.1f} "
              f"TFLOP/s, {bound_ms / ms:.3f} of the bound)", flush=True)
        if name == "flash_attention_fwd":
            print(f"  in 5 rounds of 20: kernel {_spread(rounds)}, sdpa "
                  f"forward {_spread(lib_rounds)}, narrow variant (4-byte "
                  f"copies) {_spread(fwd_times['narrow'])}", flush=True)
        else:
            key = name.split("_")[-1]
            print(f"  in 5 rounds of 20: kernel {_spread(rounds)}, sdpa "
                  f"backward {_spread(lib_rounds)}, narrow variant "
                  f"(mma.sync) {_spread(bwd_times[f'{key}_narrow'])}",
                  flush=True)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"simpleaicv_tpu_torch/ops/csrc/{source}",
            "replaces": f"simpleaicv_tpu/ops/flash_attention.py:{line}",
            "launches": None, "shape": f"BH={bh} N={n} d={d} bf16",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
            "ms_rounds": rounds, "library_ms_rounds": lib_rounds})
        narrow_rounds = (fwd_times["narrow"] if name == "flash_attention_fwd"
                         else bwd_times[f"{name.split('_')[-1]}_narrow"])
        kernels[-1]["narrow_variant_ms"] = statistics.median(narrow_rounds)
    # K2 + K3 against the one library call that computes dq, dk and dv
    pair = [a + b for a, b in zip(bwd_times["dq"], bwd_times["dkv"])]
    ratio = statistics.median(pair) / statistics.median(bwd_times["library"])
    print(f"K2 + K3 ViT-B/16 b128 bf16 [{card}]: {_spread(pair)} (each "
          f"round's two readings summed) against SDPA's backward "
          f"{_spread(bwd_times['library'])}: {ratio:.3f} times it",
          flush=True)
    return kernels


def phase_kernels(card):
    t0 = time.perf_counter()
    logs = _build.build(["flash_relpos_fwd", "flash_relpos_bwd", "flash_fwd",
                         "flash_bwd", "msda", "probes"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if ("Compiling entry" in line or "registers" in line
                    or "spill" in line):
                print(f"  {name}: {line.strip()}")

    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    shape_errs = {}
    cases = [(*shape, dtype, i) for i, shape in enumerate(RELPOS_SHAPES)
             for dtype in tols]
    # the training path's launch: SAM-B's global layer for a batch of 8
    cases.append(("sam_b_train", SAM_TRAIN_BH, 64, 64, 64, torch.bfloat16, 8))
    for name, bh, k_h, k_w, d, dtype, seed in cases:
        atol = tols[dtype]
        args = _relpos_inputs(bh, k_h, k_w, d, dtype, seed)
        o, lse = fa.flash_attention_relpos(*args)
        o_ref, lse_ref = _by_head_chunks(
            fa.flash_attention_relpos_reference, args)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        print(f"kernel check {name} BH={bh} grid={k_h}x{k_w} d={d} "
              f"{str(dtype)[6:]}: max|o-ref|={err_o:.3e} "
              f"max|lse-ref|={err_lse:.3e} (atol {atol:g})", flush=True)
        if not (err_o <= atol and err_lse <= atol):
            raise RuntimeError(f"flash_attention_relpos_fwd disagrees "
                               f"with its plain version at {name} {dtype}")
        if dtype == torch.bfloat16:
            shape_errs[name] = max(err_o, err_lse)
        if name == "sam_b" and dtype == torch.bfloat16:
            # the plain version now rounds p to v's dtype before p.v, as
            # the kernel and the JAX package's XLA twin do; it kept p in
            # f32 before. Both readings, on the same inputs:
            q, k, v, rel_h, rel_w = args
            p = torch.softmax(fa._relpos_scores(q, k, rel_h, rel_w), -1)
            o_f32p = torch.einsum("bnm,bmd->bnd", p, v.float()).to(dtype)
            err_old = (o.float() - o_f32p.float()).abs().max().item()
            print(f"  K4 bf16 at sam_b against its plain version: "
                  f"{err_o:.3e} with p rounded to bf16 before p.v (the "
                  f"plain version now), {err_old:.3e} with p kept in "
                  f"f32 (the plain version before)", flush=True)
            del p, o_f32p, q, k, v, rel_h, rel_w
        del args, o, lse, o_ref, lse_ref

    # the narrow variant (mma.sync, 4-byte copies): inputs whose rows are
    # 4-byte but not 16-byte aligned, and a d that is no multiple of 8
    for name, bh, k_h, k_w, d, offset in (("sam_b_unaligned", 12, 64, 64, 64,
                                           2),
                                          ("d42_8x14", 5, 8, 14, 42, 0)):
        args = _relpos_inputs(bh, k_h, k_w, d, torch.bfloat16, 11)
        args = (*(_unaligned(t, offset) for t in args[:3]), *args[3:])
        assert not fa._vector_loads(*args[:3])
        o, lse = fa.flash_attention_relpos(*args)
        o_ref, lse_ref = fa.flash_attention_relpos_reference(*args)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        print(f"kernel check {name} (mma.sync variant) BH={bh} "
              f"grid={k_h}x{k_w} d={d} bfloat16: max|o-ref|={err_o:.3e} "
              f"max|lse-ref|={err_lse:.3e} (atol 0.02)", flush=True)
        if not (err_o <= 2e-2 and err_lse <= 2e-2):
            raise RuntimeError(f"flash_attention_relpos_fwd's narrow variant "
                               f"disagrees with its plain version at {name}")
        del args, o, lse, o_ref, lse_ref

    # the forward rel-pos kernel lies on two paths: its entry reads the
    # served shape (one image) and carries the training path's beside it
    relpos = _relpos_fwd_times(card, 12, shape_errs["sam_b"])
    relpos["other_shapes"] = [_reading(_relpos_fwd_times(
        card, SAM_TRAIN_BH, shape_errs["sam_b_train"]))]
    return (phase_flash_kernels(card) + [relpos]
            + phase_relpos_bwd_kernels(card))


def _unaligned(t, offset=2):
    """A copy of ``t`` whose storage starts ``offset`` elements into its
    buffer (4 bytes for bf16 at the default), so that its rows are 4-byte
    but not 16-byte aligned: the wrappers send it to the kernels' narrow
    variants, with 4-byte copies."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _spread(rounds):
    return (f"{statistics.median(rounds):.4f} ms [{min(rounds):.4f}, "
            f"{max(rounds):.4f}]")


def _relpos_fwd_times(card, bh, err):
    """K4 at SAM-B's global layer (bf16, N 4096, d 64) with ``bh`` heads in
    one launch: the kernel, its mma.sync variant (the narrow path, fed
    4-byte aligned copies) and the library call timed in turns, 5 rounds
    of 20 launches (medians, with each reading's rounds), then the plain
    version and the bound."""
    k_h = k_w = d = 64
    n = k_h * k_w
    args = _relpos_inputs(bh, k_h, k_w, d, torch.bfloat16, 9)
    q, k, v, rel_h, rel_w = args
    narrow = (*(_unaligned(t) for t in (q, k, v)), rel_h, rel_w)
    bias = _sdpa_bias(rel_h, rel_w, bh, n)
    ql, kl, vl = (t.reshape(bh // 12, 12, n, d) for t in (q, k, v))
    times = _alternating({
        "kernel": lambda: fa.flash_attention_relpos(*args),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=bias),
        "mma_sync": lambda: fa.flash_attention_relpos(*narrow)})
    del bias, narrow
    plain_ms = _cuda_ms(lambda: _by_head_chunks(
        fa.flash_attention_relpos_reference, args), 5)
    ms, library_ms, sync_ms = (statistics.median(times[key]) for key in (
        "kernel", "library", "mma_sync"))
    flops = 4.0 * n * n * d * bh
    nbytes = 4 * bh * n * d * 2 + bh * n * (k_h + k_w + 1) * 4
    bound_ms, bound_by = _bound(flops, nbytes, torch.bfloat16)
    print(f"flash_attention_relpos_fwd SAM-B bf16 BH={bh} [{card}]: kernel "
          f"{_spread(times['kernel'])} ({flops / ms / 1e9:.1f} TFLOP/s, "
          f"{bound_ms / ms:.3f} of the bound), sdpa+bias "
          f"{_spread(times['library'])}, mma.sync variant "
          f"{_spread(times['mma_sync'])} ({flops / sync_ms / 1e9:.1f} "
          f"TFLOP/s), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by}", flush=True)
    return {"name": "flash_attention_relpos_fwd", "route": "cuda",
            "source": "simpleaicv_tpu_torch/ops/csrc/flash_relpos_fwd.cu",
            "replaces": "simpleaicv_tpu/ops/flash_attention.py:247",
            "launches": None, "shape": f"BH={bh} N={n} d={d} bf16",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "ms_rounds": times["kernel"],
            "library_ms_rounds": times["library"],
            "mma_sync_variant_ms": sync_ms}


def _requests():
    """Four requests on two non-square images: points, a box, a drawn
    region and three points."""
    rng = np.random.RandomState(0)
    wide = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    tall = rng.randint(0, 256, (800, 600, 3)).astype(np.uint8)
    region = np.zeros((480, 640), np.uint8)
    region[100:300, 250:420] = 255
    return [("points", wide, [(320.0, 240.0)]),
            ("box", tall, (100.0, 150.0, 450.0, 600.0)),
            ("region", wide, region),
            ("points", tall, [(300.0, 400.0), (200.0, 100.0),
                              (500.0, 700.0)])]


def _serve(pred, kind, image, prompt):
    if kind == "points":
        return pred(image, prompt)
    if kind == "box":
        return pred.predict_box(image, prompt)
    return pred.predict_region(image, prompt)


def _reset_launches():
    for counts in (fa.KERNEL_LAUNCHES, fa.NARROW_LAUNCHES,
                   msda.KERNEL_LAUNCHES, msda.NARROW_LAUNCHES,
                   matmul_probe.KERNEL_LAUNCHES, matmul_probe.NARROW_LAUNCHES,
                   bw_probe.KERNEL_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _wide_kernels_only(path):
    """Fails if a flash, MSDA, P1 or P2 kernel took its narrow variant since
    the counts were last set to 0: a main path's inputs are aligned and of the
    shapes the wide (tiled, stream) kernels serve."""
    narrow = {k: v for counts in (fa.NARROW_LAUNCHES, msda.NARROW_LAUNCHES,
                                  matmul_probe.NARROW_LAUNCHES)
              for k, v in counts.items() if v}
    if narrow:
        raise RuntimeError(f"{path} launched narrow variants: {narrow}")


def _profile_device(run):
    """Runs ``run`` under the profiler; returns (device-busy ms, the device
    rows sorted by time)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
    events.sort(key=lambda e: -e.self_device_time_total)
    return sum(e.self_device_time_total for e in events) / 1e3, events


def _print_rows(events, busy_ms, top):
    for e in events[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count} "
              f"{e.key[:90]}")


def phase_serving(card, rounds=2):
    t0 = time.perf_counter()
    pred = SAMPredictor("sam_b", image_size=1024, device="cuda",
                        dtype=torch.bfloat16, seed=0)
    print(f"sam_b 1024^2 bf16 built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    requests = _requests()

    # the served path: every request through the predictor's entry points
    _reset_launches()
    latencies, served = [], 0
    for r in range(rounds):
        for kind, image, prompt in requests:
            t = time.perf_counter()
            mask = _serve(pred, kind, image, prompt)
            dt = (time.perf_counter() - t) * 1e3
            served += 1
            if r > 0:  # the first round warms up cuBLAS and the allocator
                latencies.append(dt)
            if mask.shape != image.shape[:2] or mask.dtype != np.uint8 or \
                    not np.isin(mask, (0, 1)).all():
                raise RuntimeError(f"{kind} request: bad mask {mask.shape} "
                                   f"{mask.dtype}")
    launches = dict(fa.KERNEL_LAUNCHES)
    print(f"served {served} requests; kernel launches {launches} (4 per "
          f"image encode expected)", flush=True)
    if launches["flash_attention_relpos_fwd"] != 4 * served:
        raise RuntimeError("the served path did not launch the rel-pos "
                           "kernel 4 times per image encode")
    _wide_kernels_only("the served path")
    print(f"SAM-B 1024^2 bf16 request latency [{card}]: median "
          f"{float(np.median(latencies)):.2f} ms, min "
          f"{min(latencies):.2f} ms, max {max(latencies):.2f} ms over "
          f"{len(latencies)} requests", flush=True)

    # one request under the profiler: device time by kernel, and the share
    # of an unprofiled request's latency in which the device was idle
    kind, image, prompt = requests[0]
    busy_ms, events = _profile_device(
        lambda: _serve(pred, kind, image, prompt))
    if busy_ms > 0:
        median = float(np.median(latencies))
        print(f"profiled {kind} request [{card}]: device busy {busy_ms:.2f} "
              f"ms of a {median:.2f} ms median request, idle share "
              f"{1 - busy_ms / median:.3f}", flush=True)
        _print_rows(events, busy_ms, 10)
    else:
        print("profiled request: no device time recorded (not measured)")

    # the same requests on the plain path: einsum attention everywhere
    plain = SAMPredictor("sam_b", image_size=1024, device="cuda",
                         dtype=torch.bfloat16, seed=0,
                         use_flash_attention=False)
    plain.model.load_state_dict(pred.model.state_dict())
    for kind, image, prompt in requests:
        if kind == "points":
            args = {"points_xy": prompt}
        else:
            box = prompt
            if kind == "region":
                x, y, bw, bh = bounding_rect(prompt > 0)
                box = (x, y, x + bw, y + bh)
            args = {"box_xyxy": box}
        a, _ = pred.mask_logits(image, **args)
        b, _ = plain.mask_logits(image, **args)
        a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise RuntimeError(f"{kind} request: non-finite mask logits")
        corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
        same = float(np.mean((a > 0) == (b > 0)))
        print(f"{kind} request vs plain path: logit correlation {corr:.6f}, "
              f"binary agreement {same:.6f}", flush=True)
        if not (corr > 0.999 and same >= 0.99):
            raise RuntimeError(f"{kind} request disagrees with the plain "
                               f"path")
    return launches


SERVE_WARM_UP = 2
SERVE_TIMED = 8
# the JAX server's twelve tasks at their predictors' defaults (full widths):
# each task's predictor, the keywords its builder adds, and the small f32
# input of the card-against-CPU request
SERVE_TASKS = {
    "classification": ("ClassificationPredictor", {}, {"input_size": 64}),
    "detection": ("DetectionPredictor", {}, {"input_size": 256}),
    "semantic_segmentation": ("SemanticSegmentationPredictor", {},
                              {"input_size": 128}),
    "salient_object_detection": ("BinarySegmentationPredictor", {},
                                 {"input_size": 128}),
    "human_matting": ("HumanMattingPredictor", {}, {"input_size": 128}),
    "face_detection": ("FaceDetectionPredictor", {}, {"input_size": 128}),
    "face_parsing": ("ParsingPredictor", {}, {"input_size": 128}),
    "human_parsing": ("ParsingPredictor",
                      {"network": "resnet50_pfan_human_parsing"},
                      {"input_size": 128}),
    "instance_segmentation": ("InstanceSegmentationPredictor", {},
                              {"input_size": 256}),
    "text_detection": ("TextDetectionPredictor", {}, {"input_size": 128}),
    "interactive_segmentation": ("SAMPredictor", {}, {"image_size": 256}),
    "text_recognition": ("TextRecognitionPredictor", {}, {"input_w": 128}),
}
SAM_QUERIES = ("?points=640,360;200,100", "?box=100,150,900,600",
               "?format=png&points=300,500")
# card (f32, TF32 off) against CPU, one request a task at a small input;
# bounds from the readings of this phase on an H100 80GB HBM3 at 700 W:
# label maps and SAM masks 1.000000 of the pixels, probabilities, alphas
# and SOLOv2's network outputs 5.96e-9 to 8.6e-7 apart in L2, every box
# matched
SERVE_PARITY_BOUNDS = {"agree": 0.999, "l2": 1e-5, "matched": 0.99}


def _photo(h, w, seed):
    """A photo-like uint8 RGB image: ramps and noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    ramps = np.stack([xx * 0.2, yy * 0.3, (xx + yy) * 0.1], -1) % 256
    noise = np.random.RandomState(seed).randint(0, 64, (h, w, 3))
    return (ramps * 0.75 + noise).astype(np.uint8)


def _jpeg_body(image):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _http_post(url, body):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "image/jpeg"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _check_response(task, query, ctype, payload, hw):
    """Fails unless the response has the JAX server's keys and shapes."""
    h, w = hw
    if "format=png" in query:
        if ctype != "image/png":
            raise RuntimeError(f"{task}{query}: {ctype}, not a PNG")
        mask = serve_codec.decode_image(payload)
        if mask.shape != (h, w, 3) or not np.isin(mask, (0, 255)).all():
            raise RuntimeError(f"{task}{query}: PNG {mask.shape}")
        return
    out = json.loads(payload)
    keys = {"classification": {"topk"}, "detection": {"detections"},
            "face_detection": {"faces"}, "text_detection": {"polygons"},
            "instance_segmentation": {"instances"},
            "text_recognition": {"text"}}.get(task)
    if keys is None and task == "interactive_segmentation":
        keys = {"mask_shape", "mask_pixels",
                "box" if "box=" in query else "points"}
    elif keys is None and task in ("salient_object_detection",
                                   "human_matting"):
        keys = {"alpha_shape", "alpha_mean"}
    elif keys is None:
        keys = {"mask_shape", "class_histogram"}
    ok = set(out) == keys
    if ok and "topk" in out:
        probs = [e["prob"] for e in out["topk"]]
        ok = len(probs) == 5 and probs == sorted(probs, reverse=True)
    elif ok and task in ("detection", "face_detection"):
        ok = all(len(d["box"]) == 4 and np.isfinite(d["score"])
                 for d in out[next(iter(keys))])
    elif ok and "class_histogram" in out:
        ok = (out["mask_shape"] == [h, w]
              and sum(out["class_histogram"].values()) == h * w)
    elif ok and "alpha_shape" in out:
        ok = out["alpha_shape"] == [h, w] and 0 <= out["alpha_mean"] <= 1
    elif ok and "mask_pixels" in out:
        ok = out["mask_shape"] == [h, w] and 0 <= out["mask_pixels"] <= h * w
    elif ok and "text" in out:
        ok = isinstance(out["text"], str)
    if not ok:
        raise RuntimeError(f"{task}{query}: unexpected response "
                           f"{str(out)[:300]}")


def _parity_outputs(task, pred, image):
    """The predictor's raw answer to ``image`` in a comparable form (every
    detection and instance the decoder keeps)."""
    if task in ("detection", "face_detection", "instance_segmentation"):
        return pred(image, score_threshold=0.0)
    if task == "classification":
        probs = np.zeros(1000)
        for i, p in pred(image, topk=1000):
            probs[i] = p
        return probs
    if task == "interactive_segmentation":
        return pred(image, [(image.shape[1] / 2, image.shape[0] / 2)])
    return pred(image)


def _matched_share(task, want, got, factor):
    """The share of the CPU's detections or instances that the card's
    answer holds: the class, a score within 1e-3 relative, and a box
    within 1 / factor + 1 pixel or a mask agreeing on 99% of its pixels."""
    (wm, wl, ws), (gm, gl, gs) = want, got
    if len(ws) == 0 and len(gs) == 0:
        return 1.0
    free = np.ones(len(gs), bool)
    matched = 0
    for m, c, s in zip(wm, wl, ws):
        for j in np.flatnonzero(free & (gl == c)
                                & (np.abs(gs - s) <= 1e-3 * abs(s))):
            if task == "instance_segmentation":
                near = np.mean(gm[j] == m) >= 0.99
            else:
                near = np.abs(gm[j] - m).max() <= 1 / factor + 1
            if near:
                free[j] = False
                matched += 1
                break
    return matched / max(len(ws), len(gs))


def _network_l2(cpu_pred, card_pred, image, size):
    """The relative L2 distance of two predictors' network outputs on the
    letterboxed image (every output tensor, flattened)."""
    def flat(out):
        if isinstance(out, (tuple, list)):
            return torch.cat([flat(o) for o in out])
        return out.float().flatten().cpu()

    outs = []
    for pred in (cpu_pred, card_pred):
        canvas, _, _ = serve_predictors.letterbox(image, size, pred.device)
        with torch.no_grad():
            outs.append(flat(pred.model(canvas[None])))
    return float((outs[1] - outs[0]).norm() / outs[0].norm())


def _serve_parity(card, task):
    """One request at a small input in f32 on the card (TF32 off) against
    the same predictor, with the same seeded weights, on the CPU."""
    name, extra, small = SERVE_TASKS[task]
    cls = getattr(serve_predictors, name)
    kw = dict(extra, **small, dtype=torch.float32, seed=7)
    image = _photo(48, 400, 5) if task == "text_recognition" else \
        _photo(180, 240, 5)
    # one seeded init on the host: the card's predictor is the CPU one's
    # copy with its model moved (the same weights, one init fewer)
    cpu_pred = cls(device="cpu", **kw)
    card_pred = copy.copy(cpu_pred)
    card_pred.model = copy.deepcopy(cpu_pred.model).to("cuda")
    card_pred.device = torch.device("cuda")
    want = _parity_outputs(task, cpu_pred, image)
    got = _parity_outputs(task, card_pred, image)
    if task == "text_recognition":
        ok, reading = got == want, f"text {got!r} vs {want!r}"
    elif task in ("classification", "salient_object_detection",
                  "human_matting"):
        l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        ok, reading = l2 <= SERVE_PARITY_BOUNDS["l2"], f"L2 {l2:.3e}"
    elif task in ("detection", "face_detection", "instance_segmentation"):
        size = small["input_size"]
        share = _matched_share(task, want, got, size / max(image.shape[:2]))
        n = len(want[-1])
        ok = share >= SERVE_PARITY_BOUNDS["matched"]
        reading = f"{n} on the CPU, {share:.4f} matched"
        if task == "instance_segmentation":
            # the seeded SOLOv2 keeps no instance (its masks stay under the
            # 0.5 threshold): its network outputs are held in L2 as well
            l2 = _network_l2(cpu_pred, card_pred, image, size)
            ok = ok and l2 <= SERVE_PARITY_BOUNDS["l2"]
            reading += f"; network outputs L2 {l2:.3e}"
    elif task == "text_detection":
        (wb, ws), (gb, gs) = want, got
        ok = len(wb) == len(gb) and all(
            a.shape == b.shape and np.abs(a - b).max() <= 1.0
            for a, b in zip(wb, gb))
        reading = f"{len(wb)} polygons on the CPU, {len(gb)} on the card"
    else:
        agree = float(np.mean(got == want))
        ok, reading = (agree >= SERVE_PARITY_BOUNDS["agree"],
                       f"pixel agreement {agree:.6f}")
    print(f"http_serving: {task} card (f32, TF32 off) vs CPU at "
          f"{small} [{card}]: {reading}", flush=True)
    if not ok:
        raise RuntimeError(f"{task}: the card's f32 answer disagrees with "
                           f"the CPU's")
    del card_pred, cpu_pred
    torch.cuda.empty_cache()


def phase_http_serving(card):
    """The port's HTTP server with all twelve tasks at their predictors'
    defaults, on the card: JPEG bodies over real sockets, the host clock's
    latency per task, one profiled request a task through the server's
    ``predict``, K4 launched 4 times a SAM request and no hand kernel on
    any other endpoint, the responses' keys and shapes, and one small f32
    request a task on the card against the CPU. Returns the launches."""
    t0 = time.perf_counter()
    httpd, model_server = http_serve.build_server(list(SERVE_TASKS), {},
                                                  port=0, device="cuda")
    model_server.warm()
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/predict/"
    print(f"http_serving: twelve tasks built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    images = [_photo(720, 1280, 0), _photo(1280, 720, 1)]
    bodies = [(_jpeg_body(img), img.shape[:2]) for img in images]
    strip = _photo(48, 400, 2)
    strip_body = [(_jpeg_body(strip), strip.shape[:2])]
    launches = {}
    try:
        for task in SERVE_TASKS:
            reqs = strip_body if task == "text_recognition" else bodies
            queries = SAM_QUERIES if task == "interactive_segmentation" \
                else ("",)
            _reset_launches()
            latencies = []
            n = SERVE_WARM_UP + SERVE_TIMED
            for i in range(n):
                body, hw = reqs[i % len(reqs)]
                query = queries[i % len(queries)]
                t = time.perf_counter()
                status, ctype, payload = _http_post(url + task + query, body)
                dt = (time.perf_counter() - t) * 1e3
                if status != 200:
                    raise RuntimeError(f"{task}{query}: HTTP {status}")
                _check_response(task, query, ctype, payload, hw)
                if i >= SERVE_WARM_UP:
                    latencies.append(dt)
            if task == "interactive_segmentation":
                counts = dict(fa.KERNEL_LAUNCHES)
                if counts["flash_attention_relpos_fwd"] != 4 * n or any(
                        v for k, v in counts.items()
                        if k != "flash_attention_relpos_fwd"):
                    raise RuntimeError(f"SAM requests: launches {counts}, "
                                       f"4 of K4 a request expected")
                _wide_kernels_only("the SAM endpoint")
                launches["flash_attention_relpos_fwd"] = counts[
                    "flash_attention_relpos_fwd"]
            else:
                _no_hand_kernel(f"http_serving {task}")
            median = float(np.median(latencies))
            body, _ = reqs[0]
            t = time.perf_counter()
            serve_codec.decode_image(body)
            decode_ms = (time.perf_counter() - t) * 1e3
            direct = []
            for _ in range(3):
                t = time.perf_counter()
                model_server.predict(task, body, "image/jpeg", {})
                direct.append((time.perf_counter() - t) * 1e3)
            busy_ms, _ = _profile_device(lambda: model_server.predict(
                task, body, "image/jpeg", {}))
            idle = (f"device busy {busy_ms:.2f} ms, idle share "
                    f"{1 - busy_ms / median:.3f}" if busy_ms > 0
                    else "device busy not measured")
            print(f"http_serving: {task} [{card}]: median {median:.2f} ms, "
                  f"max {max(latencies):.2f} ms over {len(latencies)} "
                  f"requests after {SERVE_WARM_UP}; in this thread, no "
                  f"socket: decode {decode_ms:.2f} ms, the server's predict "
                  f"{float(np.median(direct)):.2f} ms (median of 3); "
                  f"profiled request: {idle}", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    del model_server
    torch.cuda.empty_cache()
    for task in SERVE_TASKS:
        _serve_parity(card, task)
    print(f"http_serving: {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return launches


TRAIN_BATCH = 128
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv")


def _vit_b16(use_flash_attention, seed=0, **kwargs):
    """ViT-B/16 at 224^2 as its ImageNet recipe builds it (global-pool head,
    drop-path 0.1), bf16, weights drawn from a seeded generator. The
    engine's entry points take it to the card."""
    model = BACKBONES.create(
        "vit_base_patch16", image_size=224, num_classes=1000,
        global_pool=True, drop_path_prob=0.1, dtype=torch.bfloat16,
        use_flash_attention=use_flash_attention, **kwargs)
    return init_params(model, torch.Generator().manual_seed(seed))


def _step_loss_and_grads(step, state, batch):
    """One train step through the engine; returns its loss and each
    parameter's gradient as the backward left it, before the update."""
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, name=name: grads.__setitem__(name, p.grad.clone()))
        for name, p in state.model.named_parameters()]
    _, metrics = step(state, batch, seed=0)
    for hook in hooks:
        hook.remove()
    if float(metrics["skipped"]) != 0.0:
        raise RuntimeError("the compared step was skipped")
    # a parameter that the batch does not reach has no gradient: zeros
    return metrics["loss"].item(), [
        grads[n] if n in grads else torch.zeros_like(p)
        for n, p in zip(state.optimizer.names, state.optimizer.params)]


def phase_training(card, warm_up=3, timed=10):
    t0 = time.perf_counter()
    model = _vit_b16(use_flash_attention=True)
    # the vit_base_patch16 ImageNet recipe: AdamW, layer-wise lr decay 0.75
    # over 12 blocks, no decay on the embeddings, 5 warm-up epochs into a
    # cosine to 1e-6. An epoch is cut to 4 steps, so that the warm-up spans
    # 20 steps and the rate is not still near 0 when this run ends.
    opt_cfg = OptimizerConfig(
        name="AdamW", lr=1e-3, weight_decay=0.05, global_weight_decay=False,
        beta1=0.9, beta2=0.999,
        no_weight_decay_layer_name_list=("position_encoding", "cls_token"),
        lr_layer_decay=0.75, lr_layer_decay_block_nums=12,
        block_name="blocks")
    sched = SchedulerConfig("CosineLR", lr=1e-3, epochs=100,
                            warm_up_epochs=5, min_lr=1e-6)
    optimizer, _ = build_optimizer(opt_cfg, sched, 4, model)
    cfg = EngineConfig()
    state = create_train_state(model, optimizer, cfg)
    print(f"vit_base_patch16 224^2 bf16 and its AdamW state built on "
          f"{state.device} in {time.perf_counter() - t0:.1f} s", flush=True)
    if state.device.type != "cuda":
        raise RuntimeError("the engine did not take the model to the card")
    loss_fn = make_loss_fn(LOSSES.create("OneHotLabelCELoss"))
    step = make_train_step(loss_fn, cfg)

    # one synthetic batch, repeated: normalised-image noise and one-hot
    # labels, as the recipe's mixup collater hands them over
    g = torch.Generator(device="cuda").manual_seed(1)
    labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=g,
                           device="cuda")
    batch = {"image": torch.randn(TRAIN_BATCH, 224, 224, 3, generator=g,
                                  device="cuda"),
             "label": torch.nn.functional.one_hot(labels, 1000).float()}

    # the main path: warm-up and timed steps through the engine
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, skipped = [], 0.0
    for i in range(warm_up + timed):
        if i == warm_up:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, batch, seed=0)
        losses.append(metrics["loss"])
        skipped += metrics["skipped"]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    launches = dict(fa.KERNEL_LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [v.item() for v in losses]
    steps = warm_up + timed
    print(f"trained {steps} steps; kernel launches "
          f"{ {k: launches[k] for k in TRAIN_KERNELS} } (12 per step each "
          f"expected); losses {' '.join(f'{v:.4f}' for v in losses)}",
          flush=True)
    if any(launches[k] != 12 * steps for k in TRAIN_KERNELS):
        raise RuntimeError("the train step did not launch each flash "
                           "kernel 12 times")
    _wide_kernels_only("the ViT train step")
    if not all(np.isfinite(losses)) or float(skipped) != 0.0:
        raise RuntimeError(f"non-finite loss or skipped step: {losses}, "
                           f"skipped {float(skipped)}")
    if not losses[-1] < losses[0] - 0.05:
        raise RuntimeError(f"the loss did not fall: {losses}")
    if state.step != steps or optimizer.step_count != steps:
        raise RuntimeError("step counters disagree with the steps taken")
    print(f"ViT-B/16 224^2 bf16 training, batch {TRAIN_BATCH} [{card}]: "
          f"{TRAIN_BATCH / step_ms * 1e3:.1f} images/s, {step_ms:.2f} ms per "
          f"step over {timed} steps, peak memory {peak_gib:.2f} GiB",
          flush=True)

    # one more step under the profiler: device time by kernel, and the share
    # of an unprofiled step in which the device was idle
    busy_ms, events = _profile_device(lambda: step(state, batch, seed=0))
    if busy_ms > 0:
        print(f"profiled train step [{card}]: device busy {busy_ms:.2f} ms "
              f"of a {step_ms:.2f} ms step, idle share "
              f"{1 - busy_ms / step_ms:.3f}", flush=True)
        _print_rows(events, busy_ms, 16)
    else:
        print("profiled train step: no device time recorded (not measured)")

    # the same weights on the einsum attention path: one more step of each
    # model through the engine on the whole batch, from the same step number
    # so that both draw the same drop-path masks. The einsum model recomputes
    # each layer in the backward: its f32 scores are 2.4 GB a layer.
    plain = _vit_b16(use_flash_attention=False, use_gradient_checkpoint=True)
    plain.load_state_dict(model.state_dict())
    plain_opt, _ = build_optimizer(opt_cfg, sched, 4, plain)
    plain_state = create_train_state(plain, plain_opt, cfg)
    plain_state.step = state.step
    torch.cuda.empty_cache()
    loss_a, grads_a = _step_loss_and_grads(step, state, batch)
    loss_b, grads_b = _step_loss_and_grads(step, plain_state, batch)
    flat_a = torch.cat([g.flatten() for g in grads_a]).double()
    flat_b = torch.cat([g.flatten() for g in grads_b]).double()
    rel = ((flat_a - flat_b).norm() / flat_b.norm()).item()
    cos = min(torch.nn.functional.cosine_similarity(
        a.flatten().double(), b.flatten().double(), dim=0).item()
        for a, b in zip(grads_a, grads_b))
    print(f"train step vs einsum path, batch {TRAIN_BATCH}: loss "
          f"{loss_a:.5f} vs {loss_b:.5f}, gradient relative L2 difference "
          f"{rel:.5f} of a norm of {flat_b.norm().item():.5f}, least "
          f"per-parameter cosine {cos:.5f}", flush=True)
    # bf16 keeps 8 bits and the two paths round p, ds and o at other places:
    # the loss within 5e-3, the whole gradient within 1% in L2 (after the
    # steps above the gradient on this very batch is small, which makes the
    # rounding large beside it), and every parameter's gradient pointing the
    # same way
    if not (abs(loss_a - loss_b) <= 5e-3 and np.isfinite(rel)
            and rel <= 1e-2 and cos >= 0.999):
        raise RuntimeError("the flash path disagrees with the einsum path")
    return launches


SAM_KERNELS = ("flash_attention_relpos_fwd", "flash_attention_relpos_dq",
               "flash_attention_relpos_dkv")
# launches per optimizer step of SAM-B (4 global layers) with gradient
# checkpointing: the forward kernel in the forward and again in the
# recompute, each backward kernel once per layer; a no-grad prediction
# between two steps launches the forward kernel once per layer
SAM_STEP_LAUNCHES = {"flash_attention_relpos_fwd": 8,
                     "flash_attention_relpos_dq": 4,
                     "flash_attention_relpos_dkv": 4}
SAM_PREDICT_LAUNCHES = {"flash_attention_relpos_fwd": 4,
                        "flash_attention_relpos_dq": 0,
                        "flash_attention_relpos_dkv": 0}
PROMPT_PROBS = {"point": 0.5, "box": 0.25, "mask": 0.25}
DECODER_POINT_ITERS = 2


def _sam_b(use_flash_attention, seed=0):
    """SAM-B at 1024^2 as the sa_1b/sam_b recipe builds it (gradient
    checkpointing on), bf16 encoder, weights drawn from a seeded generator.
    The engine's entry points take it to the card."""
    model = MODELS.create("sam_b", image_size=1024,
                          use_gradient_checkpoint=True,
                          use_flash_attention=use_flash_attention,
                          dtype=torch.bfloat16)
    return init_params(model, torch.Generator().manual_seed(seed))


def _sam_state(model):
    """The recipe's AdamW (lr 1e-4, weight decay 1e-4 on matrices only) and
    cosine schedule with one warm-up epoch, no EMA. An epoch is cut to 4
    steps so that the warm-up does not outlast this run."""
    opt_cfg = OptimizerConfig(name="AdamW", lr=1e-4, weight_decay=1e-4,
                              global_weight_decay=False,
                              no_weight_decay_layer_name_list=())
    sched = SchedulerConfig("CosineLR", lr=1e-4, epochs=100, warm_up_epochs=1)
    optimizer, _ = build_optimizer(opt_cfg, sched, 4, model)
    cfg = EngineConfig()
    return create_train_state(model, optimizer, cfg), cfg


def _prompt_kinds(count, seed):
    """One prompt kind per batch by ``PROMPT_PROBS``, as the trainer draws
    them, from a seeded generator so that every run takes the same ones."""
    rng = random.Random(seed)
    return [sam_train_cli.draw_prompt_kind(PROMPT_PROBS, rng)
            for _ in range(count)]


def _launch_delta(before):
    return {k: fa.KERNEL_LAUNCHES[k] - before[k] for k in SAM_KERNELS}


def _sam_train_batch(state, step, predict, batch, kind, click_generator,
                     records):
    """The train CLI's loop body for one batch (``train_batch``): one
    optimizer step, or ``DECODER_POINT_ITERS`` of them on a point batch
    with a no-grad best-mask prediction and one new click at an error pixel
    between two steps. Appends (kind, what, ms, loss or None) to ``records``
    and fails on a launch count other than the expected one."""
    torch.cuda.synchronize()
    mark = [time.perf_counter(), dict(fa.KERNEL_LAUNCHES)]

    def observe(what, value):
        torch.cuda.synchronize()
        ms = (time.perf_counter() - mark[0]) * 1e3
        delta = _launch_delta(mark[1])
        want = SAM_STEP_LAUNCHES if what == "step" else SAM_PREDICT_LAUNCHES
        if delta != want:
            raise RuntimeError(f"a {kind} {what} launched {delta}, expected "
                               f"{want}")
        loss = None
        if what == "step":
            loss = value["loss"].item()
            if not np.isfinite(loss) or float(value["skipped"]) != 0.0:
                raise RuntimeError(f"{kind} step: loss {loss}, skipped "
                                   f"{float(value['skipped'])}")
        elif not (value != batch["prompt_point"]).any():
            raise RuntimeError("the refinement added no click")
        records.append((kind, "refine" if what == "refine" else "step", ms,
                        loss))
        torch.cuda.synchronize()
        mark[:] = [time.perf_counter(), dict(fa.KERNEL_LAUNCHES)]

    state, _ = sam_train_cli.train_batch(step, state, predict, batch, kind,
                                         DECODER_POINT_ITERS, click_generator,
                                         observe=observe)
    return state


def phase_sam_training(card, timed_batches=6):
    t0 = time.perf_counter()
    model = _sam_b(use_flash_attention=True)
    state, cfg = _sam_state(model)
    if state.device.type != "cuda":
        raise RuntimeError("the engine did not take the model to the card")
    step = make_train_step(
        sam_task.make_loss_fn(LOSSES.create("SAMMultiLevelLoss")), cfg)
    predict = sam_task.make_predict_best_mask_fn()
    print(f"sam_b 1024^2 (bf16 encoder, gradient checkpointing) and its "
          f"AdamW state built on {state.device} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # two batches from the synthetic dataset through the collater, built on
    # the host before any timing and moved to the card
    t0 = time.perf_counter()
    dataset = FakeSAMSegmentationDataset(2 * SAM_BATCH, image_hw=1024)
    collater = SAMBatchCollater(resize=1024, rng=random.Random(0),
                                np_rng=np.random.RandomState(0))
    batches = [
        {k: torch.from_numpy(v).cuda() for k, v in collater(
            [dataset[i] for i in range(j, j + SAM_BATCH)]).items()}
        for j in (0, SAM_BATCH)]
    print(f"2 batches of {SAM_BATCH} synthetic 1024^2 samples collated and "
          f"moved in {time.perf_counter() - t0:.1f} s", flush=True)
    click_generator = torch.Generator(device="cuda").manual_seed(2)

    # warm-up: one batch of each kind (4 optimizer steps), then the timed
    # window: prompt kinds drawn by the recipe's probabilities from a seed
    # chosen so that all three occur
    kinds = _prompt_kinds(timed_batches, seed=0)
    if set(kinds) != {"point", "box", "mask"}:
        raise RuntimeError(f"the timed window lacks a prompt kind: {kinds}")
    _reset_launches()
    warm = []
    for i, kind in enumerate(("point", "box", "mask")):
        state = _sam_train_batch(state, step, predict, batches[i % 2], kind,
                                 click_generator, warm)
    torch.cuda.reset_peak_memory_stats()
    records = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, kind in enumerate(kinds):
        state = _sam_train_batch(state, step, predict, batches[i % 2], kind,
                                 click_generator, records)
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fa.KERNEL_LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    steps = [r for r in warm + records if r[1] == "step"]
    timed_steps = [r for r in records if r[1] == "step"]
    print(f"trained {len(steps)} optimizer steps ({len(timed_steps)} timed) "
          f"on batches of kinds {['point', 'box', 'mask'] + kinds}; every "
          f"step launched {SAM_STEP_LAUNCHES} and every prediction "
          f"{SAM_PREDICT_LAUNCHES['flash_attention_relpos_fwd']} of the "
          f"forward kernel; in all "
          f"{ {k: launches[k] for k in SAM_KERNELS} }; losses "
          f"{' '.join(f'{r[3]:.4f}' for r in steps)}", flush=True)
    if state.step != len(steps) or \
            state.optimizer.step_count != len(steps) or len(timed_steps) < 6:
        raise RuntimeError("step counters disagree with the steps taken")
    _wide_kernels_only("the SAM train step")
    by_kind = {}
    for kind, what, ms, _ in records:
        by_kind.setdefault(kind if what == "step" else "refinement",
                           []).append(ms)
    print(f"SAM-B 1024^2 training, batch {SAM_BATCH} [{card}]: " + ", ".join(
        f"{kind} {float(np.mean(v)):.2f} ms ({len(v)})"
        for kind, v in by_kind.items()) + " per optimizer step by prompt "
        "kind (a refinement is the no-grad prediction and the new click "
        "between a point batch's two steps)", flush=True)
    step_ms = float(np.mean([r[2] for r in timed_steps]))
    ips = SAM_BATCH * len(timed_steps) / window_ms * 1e3
    print(f"SAM-B 1024^2 training, batch {SAM_BATCH} [{card}]: "
          f"{ips:.2f} images/s "
          f"over the window of {len(timed_steps)} steps and their "
          f"refinements ({window_ms:.1f} ms), {step_ms:.2f} ms per step, "
          f"peak memory {peak_gib:.2f} GiB", flush=True)

    # one more box step under the profiler
    box = sam_train_cli.keep_prompt(batches[0], "box")
    busy_ms, events = _profile_device(lambda: step(state, box, seed=0))
    box_ms = float(np.mean(by_kind["box"]))
    if busy_ms > 0:
        print(f"profiled box step [{card}]: device busy {busy_ms:.2f} ms of "
              f"a {box_ms:.2f} ms step, idle share "
              f"{1 - busy_ms / box_ms:.3f}", flush=True)
        _print_rows(events, busy_ms, 16)
    else:
        print("profiled box step: no device time recorded (not measured)")

    # the same weights on the einsum attention path: one more point step of
    # each model through the engine, same batch and step number. The einsum
    # model's f32 scores are 805 MB per image and global layer; both models
    # recompute each block in the backward.
    plain = _sam_b(use_flash_attention=False)
    plain.load_state_dict(model.state_dict())
    plain_state, _ = _sam_state(plain)
    plain_state.step = state.step
    point = sam_train_cli.keep_prompt(batches[1], "point")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss_a, grads_a = _step_loss_and_grads(step, state, point)
    loss_b, grads_b = _step_loss_and_grads(step, plain_state, point)
    names = state.optimizer.names
    flat_a = torch.cat([g.flatten() for g in grads_a]).double()
    flat_b = torch.cat([g.flatten() for g in grads_b]).double()
    rel = ((flat_a - flat_b).norm() / flat_b.norm()).item()

    def cosine(a, b):
        return torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0).item()

    # a bias on the keys of an attention has a true gradient of 0 (the
    # softmax ignores it), and a parameter the batch does not reach has
    # none: neither has a direction to compare
    compared = [(n, a, b) for n, a, b in zip(names, grads_a, grads_b)
                if not n.endswith("k_proj.bias")
                and (a.any().item() or b.any().item())]
    cos = min(cosine(a, b) for _, a, b in compared)
    tables = [(n, a, b) for n, a, b in compared if "rel_pos_" in n and any(
        f"blocks.{i}." in n for i in (2, 5, 8, 11))]
    if len(tables) != 8:
        raise RuntimeError("the global layers' rel-pos tables are missing "
                           "from the compared gradients")
    table_cos = min(cosine(a, b) for _, a, b in tables)
    ta = torch.cat([a.flatten() for _, a, _ in tables]).double()
    tb = torch.cat([b.flatten() for _, _, b in tables]).double()
    table_rel = ((ta - tb).norm() / tb.norm()).item()
    print(f"SAM train step vs einsum path, batch {SAM_BATCH} point batch "
          f"(peak memory of the two steps "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB): loss "
          f"{loss_a:.5f} vs {loss_b:.5f}, gradient relative L2 difference "
          f"{rel:.5f} of a norm of {flat_b.norm().item():.5f}, least "
          f"per-parameter cosine {cos:.5f} over {len(compared)} of "
          f"{len(names)} parameters; rel_pos_h and rel_pos_w of the four "
          f"global layers (fed by the dq kernel's drh and drw alone): "
          f"relative L2 difference {table_rel:.5f}, least cosine "
          f"{table_cos:.5f}", flush=True)
    # bf16 keeps 8 bits and the two paths round p, ds and o at other places
    # (the einsum path normalises p before rounding it and keeps ds in f32):
    # the loss within 5e-3, the whole gradient and the global layers' tables
    # within 2% in L2, every compared parameter's gradient pointing the same
    # way
    if not (abs(loss_a - loss_b) <= 5e-3 and np.isfinite(rel)
            and rel <= 2e-2 and table_rel <= 2e-2 and cos >= 0.99
            and table_cos >= 0.999):
        raise RuntimeError("the flash path disagrees with the einsum path")
    return launches, ips

# ------------------- multi-scale deformable attention -------------------

# DINO-DETR at the res50_dinodetr_yoloresize1024 recipe's 1024^2 and one
# card's batch of 2: levels C2-C5 and a stride-64 convolution, 8 heads of
# 32 channels, 4 points per level
DINO_IMAGE = 1024
DINO_QUERIES = 900 + 200  # the decoder's queries and denoising slots
MSDA_KERNELS = ("msda_fwd", "msda_bwd")


def _msda_case(b, lq, h, d, shapes, p, lo, hi, seed, where="uniform"):
    """value, locations, weights and grad_out on the card from a seeded CPU
    generator. Locations (``where``): uniform in [lo, hi]; on cell centres
    ("centres", where the pixel coordinate x = loc * w - 0.5 is an integer
    and the sample lies on the border between two bilinear cells); around
    each query's own cell, the queries a grid over every level as in
    DINO-DETR's encoder ("grid", lq = S, up to 2 cells off); or inside
    random boxes ("boxes", as the decoder's queries sample)."""
    g = torch.Generator().manual_seed(seed)
    n_levels = len(shapes)
    s = sum(hh * ww for hh, ww in shapes)
    value = torch.randn(b, s, h, d, generator=g)
    loc = lo + (hi - lo) * torch.rand(b, lq, h, n_levels, p, 2, generator=g)
    wh = torch.tensor([[ww, hh] for hh, ww in shapes],
                      dtype=torch.float32)[None, None, None, :, None]
    if where == "centres":
        loc = (torch.floor(loc * wh).clamp(min=0) + 0.5) / wh
    elif where == "grid":
        centres = torch.cat([dinodetr._grid_centres(hh, ww, "cpu")
                             for hh, ww in shapes])
        loc = (centres[None, :, None, None, None, :]
               + 4 * (loc - 0.5) / wh)
    elif where == "boxes":
        box = torch.rand(b, lq, 1, 1, 1, 4, generator=g)
        loc = box[..., :2] + (loc - 0.5) * (0.05 + 0.3 * box[..., 2:])
    wts = torch.rand(b, lq, h, n_levels, p, generator=g)
    grad_out = torch.randn(b, lq, h * d, generator=g)
    return tuple(t.cuda() for t in (value, loc.contiguous(), wts, grad_out))


def _rel_err(got, want):
    """max |got - want| over want's largest value."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


@contextlib.contextmanager
def _plain_msda():
    """The port's DINO-DETR modules on the plain MSDA and its autograd
    instead of the kernels, for comparisons: swapped in by this script."""
    kernel = dinodetr.ms_deform_attn
    dinodetr.ms_deform_attn = msda.ms_deform_attn_reference
    try:
        yield
    finally:
        dinodetr.ms_deform_attn = kernel


def _by_query_chunks(value, shapes, loc, wts, grad_out=None, chunk=8192):
    """The plain forward, or with ``grad_out`` the plain backward, over
    ``chunk`` queries at a time: at the encoder's launch one corner's
    [B, Lq, H, P, D] f32 gather is 715 MB per level. Queries are
    independent; the value gradient is the sum of the chunks'."""
    lq = loc.shape[1]
    spans = [slice(i, i + chunk) for i in range(0, lq, chunk)]
    if grad_out is None:
        return torch.cat([msda.ms_deform_attn_reference(
            value, shapes, loc[:, c], wts[:, c]) for c in spans], 1)
    grad_value = torch.zeros_like(value)
    grad_loc, grad_wts = [], []
    for c in spans:
        gv, gl, gw = msda.ms_deform_attn_backward_reference(
            value, shapes, loc[:, c], wts[:, c], grad_out[:, c])
        grad_value += gv
        grad_loc.append(gl)
        grad_wts.append(gw)
    return grad_value, torch.cat(grad_loc, 1), torch.cat(grad_wts, 1)


def _grid_sample_msda(value, shapes, loc, wts):
    """The reference's own fallback (ms_deform_attn_core_pytorch): one
    ``F.grid_sample`` per level and the weighted sum, a composition of 5
    library calls that computes MSDA. Timed only; the port never calls it."""
    b, _, h, d = value.shape
    lq, n_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
    values = value.split([hh * ww for hh, ww in shapes], dim=1)
    grids = 2 * loc - 1
    sampled = []
    for lid, (hh, ww) in enumerate(shapes):
        v = values[lid].flatten(2).transpose(1, 2).reshape(b * h, d, hh, ww)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
        sampled.append(torch.nn.functional.grid_sample(
            v, g, mode="bilinear", padding_mode="zeros", align_corners=False))
    w = wts.transpose(1, 2).reshape(b * h, 1, lq, n_levels * p)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * w).sum(-1)
    return out.view(b, h * d, lq).transpose(1, 2)


def _corners(shapes, loc):
    """(inside, rows): how many of the samples' bilinear corners lie inside
    their level (the corners both kernels read, and K7b's atomic adds per
    channel), and how many distinct (batch, value row, head) rows of value
    those corners name: the rows the work needs, each read once. The
    decoder's 1,100 queries reach under half of value's rows."""
    b, lq, h = loc.shape[:3]
    touched = torch.zeros(b, sum(hh * ww for hh, ww in shapes), h,
                          dtype=torch.bool, device=loc.device)
    bi = torch.arange(b, device=loc.device)[:, None, None, None]
    hi = torch.arange(h, device=loc.device)[None, None, :, None]
    n, start = 0, 0
    for lid, (hh, ww) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lid, :, 0] * ww - 0.5).long()
        y0 = torch.floor(loc[:, :, :, lid, :, 1] * hh - 0.5).long()
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = x0 + dx, y0 + dy
                inside = (x >= 0) & (x < ww) & (y >= 0) & (y < hh)
                n += inside.sum().item()
                touched[bi.expand_as(x)[inside], (start + y * ww + x)[inside],
                        hi.expand_as(x)[inside]] = True
        start += hh * ww
    return n, touched.sum().item()


def _msda_times(card, name, lq, seed, boxes):
    """K7 and K7b at one DINO-DETR launch: errors against the plain version
    (over chunks of queries) of K7, its narrow variant (fed a value 4 bytes
    off 16-byte alignment) and K7b; K7 timed in 5 alternating rounds beside
    its narrow variant and the grid_sample composition; K7b beside the
    plain version, its narrow variant and the composition's autograd
    backward; and the bounds."""
    shapes = DINO_LEVELS
    value, loc, wts, grad_out = launch_inputs(lq, seed, boxes)
    b, s, h, d = value.shape
    moved = _unaligned(value, 1)
    if ((msda._msda_fwd_variant(value, shapes, loc),
         msda._msda_fwd_variant(moved, shapes, loc),
         msda._msda_bwd_variant(value, shapes, loc),
         msda._msda_bwd_variant(moved, shapes, loc))
            != ("tiled", "narrow", "tiled", "narrow")):
        raise RuntimeError("the timed inputs miss the kernels' variants")
    narrow_before = msda.NARROW_LAUNCHES["msda_fwd"]
    out = msda._msda_fwd_cuda(value, shapes, loc, wts)
    out_again = msda._msda_fwd_cuda(value, shapes, loc, wts)
    out_narrow = msda._msda_fwd_cuda(moved, shapes, loc, wts)
    if msda.NARROW_LAUNCHES["msda_fwd"] != narrow_before + 1:
        raise RuntimeError("K7's narrow launches were not counted")
    grads = msda._msda_bwd_cuda(value, shapes, loc, wts, grad_out)
    want = _by_query_chunks(value, shapes, loc, wts)
    want_grads = _by_query_chunks(value, shapes, loc, wts, grad_out)
    lib = _grid_sample_msda(value, shapes, loc, wts)
    torch.cuda.synchronize()
    if not torch.equal(out, out_again):
        raise RuntimeError(f"two K7 launches differ at the {name} launch")
    err_fwd = _rel_err(out, want)
    err_narrow = _rel_err(out_narrow, want)
    err_bwd = max(_rel_err(a, w) for a, w in zip(grads, want_grads))
    err_lib = _rel_err(lib, want)
    abs_fwd = (out - want).abs().max().item()
    abs_bwd = max((a - w).abs().max().item()
                  for a, w in zip(grads, want_grads))
    del out, out_again, out_narrow, grads, want, want_grads, lib
    print(f"kernel check msda {name} B={DINO_BATCH} Lq={lq}: max|out-ref| "
          f"{abs_fwd:.3e} ({err_fwd:.3e} of its largest value, the same "
          f"bits from two launches; {err_narrow:.3e} through the narrow "
          f"variant), max|grad-ref| {abs_bwd:.3e} (at most {err_bwd:.3e} of "
          f"a gradient's largest value; tolerance 1e-5 of it); the "
          f"grid_sample composition {err_lib:.3e}", flush=True)
    if not (err_fwd <= 1e-5 and err_narrow <= 1e-5 and err_bwd <= 1e-5):
        raise RuntimeError(f"the MSDA kernels disagree with their plain "
                           f"versions at the {name} launch")

    samples = loc[..., 0].numel()
    inside, touched = _corners(shapes, loc)
    fwd_times = _alternating({
        "kernel": lambda: msda._msda_fwd_cuda(value, shapes, loc, wts),
        "narrow": lambda: msda._msda_fwd_cuda(moved, shapes, loc, wts),
        "library": lambda: _grid_sample_msda(value, shapes, loc, wts)},
        rounds=5, iters=5 if lq > 10000 else 20)
    ms_fwd = statistics.median(fwd_times["kernel"])
    print(f"msda_fwd DINO-DETR {name} launch, 5 alternating rounds [{card}]: "
          f"kernel {_spread(fwd_times['kernel'])}, narrow variant "
          f"{_spread(fwd_times['narrow'])}, grid_sample composition "
          f"{_spread(fwd_times['library'])}", flush=True)
    ms_bwd = _cuda_ms(lambda: msda._msda_bwd_cuda(value, shapes, loc, wts,
                                                  grad_out), 20)
    # the backward's narrow variant (the previous design) on the same inputs
    ms_narrow = _cuda_ms(lambda: msda._msda_bwd_cuda(moved, shapes, loc, wts,
                                                     grad_out), 20)
    del moved
    plain_fwd = _cuda_ms(lambda: _by_query_chunks(value, shapes, loc, wts),
                         3)
    plain_bwd = _cuda_ms(lambda: _by_query_chunks(value, shapes, loc, wts,
                                                  grad_out), 3)
    lib_fwd = statistics.median(fwd_times["library"])
    leaves = [t.detach().requires_grad_() for t in (value, loc, wts)]
    lib_out = _grid_sample_msda(leaves[0], shapes, *leaves[1:])
    lib_bwd = _cuda_ms(lambda: torch.autograd.grad(
        lib_out, leaves, grad_out, retain_graph=True), 3)
    del lib_out, leaves
    f32 = 4
    # bytes: value's rows that inside corners name, read once; grad_value
    # written once in full (its rows no corner reaches are zeros that the
    # function still returns); out, grad_out, locations and weights once
    needed = touched * d * f32                     # value read
    tensor = b * s * h * d * f32                   # grad_value written
    rows = b * lq * h * d * f32                    # out, grad_out
    locs, weights = samples * 2 * f32, samples * f32
    # operations: each inside corner's product and sum per channel, and per
    # sample and channel the bilinear blend's three and the weighting's two;
    # the backward adds three per corner (the atomic add's product and sum)
    # and nine per sample and channel (the recomputed sample and the three
    # reductions)
    cases = [("msda_fwd", "simpleaicv_tpu/ops/msda_pallas.py:32", ms_fwd,
              plain_fwd, lib_fwd, abs_fwd,
              (inside * 2 + samples * 5) * d, needed + locs + weights + rows),
             ("msda_bwd", "simpleaicv_tpu/ops/msda.py:66", ms_bwd, plain_bwd,
              lib_bwd, abs_bwd, (inside * 5 + samples * 14) * d,
              needed + tensor + 2 * (locs + weights) + rows)]
    kernels = []
    for kname, replaces, ms, plain_ms, lib_ms, err, flops, nbytes in cases:
        bound_ms, bound_by = _bound(flops, nbytes, torch.float32)
        print(f"{kname} DINO-DETR {name} launch B={DINO_BATCH} Lq={lq} "
              f"[{card}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (chunks "
              f"of 8192 queries), grid_sample composition {lib_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} "
              f"({nbytes / ms / 1e9:.3f} TB/s, {flops / ms / 1e9:.1f} "
              f"GFLOP/ms); {samples} samples, {inside} inside corners "
              f"({inside * d} atomic adds in the backward) naming {touched} "
              f"of value's {b * s * h} rows; {nbytes} bytes, {flops} "
              f"operations", flush=True)
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "simpleaicv_tpu_torch/ops/csrc/msda.cu",
            "replaces": replaces, "launches": None,
            "shape": f"B={b} Lq={lq} S={s} H={h} D={d} L={len(shapes)} "
                     f"P={DINO_POINTS} f32 ({name})",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
        if kname == "msda_bwd":
            kernels[-1]["narrow_variant_ms"] = ms_narrow
            print(f"  the narrow variant (a warp per (b, q, h), the "
                  f"previous design) on the same inputs: {ms_narrow:.4f} ms, "
                  f"{ms_narrow / ms:.3f} times the tiled kernel's",
                  flush=True)
        else:
            narrow_ms = statistics.median(fwd_times["narrow"])
            kernels[-1].update({
                "ms_rounds": fwd_times["kernel"],
                "library_ms_rounds": fwd_times["library"],
                "narrow_variant_ms": narrow_ms})
            print(f"  the narrow variant (a warp per (b, q, h), the "
                  f"previous design) on the same inputs: {narrow_ms:.4f} ms, "
                  f"{narrow_ms / ms:.3f} times the tiled kernel's",
                  flush=True)
    return kernels


def _module_check():
    """MSDeformAttn (256 wide, 8 heads, 5 levels) with 2-D (encoder) and
    4-D (decoder) reference points on the kernels against the same module on
    the plain version: output and every gradient."""
    shapes = ((32, 32), (16, 16), (8, 8), (4, 4), (2, 2))
    s = sum(hh * ww for hh, ww in shapes)
    g = torch.Generator().manual_seed(61)
    module = init_params(dinodetr.MSDeformAttn(256, 5, 8, 4), g)
    with torch.no_grad():   # offsets and weights that depend on the query
        for lin in (module.sampling_offsets, module.attention_weights):
            lin.weight.copy_(0.05 * torch.randn(lin.weight.shape,
                                                generator=g))
    module.cuda()
    value = torch.randn(2, s, 256, generator=g).cuda()
    refs = {"2-D": torch.cat([dinodetr._grid_centres(hh, ww, "cpu")
                              for hh, ww in shapes])[None, :, None, :]
            .expand(2, -1, 5, -1),
            "4-D": torch.cat([torch.rand(2, 300, 1, 2, generator=g),
                              0.05 + 0.3 * torch.rand(2, 300, 1, 2,
                                                      generator=g)], -1)
            .expand(-1, -1, 5, -1)}
    worst = 0.0
    for form, ref in refs.items():
        query = torch.randn(2, ref.shape[1], 256, generator=g).cuda()
        grad = torch.randn(2, ref.shape[1], 256, generator=g).cuda()
        results = []
        for plain in (False, True):
            leaves = [t.clone().requires_grad_() for t in (query, value)]
            module.zero_grad()
            with _plain_msda() if plain else contextlib.nullcontext():
                out = module(leaves[0], ref.cuda(), leaves[1], shapes)
            out.backward(grad)
            results.append([out.detach(), *(t.grad for t in leaves)]
                           + [p.grad.clone() for p in module.parameters()])
        errs = [_rel_err(a, b) for a, b in zip(*results)]
        worst = max(worst, *errs)
        print(f"kernel check msda module, {form} reference points: max "
              f"relative error {max(errs):.3e} over the output, the query, "
              f"value and parameter gradients (tolerance 1e-4)", flush=True)
    if worst > 1e-4:
        raise RuntimeError("MSDeformAttn on the kernels disagrees with the "
                           "plain version")


def _msda_check(name, value, shapes, loc, wts, grad_out, want_variant):
    """K7 and K7b on one case against their plain versions, each launched
    twice through ``want_variant`` (the forward's output and the backward's
    location and weight gradients the same bits both times), with narrow
    launches counted exactly when that variant is the narrow one. Returns
    the relative errors of out, grad_value, grad_loc and grad_weights."""
    variants = (msda._msda_fwd_variant(value, shapes, loc),
                msda._msda_bwd_variant(value, shapes, loc))
    if variants != (want_variant, want_variant):
        raise RuntimeError(f"{name}: the forward and backward take their "
                           f"{variants} kernels, not {want_variant}")
    narrow_before = dict(msda.NARROW_LAUNCHES)
    out = msda._msda_fwd_cuda(value, shapes, loc, wts)
    out_again = msda._msda_fwd_cuda(value, shapes, loc, wts)
    got = msda._msda_bwd_cuda(value, shapes, loc, wts, grad_out)
    again = msda._msda_bwd_cuda(value, shapes, loc, wts, grad_out)
    narrow = {k: msda.NARROW_LAUNCHES[k] - narrow_before[k]
              for k in narrow_before}
    if set(narrow.values()) != {2 if want_variant == "narrow" else 0}:
        raise RuntimeError(f"{name}: narrow launches {narrow}")
    want = (msda.ms_deform_attn_reference(value, shapes, loc, wts),
            *msda.ms_deform_attn_backward_reference(value, shapes, loc, wts,
                                                    grad_out))
    torch.cuda.synchronize()
    if not torch.equal(out, out_again):
        raise RuntimeError(f"{name}: two forward launches differ")
    if not all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
        raise RuntimeError(f"{name}: two launches gave different location "
                           f"or weight gradients")
    return [_rel_err(a, w) for a, w in zip((out, *got), want)]


def phase_msda_kernels(card):
    """K7 and K7b against their plain versions at edge shapes (D 8 to 48; 1
    to 5 levels with a 16x16 tail, levels too large for shared memory;
    locations in [-0.1, 1.1], on cell centres, around each query's own cell
    and inside random boxes; B 1 and 2, query counts that no chunk divides)
    through the tiled kernels, and at shapes they do not serve through
    their narrow variants; through the module with 2-D and 4-D reference
    points; and at DINO-DETR's encoder and decoder launches, timed there
    beside the narrow variants."""
    # (name, B, Lq, H, D, levels, P, location range, where, variant)
    cases = [
        ("d32_one_level", 2, 50, 8, 32, ((16, 16),), 4, 0.0, 1.0, "uniform",
         "tiled"),
        ("d8_two_levels", 2, 50, 8, 8, ((8, 8), (4, 4)), 3, -0.1, 1.1,
         "uniform", "tiled"),
        ("d16_five_levels", 1, 77, 4, 16,
         ((32, 32), (16, 16), (8, 8), (4, 4), (16, 16)), 4, -0.1, 1.1,
         "uniform", "tiled"),
        ("d48_odd_levels", 2, 40, 8, 48, ((12, 10), (5, 7)), 4, -0.1, 1.1,
         "uniform", "tiled"),
        ("d32_centres", 2, 40, 8, 32, ((12, 10), (5, 7), (16, 16)), 4, -0.1,
         1.1, "centres", "tiled"),
        ("d32_dino_levels", 1, 64, 8, 32, DINO_LEVELS, 4, -0.1, 1.1,
         "uniform", "tiled"),
        ("d32_grid", 2, 1360, 8, 32, ((32, 32), (16, 16), (8, 8), (4, 4)), 4,
         0.0, 1.0, "grid", "tiled"),
        ("d32_boxes", 1, 1100, 8, 32, ((64, 64), (32, 32), (16, 16)), 4, 0.0,
         1.0, "boxes", "tiled"),
        ("d32_large_levels", 1, 3001, 2, 32, ((96, 96), (72, 72)), 4, 0.0,
         1.0, "uniform", "tiled"),
        ("d6_narrow", 2, 30, 4, 6, ((8, 8), (4, 4)), 4, -0.1, 1.1, "uniform",
         "narrow"),
        ("p9_narrow", 1, 30, 4, 32, ((8, 8), (4, 4), (2, 2), (1, 1)), 9, 0.0,
         1.0, "uniform", "narrow"),
        ("unaligned_narrow", 1, 30, 4, 32, ((8, 8), (4, 4)), 4, 0.0, 1.0,
         "uniform", "narrow"),
    ]
    failed = []
    for i, (name, b, lq, h, d, shapes, p, lo, hi, where,
            variant) in enumerate(cases):
        value, loc, wts, grad_out = _msda_case(b, lq, h, d, shapes, p, lo, hi,
                                               60 + i, where)
        if name.startswith("unaligned"):
            value = _unaligned(value, 1)   # 4 bytes off 16-byte alignment
        errs = _msda_check(name, value, shapes, loc, wts, grad_out, variant)
        print(f"kernel check msda {name} ({variant}) B={b} Lq={lq} H={h} "
              f"D={d} levels {shapes} P={p}: max error over each tensor's "
              f"largest value out {errs[0]:.3e} grad_value {errs[1]:.3e} "
              f"grad_loc {errs[2]:.3e} grad_weights {errs[3]:.3e} (tolerance "
              f"1e-5); two launches the same output and the same location "
              f"and weight gradients", flush=True)
        if max(errs) > 1e-5:
            failed.append(name)
    if failed:
        raise RuntimeError(f"the MSDA kernels disagree with their plain "
                           f"versions at {failed}")
    _module_check()
    kernels = _msda_times(card, "encoder", sum(hh * ww for hh, ww in
                                               DINO_LEVELS), 70, boxes=False)
    decoder = _msda_times(card, "decoder", DINO_QUERIES, 71, boxes=True)
    dcn_readings, dcn_launches = _dcnv2_leg(card)
    for kernel, other, dcn in zip(kernels, decoder, dcn_readings):
        kernel["other_shapes"] = [_reading(other), dcn]
    return kernels, dcn_launches


# DCNv2 at a detection head's shape: [B, H, W, C] in, 3x3 taps, O out
DCN_SHAPE = (2, 100, 100, 256)
DCN_OUT, DCN_K = 256, 3


def _dcnv2_plain(x, off, mask, kernel):
    """``ops/dcnv2.py::deform_conv2d`` with the plain MSDA sampler (and its
    autograd) in the kernels' place: the comparison's reference."""
    b, _, _, c = x.shape
    ho, wo = off.shape[1], off.shape[2]
    k = kernel.shape[0]
    sampled = msda.ms_deform_attn_reference(
        *dcnv2.sample_layout(x, off, mask, k))
    out = sampled.reshape(b * ho * wo, k * k * c) @ kernel.reshape(
        k * k * c, -1)
    return out.reshape(b, ho, wo, -1)


def _dcnv2_leg(card):
    """DCNv2 forward and backward through K7 and K7b (channels as 8 heads
    of 32, one level, one point a query: 180,000 queries) against the same
    function on the plain sampler, on the card; no narrow launch. Times
    each kernel at this launch beside the plain sampler, the grid_sample
    composition and its bound, and the whole layer (forward and backward)
    beside the plain one. Returns (the K7 and K7b readings, the path's
    launches)."""
    b, h, w, c = DCN_SHAPE
    k, kk = DCN_K, DCN_K * DCN_K
    g = torch.Generator(device="cuda").manual_seed(80)
    x = torch.randn(DCN_SHAPE, device="cuda", generator=g)
    off = torch.randn((b, h, w, 2 * kk), device="cuda", generator=g) * 2.5
    mask = torch.rand((b, h, w, kk), device="cuda", generator=g)
    kernel = torch.randn((k, k, c, DCN_OUT), device="cuda",
                         generator=g) * (k * k * c)**-0.5
    grad = torch.randn((b, h, w, DCN_OUT), device="cuda", generator=g)
    value, shapes, loc, wts = dcnv2.sample_layout(x, off, mask, k)
    if (msda._msda_fwd_variant(value, shapes, loc),
            msda._msda_bwd_variant(value, shapes, loc)) != ("tiled", "tiled"):
        raise RuntimeError("DCNv2's sampling misses the tiled kernels")

    def through(fn):
        inputs = [t.detach().requires_grad_() for t in (x, off, mask, kernel)]
        out = fn(*inputs)
        out.backward(grad)
        return [out.detach()] + [t.grad for t in inputs]

    _reset_launches()
    got = through(dcnv2.deform_conv2d)
    torch.cuda.synchronize()
    launches = {n: msda.KERNEL_LAUNCHES[n] for n in MSDA_KERNELS}
    if launches != {"msda_fwd": 1, "msda_bwd": 1}:
        raise RuntimeError(f"DCNv2 launched {launches}, not one K7 and one "
                           f"K7b")
    _wide_kernels_only("dcnv2")
    want = through(_dcnv2_plain)
    errs = [_rel_err(a, w) for a, w in zip(got, want)]
    print(f"dcnv2 x {list(DCN_SHAPE)}, {k}x{k}, {DCN_OUT} out [{card}]: "
          f"through K7/K7b against the plain sampler, max error over each "
          f"tensor's largest value: out {errs[0]:.3e}, x {errs[1]:.3e}, "
          f"offsets {errs[2]:.3e}, mask {errs[3]:.3e}, kernel {errs[4]:.3e} "
          f"(tolerance 1e-5); launches {launches}, none narrow", flush=True)
    if max(errs) > 1e-5:
        raise RuntimeError("DCNv2 through K7/K7b disagrees with its plain "
                           "version")
    abs_fwd = (got[0] - want[0]).abs().max().item()
    abs_bwd = max((a - w).abs().max().item()
                  for a, w in zip(got[1:], want[1:]))
    del got, want

    layer_ms = _cuda_ms(lambda: through(dcnv2.deform_conv2d), 5)
    plain_layer_ms = _cuda_ms(lambda: through(_dcnv2_plain), 3)
    loc, wts = loc.contiguous(), wts.contiguous()
    gout = torch.randn((b, loc.shape[1], c), device="cuda", generator=g)
    ms_fwd = _cuda_ms(lambda: msda._msda_fwd_cuda(value, shapes, loc, wts),
                      20)
    ms_bwd = _cuda_ms(lambda: msda._msda_bwd_cuda(value, shapes, loc, wts,
                                                  gout), 20)
    plain_fwd = _cuda_ms(lambda: msda.ms_deform_attn_reference(
        value, shapes, loc, wts), 3)
    plain_bwd = _cuda_ms(lambda: msda.ms_deform_attn_backward_reference(
        value, shapes, loc, wts, gout), 3)
    lib_fwd = _cuda_ms(lambda: _grid_sample_msda(value, shapes, loc, wts), 5)
    leaves = [t.detach().requires_grad_() for t in (value, loc, wts)]
    lib_out = _grid_sample_msda(leaves[0], shapes, *leaves[1:])
    lib_bwd = _cuda_ms(lambda: torch.autograd.grad(
        lib_out, leaves, gout, retain_graph=True), 3)
    del lib_out, leaves
    print(f"dcnv2 layer forward and backward [{card}]: {layer_ms:.4f} ms "
          f"through K7/K7b, {plain_layer_ms:.4f} ms on the plain sampler",
          flush=True)
    inside, touched = _corners(shapes, loc)
    samples, d, heads = loc[..., 0].numel(), value.shape[3], value.shape[2]
    f32 = 4
    needed, tensor = touched * d * f32, value.numel() * f32
    rows = b * loc.shape[1] * heads * d * f32
    locs, weights = samples * 2 * f32, samples * f32
    readings = []
    for kname, ms, plain_ms, lib_ms, err, flops, nbytes in (
            ("msda_fwd", ms_fwd, plain_fwd, lib_fwd, abs_fwd,
             (inside * 2 + samples * 5) * d, needed + locs + weights + rows),
            ("msda_bwd", ms_bwd, plain_bwd, lib_bwd, abs_bwd,
             (inside * 5 + samples * 14) * d,
             needed + tensor + 2 * (locs + weights) + rows)):
        bound_ms, bound_by = _bound(flops, nbytes, torch.float32)
        print(f"{kname} DCNv2 launch [{card}]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, grid_sample composition {lib_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by}; {samples} samples, "
              f"{inside} inside corners", flush=True)
        readings.append({
            "shape": f"B={b} Lq={loc.shape[1]} S={h * w} H={heads} D={d} L=1 "
                     f"P=1 f32 (dcnv2 x {list(DCN_SHAPE)}, {k}x{k}, "
                     f"{DCN_OUT} out)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "layer_ms": layer_ms, "plain_layer_ms": plain_layer_ms})
    return readings, launches


# ---------------------------- DINO-DETR training ----------------------------

# launches per train step without checkpointing: one of each kernel in each
# of the 6 encoder and 6 decoder layers
DINO_STEP_LAUNCHES = {"msda_fwd": 12, "msda_bwd": 12}
# the res50_dinodetr_yoloresize1024 recipe's AdamW and MultiStepLR; an epoch
# is cut to 4 steps (the milestone at epoch 33 lies far beyond this run)
DINO_OPT = OptimizerConfig(name="AdamW", lr=1e-4, weight_decay=1e-4,
                           global_weight_decay=False,
                           no_weight_decay_layer_name_list=(),
                           sub_layer_lr={"backbone": 1e-5}, clip_max_norm=0.1)
DINO_SCHED = SchedulerConfig("MultiStepLR", lr=1e-4, epochs=39,
                             warm_up_epochs=0, milestones=(33,), gamma=0.1)


def _dino_model(use_gradient_checkpoint=False, seed=0):
    """resnet50_dinodetr(num_classes=80) at its defaults (hidden 256, 8
    heads, 900 queries, 6 + 6 layers, FFN 2048, dn_number 100), the
    backbone in bf16, weights drawn from a seeded generator."""
    model = MODELS.create("resnet50_dinodetr", num_classes=80,
                          use_gradient_checkpoint=use_gradient_checkpoint,
                          dtype=torch.bfloat16)
    return init_params(model, torch.Generator().manual_seed(seed))


def _dino_state(model):
    optimizer, _ = build_optimizer(DINO_OPT, DINO_SCHED, 4, model)
    cfg = EngineConfig()
    return create_train_state(model, optimizer, cfg), cfg


def _dino_batches(count):
    """``count`` batches of 2 synthetic 1024^2 samples (up to 20 boxes of 80
    classes) through Normalize and the recipe's collater, on the card."""
    dataset = FakeDetectionDataset(count * DINO_BATCH, image_hw=DINO_IMAGE,
                                   num_classes=80, max_boxes=20,
                                   transform=Normalize())
    collater = DETRDetectionCollater(resize=DINO_IMAGE,
                                     resize_type="yolo_style",
                                     max_annots_num=100)
    batches = []
    for j in range(0, count * DINO_BATCH, DINO_BATCH):
        batch = collater([dataset[i] for i in range(j, j + DINO_BATCH)])
        batches.append({k: torch.from_numpy(batch[k]).cuda()
                        for k in ("image", "scaled_annots")})
    return batches


@contextlib.contextmanager
def _matchings(record=None, replay=None):
    """Wraps the loss's host Hungarian matcher. ``record`` (a list) gets
    (matches, host ms, cost, valid) of every call, timed from a synchronised
    card so that the time is the copy to the host and scipy's; ``replay`` (a
    list of matches) is handed back in order instead of matching anew, and
    each call's own match is appended to ``record``."""
    inner = dino_loss.hungarian_match

    def wrapped(cost, valid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(cost, valid)
        if record is not None:
            record.append((out, (time.perf_counter() - t0) * 1e3,
                           cost.detach().clone(), valid))
        return replay.pop(0) if replay is not None else out

    dino_loss.hungarian_match = wrapped
    try:
        yield
    finally:
        dino_loss.hungarian_match = inner


@contextlib.contextmanager
def _topk_tap(scores, own, indices=None):
    """Records each ``Tensor.topk`` call's input in ``scores`` and its own
    selection in ``own``; with ``indices`` (a list, in order) hands those
    back in place of that selection. The step's one top-k is the two-stage
    top-900 of the encoder's proposals, whose order decides which query
    slot takes which anchor."""
    inner = torch.Tensor.topk

    def tapped(self, k, dim=-1, largest=True, sorted=True):
        result = inner(self, k, dim, largest, sorted)
        scores.append(self.detach().clone())
        own.append(result.indices)
        if indices is None:
            return result
        idx = indices.pop(0)
        if idx.shape != result.indices.shape:
            raise RuntimeError("replayed top-k of another shape")
        return torch.return_types.topk((self.gather(dim, idx), idx))

    torch.Tensor.topk = tapped
    try:
        yield
    finally:
        torch.Tensor.topk = inner


def _topk_moves(scores_a, topk_a, scores_b, topk_b):
    """Why the plain run's own top-900 differs from the kernel run's: the
    largest difference d of the two runs' proposal scores, the f32 spacing
    at the largest score, and at each place the two selections fill with
    different proposals, the gap between those proposals' plain scores.
    Each order statistic moves by at most d, so a gap above 2 d would mean
    the replayed selection is not the one these scores make; the scores
    must agree within 1e-4 of their largest value, the loss's bound."""
    sa, sb = scores_a.double(), scores_b.double()
    delta = (sa - sb).abs().max().item()
    top = sb.abs().max().item()
    spacing = float(np.spacing(np.float32(top)))
    moved = topk_a != topk_b
    gaps = (sb.gather(1, topk_a) - sb.gather(1, topk_b)).abs()[moved]
    max_gap = gaps.max().item() if gaps.numel() else 0.0
    print(f"top-900 proposals, kernel vs plain MSDA: scores at most "
          f"{delta:.3e} apart ({delta / top:.3e} of the largest, {top:.5f}, "
          f"whose f32 spacing is {spacing:.3e}: {delta / spacing:.1f} "
          f"spacings); {int(moved.sum())} of {moved.numel()} places filled "
          f"by other proposals, their plain scores' gaps at most "
          f"{max_gap:.3e} ({int((gaps > delta).sum())} above the score "
          f"difference, none may lie above twice it), median "
          f"{gaps.median().item() if gaps.numel() else 0.0:.3e}", flush=True)
    if max_gap > 2 * delta or delta > 1e-4 * top:
        raise RuntimeError("the top-900 moved by more than rounding of the "
                           "proposal scores explains")


def _match_moves(record_a, record_b):
    """How many of the plain run's 7 matchings would have differed from the
    kernel run's, which were handed to it; for each that would, the cost of
    the handed matching over the plain run's optimum, both under the plain
    run's costs. With k matched pairs and costs at most d apart, either
    matching's total moves by at most k d, so the gap may not exceed 2 k d;
    the costs must agree within 1e-4 of their largest value."""
    differing = 0
    for (ma, _, ca, valid), (mb, _, cb, _) in zip(record_a, record_b):
        cols = valid[:, None, :].expand_as(cb)
        delta = (ca - cb).abs()[cols].max().item()
        top = cb.abs()[cols].max().item()

        def total(m):
            hit = m >= 0
            return cb.double().gather(2, m.clamp(min=0)[..., None])[
                ..., 0][hit].sum().item()

        k = int((ma >= 0).sum())
        gap = total(ma) - total(mb)
        if (ma != mb).any():
            differing += 1
            print(f"matching handed to the plain run: its cost {gap:.3e} "
                  f"above the plain optimum, {k} pairs, costs at most "
                  f"{delta:.3e} apart (bound {2 * k * delta:.3e})",
                  flush=True)
        if gap > 2 * k * delta or delta > 1e-4 * top:
            raise RuntimeError("a matching moved by more than rounding of "
                               "the costs explains")
    return differing


def _dino_step(step, state, batch, expected):
    before = dict(msda.KERNEL_LAUNCHES)
    state, metrics = step(state, batch, seed=0)
    delta = {k: msda.KERNEL_LAUNCHES[k] - before[k] for k in MSDA_KERNELS}
    if delta != expected:
        raise RuntimeError(f"a DINO-DETR step launched {delta}, expected "
                           f"{expected}")
    return state, metrics


def phase_dino_training(card, warm_up=3, timed=10):
    t0 = time.perf_counter()
    model = _dino_model()
    state, cfg = _dino_state(model)
    if state.device.type != "cuda":
        raise RuntimeError("the engine did not take the model to the card")
    step = make_train_step(make_detr_loss_fn(
        LOSSES.create("DINODETRLoss", num_classes=80)), cfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"resnet50_dinodetr 1024^2 ({n_params} parameters, bf16 backbone) "
          f"and its AdamW state built on {state.device} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    batches = _dino_batches(2)
    boxes = [int((b["scaled_annots"][..., 4] >= 0).sum(1).max())
             for b in batches]
    print(f"2 batches of {DINO_BATCH} synthetic 1024^2 samples collated and "
          f"moved in {time.perf_counter() - t0:.1f} s (at most {boxes} boxes "
          f"an image)", flush=True)

    # the main path: warm-up and timed steps through the engine, each
    # checked for its 12 + 12 kernel launches
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, skipped = [], []
    for i in range(warm_up + timed):
        if i == warm_up:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = _dino_step(step, state, batches[i % 2],
                                    DINO_STEP_LAUNCHES)
        losses.append(metrics["loss"])
        skipped.append(metrics["skipped"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    launches = dict(msda.KERNEL_LAUNCHES)
    _wide_kernels_only("the DINO-DETR train step")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [v.item() for v in losses]
    steps = warm_up + timed
    print(f"trained {steps} steps; every step launched {DINO_STEP_LAUNCHES}, "
          f"in all {launches}; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    if not all(np.isfinite(losses)) or any(float(v) for v in skipped):
        raise RuntimeError(f"non-finite loss or skipped step: {losses}")
    if state.step != steps or state.optimizer.step_count != steps:
        raise RuntimeError("step counters disagree with the steps taken")
    ips = DINO_BATCH / step_ms * 1e3
    print(f"DINO-DETR R50 1024^2 training, batch {DINO_BATCH} [{card}]: "
          f"{ips:.3f} images/s, {step_ms:.2f} ms per "
          f"step over {timed} steps, peak memory {peak_gib:.2f} GiB",
          flush=True)

    # the host's share: the loss's 7 Hungarian matchings (6 decoder layers
    # and the encoder proposals), each a cost matrix copied to the host
    record = []
    with _matchings(record=record):
        state, _ = _dino_step(step, state, batches[0], DINO_STEP_LAUNCHES)
    match_ms = [entry[1] for entry in record]
    print(f"Hungarian matchings of one step [{card}]: {len(match_ms)} calls, "
          f"{sum(match_ms):.2f} ms on the host in all (copy of the cost "
          f"matrix and scipy, from a synchronised card): "
          f"{' '.join(f'{ms:.2f}' for ms in match_ms)}", flush=True)
    if len(match_ms) != 7:
        raise RuntimeError("the loss did not match 7 times")

    # one more step under the profiler
    busy_ms, events = _profile_device(lambda: _dino_step(
        step, state, batches[1], DINO_STEP_LAUNCHES))
    if busy_ms > 0:
        # device kernels msda_fwd_kernel, msda_bwd_tiled (msda_bwd_narrow)
        kern = {k: sum(e.self_device_time_total for e in events
                       if f"{k}_" in e.key) / 1e3
                for k in MSDA_KERNELS}
        print(f"profiled DINO-DETR step [{card}]: device busy {busy_ms:.2f} "
              f"ms of a {step_ms:.2f} ms step, idle share "
              f"{1 - busy_ms / step_ms:.3f}; msda_fwd {kern['msda_fwd']:.3f} "
              f"ms and msda_bwd {kern['msda_bwd']:.3f} ms for 12 launches "
              f"each, {100 * sum(kern.values()) / busy_ms:.1f}% of device "
              f"time", flush=True)
        _print_rows(events, busy_ms, 20)
    else:
        print("profiled DINO-DETR step: no device time recorded (not "
              "measured)")

    # the same weights on the plain MSDA: one step of each at batch 1 with
    # both models recomputing their layers (the plain version's gathers are
    # 358 MB per corner and level at the encoder), from the same step number
    # (the same denoising noise) and with the kernel model's top-900
    # proposal order and matches handed to the plain model: both are
    # discrete choices among scores and costs that may lie within rounding
    # of each other (one call of this script saw 20 of 900 proposals change
    # place and the loss move by 1%), so only the MSDA differs;
    # ``_topk_moves`` and ``_match_moves`` measure that the two runs' scores
    # and costs do agree to rounding before the comparison. A second
    # kernel model takes the same step with the same choices: K7b's atomic
    # adds and cuDNN's backward come in another order on every run, and the
    # two kernel runs show how far that alone moves the gradients (the noise
    # floor of the comparison).
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    del state, model, step
    torch.cuda.empty_cache()
    models = [_dino_model(use_gradient_checkpoint=True) for _ in range(3)]
    for m in models:
        m.load_state_dict(weights)
    del weights
    states = [_dino_state(m)[0] for m in models]
    step = make_train_step(make_detr_loss_fn(
        LOSSES.create("DINODETRLoss", num_classes=80)), cfg)
    one = {k: v[:1] for k, v in batches[0].items()}
    scores_a, topk, scores_b, own_topk = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    record_a, record_b = [], []
    before = dict(msda.KERNEL_LAUNCHES)
    with _matchings(record=record_a), _topk_tap(scores_a, topk):
        loss_a, grads_a = _step_loss_and_grads(step, states[0], one)
    # a checkpointed layer runs K7 twice, in the forward and the recompute
    delta = {k: msda.KERNEL_LAUNCHES[k] - before[k] for k in MSDA_KERNELS}
    if delta != {"msda_fwd": 24, "msda_bwd": 12}:
        raise RuntimeError(f"the checkpointed kernel step launched {delta}")
    if len(topk) != 1:
        raise RuntimeError(f"a step took {len(topk)} top-k selections, "
                           f"expected 1")
    matches = [entry[0] for entry in record_a]
    with _matchings(replay=list(matches)), _topk_tap([], [], list(topk)):
        loss_c, grads_c = _step_loss_and_grads(step, states[2], one)
    before = dict(msda.KERNEL_LAUNCHES)
    with _plain_msda(), _matchings(record=record_b, replay=list(matches)), \
            _topk_tap(scores_b, own_topk, list(topk)):
        loss_b, grads_b = _step_loss_and_grads(step, states[1], one)
    if dict(msda.KERNEL_LAUNCHES) != before:
        raise RuntimeError("the plain model launched an MSDA kernel")
    _topk_moves(scores_a[0], topk[0], scores_b[0], own_topk[0])
    differing = _match_moves(record_a, record_b)
    moved = int((topk[0] != own_topk[0]).sum())
    names = states[0].optimizer.names

    def cosine(a, b):
        return torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0).item()

    def compare(grads_x, grads_y):
        """(relative L2 difference of the whole gradient, its norm, least
        cosine, the same two over the offset and weight parameters)."""
        # the decoder self-attention's key bias has a true gradient of 0
        # (the softmax ignores it): no direction to compare
        pairs = [(n, a, b) for n, a, b in zip(names, grads_x, grads_y)
                 if not n.endswith("self_attn.k.bias")
                 and (a.any().item() or b.any().item())]
        fed = [(n, a, b) for n, a, b in pairs
               if "sampling_offsets" in n or "attention_weights" in n]
        if len(fed) != 48:
            raise RuntimeError(f"{len(fed)} offset and weight parameters "
                               f"compared, expected 48")
        out = []
        for group in (pairs, fed):
            fa = torch.cat([a.flatten() for _, a, _ in group]).double()
            fb = torch.cat([b.flatten() for _, _, b in group]).double()
            out += [((fa - fb).norm() / fb.norm()).item(), fb.norm().item(),
                    min(cosine(a, b) for _, a, b in group)]
        return out, len(pairs)

    (rel, norm, cos, fed_rel, _, fed_cos), n_compared = compare(grads_a,
                                                                grads_b)
    (floor_rel, _, floor_cos, floor_fed_rel, _, floor_fed_cos), _ = compare(
        grads_a, grads_c)
    print(f"DINO-DETR step vs plain MSDA, batch 1, checkpointed (peak memory "
          f"of the three steps {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; {differing} of 7 matchings of the plain model's own would "
          f"have differed, and {moved} of the {topk[0].numel()} places of "
          f"its own top-k proposals): loss {loss_a:.6f} vs {loss_b:.6f}, "
          f"gradient "
          f"relative L2 difference {rel:.3e} of a norm of {norm:.5f}, least "
          f"per-parameter cosine {cos:.6f} over {n_compared} of "
          f"{len(names)} parameters; the 48 sampling_offsets and "
          f"attention_weights parameters (fed by K7b's location and weight "
          f"gradients alone): relative L2 {fed_rel:.3e}, least cosine "
          f"{fed_cos:.6f}. Two kernel runs of the same step: loss "
          f"{loss_a:.6f} vs {loss_c:.6f}, relative L2 {floor_rel:.3e}, least "
          f"cosine {floor_cos:.6f}; offsets and weights {floor_fed_rel:.3e}, "
          f"{floor_fed_cos:.6f}", flush=True)
    # with the same discrete choices both paths are f32 but for the bf16
    # backbone and differ only in the order of sums, which grows through 12
    # layers and sums over 87,296 queries: the loss within 1e-4 of itself,
    # the whole gradient and the offset and weight gradients within 1% in
    # L2, every compared gradient pointing the same way
    if not (abs(loss_a - loss_b) <= 1e-4 * abs(loss_b) and rel <= 1e-2
            and cos >= 0.99 and fed_rel <= 1e-2 and fed_cos >= 0.999):
        raise RuntimeError("the kernel path disagrees with the plain MSDA")
    del states, models, step, grads_a, grads_b, grads_c
    torch.cuda.empty_cache()
    return launches, ips, _dino_auction_leg(card, batches)


DINO_AUCTION_STEPS = 3


def _auction_gap(matched, hungarian, cost, valid):
    """(total cost of the auction's pairs minus the Hungarian one's, the
    auction's bound n_gt * eps, gts the auction left unmatched) of one
    image: eps is the auction's own, 1e-4 of the span of the valid costs
    and at least 1e-3."""
    n_gt = int(valid.sum())
    c = cost.float()
    eps = max(c[:, valid].abs().max().clamp(min=1.0).item() * 1e-4, 1e-3)
    totals = []
    for m in (matched, hungarian):
        rows = m >= 0
        totals.append(c[rows, m[rows]].double().sum().item())
    return totals[0] - totals[1], n_gt * eps, n_gt - int((matched >= 0).sum())


def _dino_auction_leg(card, batches):
    """3 steps of resnet50_dinodetr 1024^2 with ``matcher="auction"`` (the
    auction on the card, ``ops/matcher.py``) through ``make_train_step``:
    K7 and K7b 12 launches each a step, and every matching of every step
    (6 decoder layers and the encoder proposals) held to scipy's Hungarian
    one on the same costs within the auction's bound of n_gt * eps on the
    total cost (a gt the auction leaves unmatched at its iteration cap is
    counted and printed). Returns the path's launches."""
    model = _dino_model(seed=1)
    state, cfg = _dino_state(model)
    step = make_train_step(make_detr_loss_fn(LOSSES.create(
        "DINODETRLoss", num_classes=80, matcher="auction")), cfg)
    record = []
    inner = dino_loss.auction_match_batch

    def timed(cost, valid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(cost, valid)
        torch.cuda.synchronize()
        record.append((out, (time.perf_counter() - t0) * 1e3,
                       cost.detach().clone(), valid.clone()))
        return out

    _reset_launches()
    dino_loss.auction_match_batch = timed
    try:
        losses = []
        for i in range(DINO_AUCTION_STEPS):
            state, metrics = _dino_step(step, state, batches[i % 2],
                                        DINO_STEP_LAUNCHES)
            losses.append(metrics["loss"].item())
    finally:
        dino_loss.auction_match_batch = inner
    launches = {k: msda.KERNEL_LAUNCHES[k] for k in MSDA_KERNELS}
    _wide_kernels_only("the DINO-DETR auction train step")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss with the auction: {losses}")
    if len(record) != 7 * DINO_AUCTION_STEPS:
        raise RuntimeError(f"{len(record)} auction matchings, expected "
                           f"{7 * DINO_AUCTION_STEPS}")
    worst, unmatched, hung_ms, over = 0.0, 0, [], []
    for matched, _, cost, valid in record:
        t0 = time.perf_counter()
        hungarian = dino_loss.hungarian_match(cost, valid)
        hung_ms.append((time.perf_counter() - t0) * 1e3)
        for i in range(cost.shape[0]):
            if not valid[i].any():
                continue
            gap, bound, left = _auction_gap(matched[i], hungarian[i],
                                            cost[i], valid[i])
            worst = max(worst, gap / bound)
            unmatched += left
            if gap > bound:
                over.append((gap, bound, left))
    auction_ms = [entry[1] for entry in record]
    print(f"DINO-DETR R50 1024^2 with the auction matcher, batch "
          f"{DINO_BATCH}, {DINO_AUCTION_STEPS} steps [{card}]: launches "
          f"{launches}, losses {' '.join(f'{v:.4f}' for v in losses)}; "
          f"{len(record)} matchings, each within the bound n_gt * eps of "
          f"the Hungarian total on the same costs (largest gap "
          f"{worst:.3f} of the bound; {unmatched} gts left unmatched); the "
          f"auction {sum(auction_ms) / DINO_AUCTION_STEPS:.2f} ms a step on "
          f"the card (synchronised), scipy's Hungarian "
          f"{sum(hung_ms) / DINO_AUCTION_STEPS:.2f} ms a step with its copy "
          f"to the host", flush=True)
    if over:
        raise RuntimeError(f"auction matchings outside n_gt * eps of the "
                           f"Hungarian total: {over}")
    return launches


PROBE_KERNELS = ("probe_mm", "probe_mm_stats", "probe_scale")
# the probes' ragged case: 1000 rows, no multiple of the 128-row tile
PROBE_RAGGED = (1000, 64, 256)


def _probe_check(m, k, n):
    """P1 and P2 against their plain versions on the same inputs, each
    through its stream and, fed x 4 bytes off 16-byte alignment, its narrow
    variant, each launched twice for the same bits: (max |y - plain y| of
    P1's stream, max |y, sums - plain| of P2's stream). Raises unless each
    bf16 output lies within one bf16 spacing of the plain version's f32
    product at its magnitude (plus K * 2^-24 * sum |x w|, the f32 sum's
    rounding in another order) and each sum within 1e-5 of the largest
    sum."""
    x, w = matmul_probe.probe_inputs(m, k, n, seed=m)
    want = x.float() @ w.float()  # the plain versions' f32 product
    y_plain, s1_plain, s2_plain = matmul_probe.mm_stats_plain(x, w)
    moved = matmul_probe.offset_copy(x)
    if ((matmul_probe._mm_variant(x, w), matmul_probe._mm_variant(moved, w))
            != ("stream", "narrow")):
        raise RuntimeError(f"the probes' inputs at M={m} K={k} N={n} miss "
                           f"their variants")
    def outputs(t, stats):  # (y,) or (y, s1, s2)
        out = matmul_probe.probe_mm(t, w, stats)
        return out if stats else (out,)

    narrow_before = dict(matmul_probe.NARROW_LAUNCHES)
    runs = {(stats, variant): [outputs(t, stats) for _ in range(2)]
            for stats in (False, True)
            for variant, t in (("stream", x), ("narrow", moved))}
    torch.cuda.synchronize()
    if matmul_probe.NARROW_LAUNCHES != {
            key: v + 2 for key, v in narrow_before.items()}:
        raise RuntimeError("the probes' narrow launches were not counted")
    for (stats, variant), (a, b) in runs.items():
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise RuntimeError(f"two {'P2' if stats else 'P1'} {variant} "
                               f"launches differ at M={m} K={k} N={n}")
    del moved
    # one bf16 spacing at each element's magnitude, plus the f32 sum's own
    # rounding in another order where the terms cancel
    spacing = (torch.exp2(torch.floor(torch.log2(want.abs() + 1e-30)) - 7)
               + k * 2.0**-24 * (x.float().abs() @ w.float().abs()))
    ys = {key: r[0][0] for key, r in runs.items()}
    in_spacing = all(bool(((y.float() - want).abs() <= spacing).all())
                     for y in ys.values())
    sum_rel = {variant: max(
        ((a - b).abs().max() / b.abs().max()).item()
        for a, b in zip(runs[(True, variant)][0][1:], (s1_plain, s2_plain)))
        for variant in ("stream", "narrow")}
    errs = {key: (y.float() - y_plain.float()).abs().max().item()
            for key, y in ys.items()}
    for variant in ("stream", "narrow"):
        _, s1, s2 = runs[(True, variant)][0]
        errs[(True, variant)] = max(errs[(True, variant)],
                                    (s1 - s1_plain).abs().max().item(),
                                    (s2 - s2_plain).abs().max().item())
    print(f"probe check M={m} K={k} N={n}: P1 max|y-plain| "
          f"{errs[(False, 'stream')]:.3e} (stream), "
          f"{errs[(False, 'narrow')]:.3e} (narrow variant); P2 "
          f"max|y,sums-plain| {errs[(True, 'stream')]:.3e} (stream), "
          f"{errs[(True, 'narrow')]:.3e} (narrow variant), sums within "
          f"{sum_rel['stream']:.3e} and {sum_rel['narrow']:.3e} of their "
          f"largest value (1e-5); outputs within one bf16 spacing of the "
          f"f32 product: {in_spacing}; two launches of each variant the "
          f"same bits", flush=True)
    if not (in_spacing and max(sum_rel.values()) <= 1e-5):
        raise RuntimeError(f"P1/P2 disagree with their plain versions at "
                           f"M={m} K={k} N={n}")
    return errs[(False, "stream")], errs[(True, "stream")]


def _probe_entry(name, replaces, reading, err):
    entry = {"name": name, "route": "cuda",
             "source": "simpleaicv_tpu_torch/ops/csrc/probes.cu",
             "replaces": replaces, "launches": None, "max_abs_err": err}
    entry.update({key: reading[key] for key in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    return entry


def phase_probes(card):
    """The roofline probes P1-P3: checked against their plain versions at
    ResNet-50's layer-1 and layer-2 shapes and a ragged M, P1 and P2 timed
    in 5 alternating rounds beside their narrow variants and library calls
    (P2 also beside P1's stream; launches not counted), then the probe runs
    (``matmul_probe.case``, ``bw_probe.case``: the kernel, its plain
    version, the library calls), whose launches are the path's, none of
    them through a narrow variant. Returns (kernel entries, launches)."""
    errs, rounds = {}, {}
    for layer, (m, k, n, _) in matmul_probe.LAYERS.items():
        errs[layer] = _probe_check(m, k, n)
    _probe_check(*PROBE_RAGGED)
    for stats in (False, True):
        for layer in matmul_probe.LAYERS:
            r = rounds[(layer, stats)] = matmul_probe.variants_ms(layer,
                                                                  stats)
            print(f"{'P2' if stats else 'P1'} {layer}, 5 alternating rounds "
                  f"of 50 [{card}]: stream {_spread(r['stream'])}, narrow "
                  f"variant {_spread(r['narrow'])}"
                  + (f", P1's stream {_spread(r['p1_stream'])}, "
                     f"torch.matmul then the two column sums "
                     if stats else ", torch.matmul ")
                  + _spread(r["library"]), flush=True)
    x = torch.randn(bw_probe.SHAPE, device="cuda").to(torch.bfloat16)
    o = bw_probe.probe_scale(x)
    p3_err = (o.float() - bw_probe.scale_plain(x).float()).abs().max().item()
    print(f"probe check P3 {tuple(x.shape)}: max|o-plain|={p3_err:.3e} "
          f"(exact required)", flush=True)
    if p3_err != 0.0 or not torch.equal(o, x):
        raise RuntimeError("P3 disagrees with its plain version")
    del x, o

    # the path: the probe runs, counted
    _reset_launches()
    readings = {(layer, stats): matmul_probe.case(layer, stats)
                for layer in matmul_probe.LAYERS for stats in (False, True)}
    p3 = bw_probe.case()
    launches = {**matmul_probe.KERNEL_LAUNCHES, **bw_probe.KERNEL_LAUNCHES}
    _wide_kernels_only("the probe runs")
    for (layer, stats), r in readings.items():
        stream = statistics.median(rounds[(layer, stats)]["stream"])
        print(f"{'P2' if stats else 'P1'} {layer} {r['shape']} [{card}]: "
              f"kernel {r['ms']:.4f} ms ({r['gbytes_per_s']:.1f} GB/s of "
              f"{r['bytes'] / 1e6:.1f} MB), plain {r['plain_ms']:.4f} ms, "
              f"{r['library']} {r['library_ms']:.4f} ms"
              + (f", 1x1 conv2d channels-last {r['conv_ms']:.4f} ms"
                 if not stats else f", torch.matmul alone "
                 f"{r['matmul_ms']:.4f} ms")
              + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}); the "
              f"stream's median of the rounds {stream:.4f} ms, "
              f"{r['bytes'] / stream / 1e6:.1f} GB/s, "
              f"{r['bound_ms'] / stream:.3f} of the bound", flush=True)
    print(f"P3 {p3['shape']} [{card}]: kernel {p3['ms']:.4f} ms "
          f"({p3['gbytes_per_s']:.1f} GB/s of {p3['bytes'] / 1e6:.1f} MB), "
          f"plain {p3['plain_ms']:.4f} ms, {p3['library']} "
          f"{p3['library_ms']:.4f} ms, bound {p3['bound_ms']:.4f} ms "
          f"({p3['bound_by']}); launches {launches}", flush=True)
    source = "perf/pallas_matmul_probe.py"
    kernels = []
    for name, stats, line in (("probe_mm", False, 24),
                              ("probe_mm_stats", True, 30)):
        entry = _probe_entry(name, f"{source}:{line}",
                             readings[("layer1", stats)],
                             errs["layer1"][int(stats)])
        other = _probe_entry(name, "", readings[("layer2", stats)],
                             errs["layer2"][int(stats)])
        # the time and the library call's from the alternating rounds
        for e, layer in ((entry, "layer1"), (other, "layer2")):
            r = rounds[(layer, stats)]
            e.update({"ms": statistics.median(r["stream"]),
                      "library_ms": statistics.median(r["library"]),
                      "ms_rounds": r["stream"],
                      "library_ms_rounds": r["library"],
                      "narrow_variant_ms": statistics.median(r["narrow"])})
            if stats:
                e["p1_stream_ms"] = statistics.median(r["p1_stream"])
        entry["other_shapes"] = [_reading(other)]
        kernels.append(entry)
    kernels.append(_probe_entry("probe_scale", "perf/pallas_bw_probe.py:21",
                                p3, p3_err))
    return kernels, launches


RESNET_BATCH = 128
# bench.py's step: SGD 0.1 / 0.9 / 1e-4, CosineLR over 100 epochs of 1000
# steps, no skipping of non-finite steps
RESNET_OPT = OptimizerConfig(name="SGD", lr=0.1, momentum=0.9,
                             weight_decay=1e-4)
RESNET_SCHED = SchedulerConfig("CosineLR", lr=0.1, epochs=100)
RESNET_CFG = EngineConfig(skip_non_finite=False)


def _resnet50(dtype=torch.bfloat16, seed=0):
    model = BACKBONES.create("resnet50", num_classes=1000, dtype=dtype)
    return init_params(model, torch.Generator().manual_seed(seed))


def _resnet_state(model, device="cuda"):
    optimizer, _ = build_optimizer(RESNET_OPT, RESNET_SCHED, 1000, model,
                                   device=device)
    return create_train_state(model, optimizer, RESNET_CFG, device=device)


def _row_group(key):
    """The kind of a profiled device row of the ResNet-50 step."""
    k = key.lower()
    if "multi_tensor" in k or "foreach" in k:
        return "optimizer (multi-tensor)"
    if any(s in k for s in ("conv", "cudnn", "xmma", "implicit", "wgrad",
                            "dgrad", "fprop", "gemm", "cutlass", "nchw",
                            "nhwc")):
        return "convolutions and GEMMs"
    if "reduce" in k:
        return "reductions (BatchNorm statistics, gradient sums)"
    if "elementwise" in k or "vectorized" in k:
        return "elementwise passes"
    return "other"


# ResNet-50's BatchNorms after the probes' 1x1 expansions at batch 128,
# NHWC bf16: layer 1's (56^2, 256 channels) and layer 2's (28^2, 512)
BN_SHAPES = ((RESNET_BATCH, 56, 56, 256), (RESNET_BATCH, 28, 28, 512))
BN_EPS = 1e-5


def _bn_yardstick(card, shape):
    """The library yardstick of a hand BatchNorm at one of the probes'
    shapes: training-mode ``F.batch_norm`` beside the port's
    ``ops/fused_bn.py::bn_train`` (bf16, the ResNet's type). For bf16
    PyTorch sends ``F.batch_norm`` to its own channels-last kernels, not to
    cuDNN; for fp16, the same bytes, to cuDNN's. So both are read: cuDNN on
    fp16 values and PyTorch's kernels on bf16, each on a channels-last NCHW
    view of NHWC storage and checked against ``bn_train`` on the same
    values; then the forward and the forward + backward (a fixed dy) of the
    three are timed in 5 alternating rounds of 20 beside their byte
    bounds, and three profiled forward + backward calls of each library
    call name its kernels. A measurement: the port calls neither. The two
    sides differ in semantics (``bn_train`` shifts its statistics by the
    running mean, and the running buffers blend with other momenta), so y,
    dx, the batch mean and the batch variance are compared, not the
    buffers.
    Raises unless y and dx agree within 2e-2 + 2e-2 |value| (a few bf16
    spacings: ``bn_train`` rounds x - mean and the scale to x's type, the
    library computes in f32 and rounds once) and the mean and variance
    within 1e-4 (f32 sums of 1e5 to 4e5 values in other orders, against
    values of unit size)."""
    batch_norm = torch.nn.functional.batch_norm
    c = shape[-1]
    x_numel = int(np.prod(shape))
    n = x_numel // c  # values a channel
    g = torch.Generator(device="cuda").manual_seed(c)
    x32 = torch.randn(shape, generator=g, device="cuda")
    dy32 = torch.randn(shape, generator=g, device="cuda")
    gamma = (1 + 0.1 * torch.randn(c, generator=g, device="cuda")
             ).requires_grad_()
    beta = (0.1 * torch.randn(c, generator=g, device="cuda")).requires_grad_()
    shift = torch.zeros(c, device="cuda")  # a first step's running mean
    running = (torch.zeros(c, device="cuda"), torch.ones(c, device="cuda"))
    inputs = {dtype: (x32.to(dtype), dy32.to(dtype))
              for dtype in (torch.float16, torch.bfloat16)}
    del x32, dy32

    def library(t, buffers=running, momentum=0.1):
        # on the channels-last NCHW view; y back as NHWC
        return batch_norm(t.permute(0, 3, 1, 2), *buffers, gamma, beta, True,
                          momentum, BN_EPS).permute(0, 2, 3, 1)

    def port(t):
        return bn_train(t, gamma, beta, shift, BN_EPS)[0]

    for name, dtype in (("cuDNN", torch.float16),
                        ("PyTorch's kernels", torch.bfloat16)):
        # at momentum 1 the library's running buffers take the batch mean
        # and the unbiased batch variance
        x, dy = inputs[dtype]
        xg = x.detach().requires_grad_()
        mean_l = torch.zeros(c, device="cuda")
        var_l = torch.ones(c, device="cuda")
        y_l = library(xg, (mean_l, var_l), 1.0)
        dx_l = torch.autograd.grad(y_l, xg, dy)[0]
        y_p, mean_p, var_p = bn_train(xg, gamma, beta, shift, BN_EPS)
        dx_p = torch.autograd.grad(y_p, xg, dy)[0]
        agree = {key: ((a.float() - b.float()).abs()
                       - 2e-2 * b.float().abs()).max().item()
                 for key, a, b in (("y", y_l, y_p), ("dx", dx_l, dx_p))}
        mean_err = (mean_l - mean_p).abs().max().item()
        var_err = (var_l * (n - 1) / n - var_p).abs().max().item()
        print(f"BatchNorm {list(shape)} {str(dtype)[6:]}, F.batch_norm "
              f"({name}) against bn_train: max(|diff| - 2e-2 |bn_train|) y "
              f"{agree['y']:.3e}, dx {agree['dx']:.3e} (2e-2), batch mean "
              f"{mean_err:.3e}, batch variance {var_err:.3e} (1e-4)",
              flush=True)
        if max(agree.values()) > 2e-2 or max(mean_err, var_err) > 1e-4:
            raise RuntimeError(f"F.batch_norm ({name}) and bn_train "
                               f"disagree at {shape} {dtype}")
        del xg, y_l, dx_l, y_p, dx_p

    fns = {}
    for key, dtype, fn in (("cudnn", torch.float16, library),
                           ("pytorch", torch.bfloat16, library),
                           ("bn_train", torch.bfloat16, port)):
        x, dy = inputs[dtype]
        xg = x.detach().requires_grad_()

        def fwd(fn=fn, x=x):
            with torch.no_grad():
                return fn(x)

        def fwd_bwd(fn=fn, xg=xg, dy=dy):
            return torch.autograd.grad(fn(xg), (xg, gamma, beta), dy)

        fns[f"{key}_fwd"], fns[f"{key}_fwd_bwd"] = fwd, fwd_bwd
    times = _alternating(fns)
    med = {key: statistics.median(t) for key, t in times.items()}
    # bytes: the forward reads x and writes y, the backward reads x and dy
    # and writes dx (2 bytes each); operations: the statistics and the
    # affine map, about 5 f32 operations an element forward and 7 backward
    bounds = {"fwd": _bound(5.0 * x_numel, 2 * 2 * x_numel, torch.float32),
              "fwd_bwd": _bound(12.0 * x_numel, 5 * 2 * x_numel,
                                torch.float32)}
    for part, label in (("fwd", "forward"), ("fwd_bwd", "forward + backward")):
        bound_ms, bound_by = bounds[part]
        print(f"BatchNorm {list(shape)} training {label}, 5 alternating "
              f"rounds of 20 [{card}]: "
              + ", ".join(f"{name} {_spread(times[f'{key}_{part}'])} "
                          f"({bound_ms / med[f'{key}_{part}']:.3f} of the "
                          f"bound)" for key, name in (
                              ("cudnn", "cuDNN (fp16)"),
                              ("pytorch", "PyTorch's kernels (bf16)"),
                              ("bn_train", "bn_train (bf16)")))
              + f"; bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    for key, name in (("cudnn", "cuDNN (fp16)"),
                      ("pytorch", "PyTorch's kernels (bf16)")):
        # three calls: a profile taken late in a long process may miss the
        # first kernels it should see
        fn = fns[f"{key}_fwd_bwd"]
        busy_ms, events = _profile_device(lambda: [fn() for _ in range(3)])
        print(f"  {name} forward + backward by kernel (three profiled "
              f"calls, {busy_ms:.3f} ms busy):", flush=True)
        _print_rows(events, busy_ms, 4)


def phase_resnet50_training(card, p2_layer1_ms, warm_up=3, timed=10):
    """bench.py's ResNet-50 step on the card, then the BatchNorm yardstick
    at the probes' shapes (``_bn_yardstick``); returns (hand-kernel launches
    of the timed run, images per second)."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.perf_counter()
    model = _resnet50()
    state = _resnet_state(model)
    if state.device.type != "cuda":
        raise RuntimeError("the engine did not take the model to the card")
    step = make_train_step(make_loss_fn(LOSSES.create("CELoss")), RESNET_CFG)
    print(f"resnet50 224^2 bf16 ({sum(p.numel() for p in model.parameters())}"
          f" parameters) and its SGD state built on {state.device} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"image": torch.randn(RESNET_BATCH, 224, 224, 3, generator=g,
                                  device="cuda").to(torch.bfloat16),
             "label": torch.randint(0, 1000, (RESNET_BATCH,), generator=g,
                                    device="cuda")}

    # the main path: warm-up and timed steps through the engine
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(warm_up + timed):
        if i == warm_up:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, batch, seed=0)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    launches = {**matmul_probe.KERNEL_LAUNCHES, **bw_probe.KERNEL_LAUNCHES,
                **fa.KERNEL_LAUNCHES, **msda.KERNEL_LAUNCHES}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [v.item() for v in losses]
    steps = warm_up + timed
    print(f"trained {steps} steps; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; hand-kernel launches "
          f"{ {k: v for k, v in launches.items() if v} } (none expected: "
          f"cuDNN convolutions and plain-PyTorch BatchNorm)", flush=True)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss: {losses}")
    if state.step != steps or state.optimizer.step_count != steps:
        raise RuntimeError("step counters disagree with the steps taken")
    with FlopCounterMode(display=False) as counter:
        step(state, batch, seed=0)
    flops = counter.get_total_flops()
    print(f"ResNet-50 224^2 bf16 training, batch {RESNET_BATCH} [{card}]: "
          f"{RESNET_BATCH / step_ms * 1e3:.1f} images/s, {step_ms:.2f} ms per "
          f"step over {timed} steps, peak memory {peak_gib:.2f} GiB; "
          f"{flops / 1e12:.3f} TFLOP per step (flop counter: convolutions "
          f"and the fc), {flops / step_ms / 1e9:.1f} TFLOP/s, "
          f"{flops / step_ms / 1e9 / 989:.3f} of the bf16 peak", flush=True)

    # one more step under the profiler: device time by kernel and by kind,
    # and the idle share of an unprofiled step
    busy_ms, events = _profile_device(lambda: step(state, batch, seed=0))
    if busy_ms > 0:
        print(f"profiled ResNet-50 step [{card}]: device busy {busy_ms:.2f} "
              f"ms of a {step_ms:.2f} ms step, idle share "
              f"{1 - busy_ms / step_ms:.3f}", flush=True)
        groups = {}
        for e in events:
            kind = _row_group(e.key)
            ms, n = groups.get(kind, (0.0, 0))
            groups[kind] = (ms + e.self_device_time_total / 1e3,
                            n + e.count)
        for kind, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  {kind}: {ms:.3f} ms, {100 * ms / busy_ms:.1f}%, "
                  f"{n} launches")
        _print_rows(events, busy_ms, 20)
        print(f"  beside them: P2 (layer 1's 1x1 convolution as a matmul "
              f"with BatchNorm's column statistics in its epilogue, "
              f"[401408, 64] x [64, 256]) {p2_layer1_ms:.4f} ms", flush=True)
    else:
        print("profiled ResNet-50 step: no device time recorded (not "
              "measured)")
    del state, model, step, batch
    torch.cuda.empty_cache()
    # the library yardstick of a hand BatchNorm, at the probes' shapes
    for shape in BN_SHAPES:
        _bn_yardstick(card, shape)
    torch.cuda.empty_cache()
    _resnet_f32_vs_cpu()
    return launches, RESNET_BATCH / step_ms * 1e3


def _update_and_loss(device, model, batch):
    """One engine step of ``model`` on ``device``: (loss, each parameter's
    update as f64 on the CPU)."""
    state = _resnet_state(model, device)
    step = make_train_step(make_loss_fn(LOSSES.create("CELoss")), RESNET_CFG)
    before = [p.detach().clone() for p in state.optimizer.params]
    batch = {k: v.to(device) for k, v in batch.items()}
    state, metrics = step(state, batch, seed=0)
    return metrics["loss"].item(), [
        (p.detach() - b).double().cpu()
        for p, b in zip(state.optimizer.params, before)]


def _resnet_f32_vs_cpu(batch_size=8):
    """One f32 engine step at batch 8 on the card (TF32 off) against the
    same step on the CPU, from the same weights and batch."""
    t0 = time.perf_counter()
    cpu_model = _resnet50(torch.float32, seed=1)
    card_model = _resnet50(torch.float32, seed=1)
    card_model.load_state_dict(cpu_model.state_dict())
    g = torch.Generator().manual_seed(2)
    batch = {"image": torch.randn(batch_size, 224, 224, 3, generator=g),
             "label": torch.randint(0, 1000, (batch_size,), generator=g)}
    loss_c, upd_c = _update_and_loss("cuda", card_model, batch)
    # the CPU side on PyTorch's native convolutions: oneDNN's f32
    # convolution backward parts from an f64 reference by up to 8% of a
    # ResNet weight gradient's largest value at small spatial sizes
    with torch.backends.mkldnn.flags(enabled=False):
        loss_h, upd_h = _update_and_loss("cpu", cpu_model, batch)
    flat_c, flat_h = torch.cat([u.flatten() for u in upd_c]), torch.cat(
        [u.flatten() for u in upd_h])
    rel = ((flat_c - flat_h).norm() / flat_h.norm()).item()
    cos = min(torch.nn.functional.cosine_similarity(
        a.flatten(), b.flatten(), dim=0).item() for a, b in zip(upd_c, upd_h))
    print(f"ResNet-50 f32 step, batch {batch_size}, card (TF32 off) vs CPU "
          f"({time.perf_counter() - t0:.1f} s): loss {loss_c:.6f} vs "
          f"{loss_h:.6f}, update relative L2 difference {rel:.3e} of a norm "
          f"of {flat_h.norm().item():.5f}, least per-parameter cosine "
          f"{cos:.6f}", flush=True)
    # the two sum in other orders, and a ReLU whose input lies within f32
    # rounding of 0 passes its gradient on one side only; train-mode
    # BatchNorm at batch 8 spreads each such switch over its channel, and 53
    # layers add them up. Bounds against scale: the loss within 1e-4 of
    # itself, the update within 5% in L2 (2.4% measured on an H100 80GB
    # HBM3 at 700 W) and every parameter's update at a cosine above 0.999
    if not (abs(loss_c - loss_h) <= 1e-4 * abs(loss_h) and rel <= 5e-2
            and cos >= 0.999):
        raise RuntimeError("the f32 step on the card disagrees with the CPU")


# The scratch experiment's configs. Like the repository's own configs they
# import the JAX package's names (``{pkg}`` is filled with
# "simpleaicv_tpu"); the port's ``load_config`` resolves them to
# ``simpleaicv_tpu_torch``, so this script imports nothing of the JAX
# package.
CLI_TRAIN_CONFIG = '''"""ResNet-50 on ImageNet as
experiments/0.classification_training/imagenet/resnet50/train_config.py
states it (resnet50, 1000 classes, 224^2, CELoss, SGD 0.1 / 0.9 / 1e-4,
CosineLR with 5 warm-up epochs, no EMA), cut to: batch 128 (not 256);
synthetic data, FakeClassificationDataset of 1280 256^2 images under the
recipe's train transforms and 256 under its test transforms (no ImageNet
here); {epochs} epochs (not 100)."""

from {pkg}.core.registry import BACKBONES, LOSSES
from {pkg}.data.datasets import FakeClassificationDataset
from {pkg}.data.transforms import (Compose, RandomResizedCrop,
                                   RandomHorizontalFlip, Resize, CenterCrop,
                                   Normalize)
from {pkg}.data.collater import ClassificationCollater


class config:
    network = "resnet50"
    num_classes = 1000
    input_image_size = 224

    model = BACKBONES.create(network, num_classes=num_classes)
    trained_model_path = ""

    train_criterion = LOSSES.create("CELoss")
    test_criterion = LOSSES.create("CELoss")

    train_dataset = FakeClassificationDataset(
        num_samples=1280, image_hw=256, num_classes=num_classes,
        transform=Compose([
            RandomResizedCrop(resize=input_image_size),
            RandomHorizontalFlip(prob=0.5),
            Normalize(),
        ]))
    test_dataset = FakeClassificationDataset(
        num_samples=256, image_hw=256, num_classes=num_classes,
        transform=Compose([
            Resize(resize=256),
            CenterCrop(resize=input_image_size),
            Normalize(),
        ]))
    train_collater = ClassificationCollater()
    test_collater = ClassificationCollater()

    seed = 0
    batch_size = 128
    num_workers = 8
    accumulation_steps = 1

    optimizer = ("SGD", {{"lr": 0.1, "momentum": 0.9,
                         "global_weight_decay": False, "weight_decay": 1e-4,
                         "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 5}})

    epochs = {epochs}
    print_interval = 5

    use_ema_model = False
    ema_model_decay = 0.9999
'''

CLI_TEST_CONFIG = '''import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from train_config import config as _train  # noqa: E402


class config:
    network = _train.network
    input_image_size = _train.input_image_size
    model = _train.model
    trained_model_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "checkpoints", "best")
    test_dataset = _train.test_dataset
    test_collater = _train.test_collater
    seed = _train.seed
    batch_size = _train.batch_size
    num_workers = _train.num_workers
'''

CLI_PHASE_LIMIT_S = 600


def _run_cli(tool, work_dir, deadline):
    """Runs ``python -m simpleaicv_tpu_torch.tools.<tool>`` on ``work_dir``
    from this checkout; returns its log (stderr) and raises on failure."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"simpleaicv_tpu_torch.tools.{tool}",
         "--work-dir", work_dir], cwd=root, env=env, capture_output=True,
        text=True, timeout=max(deadline - time.perf_counter(), 1.0))
    log = proc.stderr
    lines = [ln for ln in log.splitlines()
             if " - param " not in ln and not ln.startswith("  ")]
    print(f"{tool} ({time.perf_counter() - t0:.1f} s, exit "
          f"{proc.returncode}):", flush=True)
    for ln in lines[-14:]:
        print(f"  {ln[:160]}")
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} exited {proc.returncode}:\n{log[-4000:]}"
                           f"\n{proc.stdout[-2000:]}")
    return log


def _logged_rates(log, epoch):
    return [float(m.group(1)) for m in re.finditer(
        rf"epoch {epoch} iter \d+/\d+ .* imgs/s ([0-9.]+)", log)]


def phase_cli(card, resident_ips):
    """The train and test CLIs on a scratch experiment directory: train 2
    epochs, resume to a third, evaluate the best checkpoint."""
    import glob
    import os
    import tempfile
    torch.cuda.empty_cache()
    deadline = time.perf_counter() + CLI_PHASE_LIMIT_S
    print("CLI experiment: the imagenet/resnet50 recipe cut to batch 128, "
          "FakeClassificationDataset 1280 train / 256 test samples of 256^2 "
          "under the recipe's transforms, 2 epochs then 3", flush=True)
    with tempfile.TemporaryDirectory() as work_dir:
        def write(name, text):
            with open(os.path.join(work_dir, name), "w") as f:
                f.write(text)

        write("train_config.py", CLI_TRAIN_CONFIG.format(
            epochs=2, pkg="simpleaicv_tpu"))
        write("test_config.py", CLI_TEST_CONFIG)
        first = _run_cli("train_classification", work_dir, deadline)
        ckpt = os.path.join(work_dir, "checkpoints")
        named = glob.glob(os.path.join(ckpt, "resnet50-metric*"))
        for path in (os.path.join(ckpt, "latest"),
                     os.path.join(ckpt, "best")):
            if not os.path.exists(path):
                raise RuntimeError(f"the train CLI wrote no {path}")
        if not named:
            raise RuntimeError("the train CLI wrote no resnet50-metric* link")
        if "epoch 2 done" not in first or "resumed" in first:
            raise RuntimeError("the first run did not train epochs 1 and 2")

        write("train_config.py", CLI_TRAIN_CONFIG.format(
            epochs=3, pkg="simpleaicv_tpu"))
        second = _run_cli("train_classification", work_dir, deadline)
        if ("resumed from epoch 2" not in second
                or "epoch 3 done" not in second
                or re.search(r"epoch [12] iter", second)):
            raise RuntimeError("the second run did not resume after epoch 2 "
                               "and train epoch 3 alone")
        test = _run_cli("test_classification", work_dir, deadline)
        m = re.search(r"top1: ([0-9.]+)% top5: ([0-9.]+)%", test)
        macs = re.search(r"macs: (\S+), params: (\S+)", test)
        if m is None or macs is None:
            raise RuntimeError("the test CLI logged no accuracy or MACs")
        print(f"test CLI on checkpoints/best [{card}]: top1 {m.group(1)}%, "
              f"top5 {m.group(2)}%, MACs {macs.group(1)}, parameters "
              f"{macs.group(2)}", flush=True)
    rates = {e: _logged_rates(first if e < 3 else second, e)
             for e in (1, 2, 3)}
    print(f"train CLI logged images/s [{card}] (cumulative over each epoch "
          f"at iterations 5 and 10): epoch 1 {rates[1]}, epoch 2 "
          f"{rates[2]}, epoch 3 (resumed) {rates[3]}; the resident-batch "
          f"step {resident_ips:.1f} images/s: the gap is the host loader's "
          f"and the copies' share", flush=True)
    if not all(rates.values()):
        raise RuntimeError("the train CLI logged no rate for an epoch")


SAM_CLI_TRAIN_CONFIG = '''"""SAM-B on SA-1B as
experiments/13.interactive_segmentation_training/sa_1b/sam_b/train_config.py
states it (sam_b at 1024^2 with gradient checkpointing, SAMMultiLevelLoss,
prompt kinds 0.5 / 0.25 / 0.25, 2 decoder point iterations, AdamW 1e-4 /
1e-4, CosineLR with a 1-epoch warm-up, batch 8, SAMSegmentationDataset of
sa_000020/train under SamResize(1024)), cut to: an SA-1B tree written for
the run, 32 train 1024^2 JPEGs with compressed-RLE jsons, and one named
test set of 8 (sa_000021; the recipe has none); 1 epoch (not 100); 8
loader workers (not 16)."""

from {pkg}.core.registry import LOSSES, MODELS
from {pkg}.data.datasets import SAMSegmentationDataset
from {pkg}.data.interactive_segmentation import SAMBatchCollater, SamResize


class config:
    network = "sam_b"
    input_image_size = 1024

    model = MODELS.create(network, image_size=input_image_size,
                          use_gradient_checkpoint=True)
    train_criterion = LOSSES.create("SAMMultiLevelLoss")

    train_dataset = SAMSegmentationDataset(
        {root!r}, set_name_list=["sa_000020"], set_type="train",
        transform=SamResize(input_image_size))
    test_dataset = {{"sa_000021": SAMSegmentationDataset(
        {root!r}, set_name_list=["sa_000021"], set_type="train",
        transform=SamResize(input_image_size))}}
    train_collater = SAMBatchCollater(resize=input_image_size)
    test_collater = SAMBatchCollater(resize=input_image_size,
                                     use_noise_bbox=False)

    prompt_probs = {{"point": 0.5, "box": 0.25, "mask": 0.25}}
    decoder_point_iters = 2

    seed = 0
    batch_size = 8
    num_workers = 8
    accumulation_steps = 1
    optimizer = ("AdamW", {{"lr": 1e-4, "global_weight_decay": False,
                           "weight_decay": 1e-4,
                           "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 1}})
    epochs = 1
    print_interval = 2
    use_ema_model = False
'''

DINO_CLI_TRAIN_CONFIG = '''"""DINO-DETR R50 on COCO as
experiments/3.detection_training/coco/res50_dinodetr_yoloresize1024/
train_config.py states it (resnet50_dinodetr, 80 classes, full depth,
DINODETRLoss, DINODETRDecoder, CocoDetection of train2017 without the
images with no object and of val2017, yolo-style 1024 resize with
multi_scale, the flip and crop, Normalize, DETRDetectionCollater at 1024,
AdamW 1e-4 with the backbone at 1e-5 and clipping at 0.1, MultiStepLR at
33), cut to: batch 2 (not 16, one card); a COCO tree written for the run,
16 train and 8 val JPEGs of about 1024 px with up to 20 boxes; 1 epoch
(not 39); 4 loader workers (not 16)."""

from {pkg}.core.registry import DECODERS, LOSSES, MODELS
from {pkg}.data.datasets import CocoDetection
from {pkg}.data.detection import (DetectionResize, DETRDetectionCollater,
                                  Normalize, RandomCrop,
                                  RandomHorizontalFlip)
from {pkg}.data.transforms import Compose


class config:
    network = "resnet50_dinodetr"
    num_classes = 80
    input_image_size = 1024

    model = MODELS.create(network, num_classes=num_classes)
    train_criterion = LOSSES.create("DINODETRLoss", num_classes=num_classes)
    decoder = DECODERS.create("DINODETRDecoder", num_classes=num_classes)

    train_dataset = CocoDetection(
        {root!r}, set_name="train2017", filter_no_object_image=True,
        transform=Compose([
            DetectionResize(resize=input_image_size,
                            resize_type="yolo_style", multi_scale=True),
            RandomHorizontalFlip(prob=0.5), RandomCrop(prob=0.5),
            Normalize()]))
    test_dataset = CocoDetection(
        {root!r}, set_name="val2017",
        transform=Compose([
            DetectionResize(resize=input_image_size,
                            resize_type="yolo_style"), Normalize()]))
    train_collater = DETRDetectionCollater(resize=input_image_size,
                                           resize_type="yolo_style")
    test_collater = DETRDetectionCollater(resize=input_image_size,
                                          resize_type="yolo_style")

    seed = 0
    batch_size = 2
    num_workers = 4
    accumulation_steps = 1
    optimizer = ("AdamW", {{"lr": 1e-4, "global_weight_decay": False,
                           "weight_decay": 1e-4,
                           "sub_layer_lr": {{"backbone": 1e-5}},
                           "no_weight_decay_layer_name_list": [],
                           "clip_max_norm": 0.1}})
    scheduler = ("MultiStepLR", {{"warm_up_epochs": 0, "gamma": 0.1,
                                 "milestones": [33]}})
    epochs = 1
    print_interval = 2
    use_ema_model = False
'''

# COCO's 80 category ids (1 to 90 with ten gaps)
COCO_CATEGORY_IDS = [i for i in range(1, 91)
                     if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]


def _write_jpeg(path, image):
    from PIL import Image
    Image.fromarray(image).save(path, format="JPEG", quality=90)


def write_coco_set(root, seed=0):
    """The dino_cli phase's COCO tree: annotations/instances_{train2017,
    val2017}.json and images/<set>/*.jpg, 16 train and 8 val images of
    about 1024 px, each 1 to 20 coloured boxes on noise (the class gives
    the colour, as FakeDetectionDataset draws them). The first train
    image gains a crowd annotation and the second a box 0.5 px wide,
    which ``CocoDetection`` drops. Returns the annotations it keeps, by
    set."""
    import os
    rng = np.random.RandomState(seed)
    kept = {}
    for set_name, n in (("train2017", 16), ("val2017", 8)):
        os.makedirs(os.path.join(root, "images", set_name), exist_ok=True)
        images, anns = [], []
        for i in range(n):
            h, w = (1024, 1024) if i % 3 == 0 else (
                int(rng.randint(896, 1025)), int(rng.randint(896, 1025)))
            image = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
            image_id = 100000 * (set_name == "val2017") + 10 * i + 1
            name = f"{image_id:012d}.jpg"
            for _ in range(rng.randint(1, 21)):
                bw, bh = rng.randint(w // 16, w // 3), rng.randint(h // 16,
                                                                  h // 3)
                x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
                cls = rng.randint(80)
                image[y:y + bh, x:x + bw] = 0
                image[y:y + bh, x:x + bw, cls % 3] = 120 + 135 * (cls // 3) // 26
                anns.append({"id": len(anns) + 1, "image_id": image_id,
                             "category_id": COCO_CATEGORY_IDS[cls],
                             "bbox": [float(x), float(y), float(bw),
                                      float(bh)],
                             "area": float(bw * bh), "iscrowd": 0})
            _write_jpeg(os.path.join(root, "images", set_name, name), image)
            images.append({"id": image_id, "file_name": name, "height": h,
                           "width": w})
        kept[set_name] = len(anns)
        if set_name == "train2017":
            anns.append({"id": len(anns) + 1, "image_id": images[0]["id"],
                         "category_id": 1, "bbox": [10.0, 10.0, 50.0, 40.0],
                         "area": 2000.0, "iscrowd": 1})
            anns.append({"id": len(anns) + 1, "image_id": images[1]["id"],
                         "category_id": 1, "bbox": [10.0, 10.0, 0.5, 40.0],
                         "area": 20.0, "iscrowd": 0})
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        with open(os.path.join(root, "annotations",
                               f"instances_{set_name}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": c, "name": f"class{c}"}
                                      for c in COCO_CATEGORY_IDS]}, f)
    return kept


def write_sa1b_set(root, seed=0):
    """The sam_cli phase's SA-1B tree: <root>/sa_000020/train/ 32 and
    <root>/sa_000021/train/ 8 1024^2 JPEGs, each with 2 to 5 objects
    (ellipses and rectangles in bright colours on noise) and a same-stem
    json whose masks are compressed RLE, as real SA-1B writes them.
    Returns the masks written, by set."""
    import os
    from simpleaicv_tpu_torch.data.rle import rle_encode
    rng = np.random.RandomState(seed)
    hw = 1024
    ys, xs = np.mgrid[:hw, :hw]
    kept = {}
    for set_name, n in (("sa_000020", 32), ("sa_000021", 8)):
        d = os.path.join(root, set_name, "train")
        os.makedirs(d, exist_ok=True)
        kept[set_name] = 0
        for i in range(n):
            image = rng.randint(0, 60, (hw, hw, 3)).astype(np.uint8)
            annots = []
            for k in range(rng.randint(2, 6)):
                cx, cy = rng.randint(hw // 8, 7 * hw // 8, 2)
                ax, ay = rng.randint(hw // 16, hw // 4, 2)
                if k % 2:
                    inside = (((xs - cx) / ax) ** 2
                              + ((ys - cy) / ay) ** 2) <= 1.0
                else:
                    inside = (np.abs(xs - cx) <= ax) & (np.abs(ys - cy) <= ay)
                image[inside] = rng.randint(120, 256, 3).astype(np.uint8)
                y0, x0 = np.nonzero(inside.any(1))[0][0], \
                    np.nonzero(inside.any(0))[0][0]
                y1, x1 = np.nonzero(inside.any(1))[0][-1], \
                    np.nonzero(inside.any(0))[0][-1]
                annots.append({"id": k, "segmentation": rle_encode(inside),
                               "area": int(inside.sum()),
                               "bbox": [int(x0), int(y0), int(x1 - x0 + 1),
                                        int(y1 - y0 + 1)]})
            stem = f"sa_{seed * 1000 + i:06d}"
            _write_jpeg(os.path.join(d, stem + ".jpg"), image)
            with open(os.path.join(d, stem + ".json"), "w") as f:
                json.dump({"image": {"height": hw, "width": hw,
                                     "file_name": stem + ".jpg"},
                           "annotations": annots}, f)
            kept[set_name] += len(annots)
    return kept


# a test config over the train config's model: its test set (the first of
# a named set), collater, decoder and classes where it has them
CLI_EVAL_CONFIG = '''import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from train_config import config as _train  # noqa: E402


class config:
    network = _train.network
    input_image_size = _train.input_image_size
    model = _train.model
    trained_model_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "checkpoints", "best")
    test_dataset = _train.test_dataset
    if isinstance(test_dataset, dict):
        test_dataset = next(iter(test_dataset.values()))
    test_collater = _train.test_collater
    decoder = getattr(_train, "decoder", None)
    num_classes = getattr(_train, "num_classes", None)
    seed = _train.seed
    batch_size = _train.batch_size
    num_workers = _train.num_workers
'''


def _loader_rates(work_dir):
    """Images/s of one pass of the train config's host loader alone, and
    of one more pass with each batch copied to the card as the Trainer
    copies it (pinned host memory): the host's share of the train CLI's
    rate, apart from the step."""
    from simpleaicv_tpu_torch.core.config import load_config
    from simpleaicv_tpu_torch.core.trainer import batch_to_device
    from simpleaicv_tpu_torch.data.loader import DataLoader
    cfg = load_config(work_dir)
    loader = DataLoader(cfg.train_dataset, cfg.batch_size,
                        cfg.train_collater, num_workers=cfg.num_workers,
                        seed=cfg.seed)
    rates = []
    for copy in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for batch in loader:
            if copy:
                batch_to_device(batch, torch.device("cuda"))
            n += cfg.batch_size
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    return rates


def _cli_in_process(card, path, train_cli, test_cli, train_config,
                    resident_ips, kernels, write_set=None):
    """Trains ``train_config`` for one epoch through ``train_cli.main`` and
    evaluates its best checkpoint through ``test_cli.main``, in this
    process (the launch counts are this process's), in a scratch directory.
    With ``write_set``, the config reads a dataset that ``write_set(root)``
    writes under the scratch directory first (``{root}`` in the config),
    and the seconds it took are printed. Prints the seconds per run, the
    logged images/s beside the resident step's, peak memory, the eval
    metrics and the launches; returns the launches. Fails when a CLI
    raises, writes no best checkpoint or logs no evaluation, or when a
    kernel of ``kernels`` was not launched or a narrow variant was; with
    no ``kernels``, when any hand kernel was launched."""
    import os
    import tempfile
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        fields = {"pkg": "simpleaicv_tpu"}
        if write_set is not None:
            fields["root"] = os.path.join(work_dir, "data")
            t0 = time.perf_counter()
            written = write_set(fields["root"])
            print(f"{path}: the host wrote the on-disk set in "
                  f"{time.perf_counter() - t0:.1f} s ({written} annotations "
                  f"by set)", flush=True)
        for name, text in (("train_config.py", train_config.format(
                **fields)), ("test_config.py", CLI_EVAL_CONFIG)):
            with open(os.path.join(work_dir, name), "w") as f:
                f.write(text)
        argv = ["--work-dir", work_dir]
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        best = train_cli.main(argv)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        metrics = test_cli.main(argv)
        test_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {k: v for counts in (fa.KERNEL_LAUNCHES,
                                        msda.KERNEL_LAUNCHES)
                    for k, v in counts.items()}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        _wide_kernels_only(f"the {path} path")
        if not kernels:
            _no_hand_kernel(path)
        if not os.path.isfile(os.path.join(work_dir, "checkpoints", "best")):
            raise RuntimeError(f"{train_cli.__name__} wrote no best checkpoint")
        with open(os.path.join(work_dir, "log", "train.log")) as f:
            log = f.read()
        loader_ips, copied_ips = _loader_rates(work_dir)
    evals = [ln.split(" - ", 1)[-1] for ln in log.splitlines()
             if "epoch 1 eval: {" in ln]
    rates = _logged_rates(log, 1)
    print(f"{path}: train CLI {train_s:.1f} s (1 epoch with its evaluation, "
          f"both checkpoints), test CLI {test_s:.1f} s, peak memory "
          f"{peak_gib:.2f} GiB [{card}]", flush=True)
    print(f"{path}: logged images/s {rates} (cumulative over the epoch) "
          f"beside the resident step's {resident_ips:.3f}; the host loader "
          f"alone {loader_ips:.1f}, with the pinned copies to the card "
          f"{copied_ips:.1f} [{card}]", flush=True)
    print(f"{path}: {evals[0] if evals else 'no evaluation logged'}; best "
          f"{best:.6f}; test CLI {metrics}", flush=True)
    print(f"{path}: launches "
          f"{({k: launches[k] for k in kernels}) if kernels else 'none'}",
          flush=True)
    if not evals or not metrics or not rates:
        raise RuntimeError(f"the {path} path logged no evaluation or rate")
    missing = [k for k in kernels if launches[k] < 1]
    if missing:
        raise RuntimeError(f"the {path} path did not launch {missing}")
    return launches


def _checked_sa1b(root):
    """Writes the SA-1B tree and checks that ``SAMSegmentationDataset``
    finds every image with its json."""
    from simpleaicv_tpu_torch.data.datasets import SAMSegmentationDataset
    written = write_sa1b_set(root)
    for set_name, want in (("sa_000020", 32), ("sa_000021", 8)):
        n = len(SAMSegmentationDataset(root, [set_name], "train"))
        if n != want:
            raise RuntimeError(f"SAMSegmentationDataset found {n} of the "
                               f"{want} images of {set_name}")
    return written


def _checked_coco(root):
    """Writes the COCO tree and checks that ``CocoDetection`` keeps every
    annotation but the crowd and the degenerate one."""
    from simpleaicv_tpu_torch.data.datasets import CocoDetection
    written = write_coco_set(root)
    for set_name, want in written.items():
        ds = CocoDetection(root, set_name)
        ds._load()
        kept = sum(len(ds.load_annots(i)) for i in ds.image_ids)
        if kept != want:
            raise RuntimeError(f"CocoDetection kept {kept} annotations of "
                               f"{set_name}, not {want}")
    return written


def phase_sam_cli(card, resident_ips):
    """The SAM train and test CLIs on SAM-B 1024^2 (the sa_1b/sam_b
    recipe's fields) over an SA-1B tree on disk."""
    return _cli_in_process(card, "sam_cli", sam_train_cli, sam_test_cli,
                           SAM_CLI_TRAIN_CONFIG, resident_ips, SAM_KERNELS,
                           write_set=_checked_sa1b)


def phase_dino_cli(card, resident_ips):
    """The DETR-family train CLI (with its per-epoch COCO evaluation) and
    the detection test CLI on DINO-DETR R50 1024^2 (the
    res50_dinodetr_yoloresize1024 recipe's fields, batch 2) over a COCO
    tree on disk."""
    return _cli_in_process(card, "dino_cli", det_train_cli, det_test_cli,
                           DINO_CLI_TRAIN_CONFIG, resident_ips, MSDA_KERNELS,
                           write_set=_checked_coco)


# ---- slice 13: DeepLabV3+ and PFAN ----------------------------------------

# the ade20k/resnet50_deeplabv3plus recipe: 512^2, 150 classes, batch 16,
# SegCELoss(ignore_index=255), AdamW 1e-4 / 1e-3, PolyLR 0.9 over 128 epochs
# after a 1-epoch warm-up, bf16 compute; ADE20K's 20,210 training images
# make 1,263 steps an epoch
SEG_RECIPE_OPT = ("AdamW", {"lr": 1e-4, "global_weight_decay": False,
                            "weight_decay": 1e-3,
                            "no_weight_decay_layer_name_list": []})
SEG_RECIPE_SCHED = ("PolyLR", {"warm_up_epochs": 1, "power": 0.9})
SEG_EPOCHS, SEG_STEPS_PER_EPOCH = 128, 20210 // 16
SEG_BATCH, SEG_IMAGE, SEG_CLASSES, SEG_IGNORE = 16, 512, 150, 255
# the combined/resnet50_pfan recipe at 832^2: BinaryBCELoss + BCEIouloss
# 1:1, AdamW 1e-4 / 1e-3, CosineLR to 1e-6 over 100 epochs after a 1-epoch
# warm-up; batch 96 cut to 8 on one card
PFAN_RECIPE_OPT = SEG_RECIPE_OPT
PFAN_RECIPE_SCHED = ("CosineLR", {"warm_up_epochs": 1, "min_lr": 1e-6})
PFAN_BATCH, PFAN_IMAGE = 8, 832


def _no_hand_kernel(path):
    """The launches of every hand kernel since the counts were last set to
    0; fails if any was launched (a path of this slice runs none)."""
    launched = {k: v for counts in (fa.KERNEL_LAUNCHES, msda.KERNEL_LAUNCHES,
                                    matmul_probe.KERNEL_LAUNCHES,
                                    bw_probe.KERNEL_LAUNCHES)
                for k, v in counts.items() if v}
    if launched:
        raise RuntimeError(f"the {path} path launched hand kernels, none "
                           f"expected: {launched}")
    return launched


def _recipe_state(model, opt, sched, epochs, steps_per_epoch):
    optimizer, _ = build_optimizer(
        optimizer_config_from_reference(opt),
        scheduler_config_from_reference(sched, opt, epochs), steps_per_epoch,
        model, device="cuda")
    return create_train_state(model, optimizer, EngineConfig(), "cuda")


def _timed_steps(step, state, batch, warm_up, timed):
    """(ms a step over ``timed`` steps after ``warm_up``, the losses)."""
    losses = []
    for i in range(warm_up + timed):
        if i == warm_up:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, batch, seed=0)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed
    losses = [v.item() for v in losses]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss: {losses}")
    return ms, losses


def _seg_batch(n=SEG_BATCH, image=SEG_IMAGE, classes=SEG_CLASSES):
    """A batch of ``n`` from the port's synthetic dataset and collater (the
    ADE20K recipe's by default), on the card, with the bottom 32 rows of
    every mask ignored."""
    ds = FakeSegmentationDataset(n, image, classes,
                                 transform=Compose([SegNormalize()]))
    batch = SemanticSegmentationCollater(image, SEG_IGNORE)(
        [ds[i] for i in range(n)])
    batch["mask"][:, -32:] = SEG_IGNORE
    return {k: torch.from_numpy(batch[k]).cuda() for k in ("image", "mask")}


def _norm_calls(model, run):
    """(kind, input shape, dtype) -> calls of the model's BatchNorms in
    ``run``: ``bn_train`` (the backbone's ``FusedBatchNorm``) or ``flax``
    (the head's ``BatchNorm``)."""
    import collections
    calls = collections.Counter()
    hooks = []
    for m in model.modules():
        if isinstance(m, (FusedBatchNorm, BatchNorm)):
            kind = "bn_train" if isinstance(m, FusedBatchNorm) else "flax"
            hooks.append(m.register_forward_hook(
                lambda mod, args, out, kind=kind: calls.update(
                    [(kind, tuple(args[0].shape), args[0].dtype)])))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return calls


def _fwd_bwd(fn, *inputs):
    """A callable that runs ``fn(*inputs)`` forward and backward, with a
    random output gradient; the floating inputs require gradients."""
    inputs = [x.detach().requires_grad_(x.is_floating_point())
              for x in inputs]
    dy = torch.randn_like(fn(*inputs))

    def run():
        for x in inputs:
            x.grad = None
        fn(*inputs).backward(dy)

    return run


def _fwd_bwd_ms(fn, *inputs, iters=10):
    """Device ms of ``fn(*inputs)`` forward and backward, by CUDA
    events."""
    return _cuda_ms(_fwd_bwd(fn, *inputs), iters)


def _norm_replay_ms(calls):
    """Device ms of one step's BatchNorm calls by kind, each call's
    forward and backward replayed alone at its shape and dtype."""
    out = {}
    for (kind, shape, dtype), n in sorted(calls.items(), key=str):
        layer = (FusedBatchNorm if kind == "bn_train" else BatchNorm)(
            shape[-1]).cuda()
        layer.reset_parameters(None)
        x = torch.randn(shape, device="cuda").to(dtype)
        ms = _fwd_bwd_ms(lambda t: layer(t, True), x)
        out[kind] = out.get(kind, 0.0) + n * ms
    return out


def _profiled_step(card, label, step, state, batch, step_ms, top=15):
    """One step under the profiler: busy time and idle share beside the
    timed step, the device time by kind and the largest rows."""
    busy_ms, events = _profile_device(lambda: step(state, batch, seed=0))
    if busy_ms <= 0:
        raise RuntimeError(f"the profiled {label} step recorded no device "
                           f"time")
    print(f"profiled {label} step [{card}]: device busy {busy_ms:.2f} ms of "
          f"a {step_ms:.2f} ms step, idle share {1 - busy_ms / step_ms:.3f}",
          flush=True)
    groups = {}
    for e in events:
        kind = _row_group(e.key)
        ms, n = groups.get(kind, (0.0, 0))
        groups[kind] = (ms + e.self_device_time_total / 1e3, n + e.count)
    for kind, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kind}: {ms:.3f} ms, {100 * ms / busy_ms:.1f}%, "
              f"{n} launches")
    _print_rows(events, busy_ms, top)
    return busy_ms


def phase_seg_train(card, warm_up=3, timed=10):
    """DeepLabV3+ R50 at the ADE20K recipe's full width through
    ``make_train_step`` on a resident batch; one profiled step, the shares
    of both BatchNorms and of the f32 logits path (replayed alone), and the
    logits' align-corners resize beside ``F.interpolate``. Returns (the
    hand-kernel launches of the timed run: none, images per second)."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.perf_counter()
    model = init_params(MODELS.create("resnet50_deeplabv3plus",
                                      num_classes=SEG_CLASSES),
                        torch.Generator().manual_seed(0))
    state = _recipe_state(model, SEG_RECIPE_OPT, SEG_RECIPE_SCHED,
                          SEG_EPOCHS, SEG_STEPS_PER_EPOCH)
    criterion = LOSSES.create("SegCELoss", ignore_index=SEG_IGNORE)
    step = make_train_step(seg_task.make_loss_fn(criterion), EngineConfig())
    batch = _seg_batch()
    print(f"resnet50_deeplabv3plus {SEG_IMAGE}^2 bf16, {SEG_CLASSES} classes "
          f"({sum(p.numel() for p in model.parameters())} parameters), its "
          f"AdamW state and a resident batch of {SEG_BATCH} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _timed_steps(step, state, batch, warm_up, timed)
    launches = _no_hand_kernel("seg_train")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # the work of a step as three forwards: the flop counter's convolution
    # backward counts a depthwise (grouped) weight gradient as a dense one,
    # C times too much
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(batch["image"], train=False)
    flops = 3 * counter.get_total_flops()
    ips = SEG_BATCH / step_ms * 1e3
    print(f"trained {warm_up + timed} steps; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    print(f"DeepLabV3+ R50 {SEG_IMAGE}^2 bf16 training, batch {SEG_BATCH}, "
          f"{SEG_CLASSES} classes [{card}]: {ips:.2f} images/s, "
          f"{step_ms:.2f} ms per step over {timed} steps, peak memory "
          f"{peak_gib:.2f} GiB; {flops / 1e12:.3f} TFLOP per step (3 x the "
          f"flop counter's forward), {flops / step_ms / 1e9:.1f} TFLOP/s",
          flush=True)

    busy_ms = _profiled_step(card, "DeepLabV3+", step, state, batch,
                             step_ms, top=20)

    # shares, each part's forward and backward replayed alone at the
    # step's shapes
    calls = _norm_calls(model, lambda: step(state, batch, seed=0))
    norms = _norm_replay_ms(calls)
    head_in = torch.randn(SEG_BATCH, SEG_IMAGE // 4, SEG_IMAGE // 4, 256,
                          device="cuda")
    logits = torch.randn(SEG_BATCH, SEG_IMAGE // 4, SEG_IMAGE // 4,
                         SEG_CLASSES, device="cuda")
    full = (SEG_IMAGE, SEG_IMAGE)
    logit_parts = {
        "predict_conv (1x1, 256 -> 150, f32)": _fwd_bwd_ms(
            model.head.predict_conv, head_in),
        "align-corners resize 128 -> 512 (f32)": _fwd_bwd_ms(
            lambda t: resize_bilinear(t, full, align_corners=True), logits),
        "SegCELoss (f32)": _fwd_bwd_ms(
            lambda t: criterion(t, batch["mask"]),
            resize_bilinear(logits, full, align_corners=True)),
    }
    del head_in
    counts = {}
    for (kind, _, _), n in calls.items():
        counts[kind] = counts.get(kind, 0) + n
    for kind, label in (("bn_train", "bn_train (FusedBatchNorm, backbone)"),
                        ("flax", "flax BatchNorm (head)")):
        print(f"  replayed {label}: {counts.get(kind, 0)} calls a step, "
              f"{norms.get(kind, 0.0):.3f} ms forward + backward, "
              f"{100 * norms.get(kind, 0.0) / busy_ms:.1f}% of the step's "
              f"busy time [{card}]", flush=True)
    total = sum(logit_parts.values())
    for label, ms in logit_parts.items():
        print(f"  replayed {label}: {ms:.3f} ms forward + backward, "
              f"{100 * ms / busy_ms:.1f}% of the busy time", flush=True)
    print(f"  the f32 logits path: {total:.3f} ms, "
          f"{100 * total / busy_ms:.1f}% of the busy time [{card}]",
          flush=True)

    # the logits' resize beside F.interpolate, forward and backward, on the
    # same f32 tensor
    x = logits.detach().requires_grad_()

    def interp(t):
        return torch.nn.functional.interpolate(
            t.permute(0, 3, 1, 2), size=full, mode="bilinear",
            align_corners=True).permute(0, 2, 3, 1)

    with torch.no_grad():
        diff = (resize_bilinear(x, full, align_corners=True)
                - interp(x)).abs().max().item()
        # F.interpolate rounds each source coordinate to f32 (up to 3.8e-6
        # at 127), times a step between neighbours of up to the range
        diff_bound = 1e-5 * (x.max() - x.min()).item()
    ms = _alternating({
        "resize_bilinear": _fwd_bwd(
            lambda t: resize_bilinear(t, full, align_corners=True), x),
        "F.interpolate": _fwd_bwd(interp, x)}, rounds=5, iters=5)
    print(f"  logits resize [{SEG_BATCH}, 128, 128, {SEG_CLASSES}] -> 512^2 "
          f"f32, forward + backward, median of 5 alternating rounds of 5 "
          f"[{card}]: "
          f"resize_bilinear(align_corners=True) "
          f"{statistics.median(ms['resize_bilinear']):.3f} ms, "
          f"F.interpolate(bilinear, align_corners=True) "
          f"{statistics.median(ms['F.interpolate']):.3f} ms; largest "
          f"difference of the outputs {diff:.3e} (bound {diff_bound:.3e})",
          flush=True)
    if diff > diff_bound:
        raise RuntimeError(f"the align-corners resize parts from "
                           f"F.interpolate by {diff}")
    del state, model, step, batch, logits, x
    torch.cuda.empty_cache()
    return launches, ips


SEG_CLI_TRAIN_CONFIG = '''"""DeepLabV3+ R50 on ADE20K as
experiments/4.semantic_segmentation_training/ade20k/resnet50_deeplabv3plus/
train_config.py states it (resnet50_deeplabv3plus, 150 classes, 512^2,
SegCELoss(ignore_index=255), SegRandomCropResize((2048, 512), (0.5, 2.0),
512^2), the flip, SegPhotoMetricDistortion, SegNormalize, the collater at
512, AdamW 1e-4 / 1e-3, PolyLR 0.9 with a 1-epoch warm-up, batch 16, 8
loader workers), cut to: synthetic data, FakeSegmentationDataset of 32
train and 16 test 640^2 images with 150 classes (no ADE20K here); 1 epoch
(not 128)."""

from {pkg}.core.registry import LOSSES, MODELS
from {pkg}.data.segmentation import (FakeSegmentationDataset,
                                     SegNormalize, SegPhotoMetricDistortion,
                                     SegRandomCropResize,
                                     SegRandomHorizontalFlip, SegResize,
                                     SemanticSegmentationCollater)
from {pkg}.data.transforms import Compose


class config:
    network = "resnet50_deeplabv3plus"
    num_classes = 150
    input_image_size = 512
    ignore_index = 255

    model = MODELS.create(network, num_classes=num_classes)
    train_criterion = LOSSES.create("SegCELoss", ignore_index=ignore_index)

    train_dataset = FakeSegmentationDataset(
        32, 640, num_classes, transform=Compose([
            SegRandomCropResize(image_scale=(2048, 512),
                                multi_scale_range=(0.5, 2.0),
                                crop_size=(input_image_size,
                                           input_image_size)),
            SegRandomHorizontalFlip(prob=0.5),
            SegPhotoMetricDistortion(),
            SegNormalize(),
        ]))
    test_dataset = FakeSegmentationDataset(
        16, 640, num_classes, transform=Compose([
            SegResize(resize=input_image_size),
            SegNormalize(),
        ]))
    train_collater = SemanticSegmentationCollater(resize=input_image_size,
                                                  ignore_index=ignore_index)
    test_collater = SemanticSegmentationCollater(resize=input_image_size,
                                                 ignore_index=ignore_index)

    seed = 0
    batch_size = 16
    num_workers = 8
    accumulation_steps = 1
    optimizer = ("AdamW", {{"lr": 1e-4, "global_weight_decay": False,
                           "weight_decay": 1e-3,
                           "no_weight_decay_layer_name_list": []}})
    scheduler = ("PolyLR", {{"warm_up_epochs": 1, "power": 0.9}})
    epochs = 1
    print_interval = 1
    use_ema_model = False
'''

PFAN_CLI_TRAIN_CONFIG = '''"""PFAN R50 salient-object detection as
experiments/6.salient_object_detection_training/combined/resnet50_pfan/
train_config.py states it (resnet50_pfan_segmentation at 832^2,
BinaryBCELoss + BCEIouloss 1:1, BinarySegResize(832), the flip,
normalisation, BinarySegCollater(832), AdamW 1e-4 / 1e-3, CosineLR to 1e-6
with a 1-epoch warm-up), cut to: batch 8 (not 96, one card); synthetic
data, FakeSegmentationDataset of 32 train and 8 test 640^2 images with the
mask binarised and the image divided by 255 as
fake_synthetic/resnet18_pfan's _BinaryWrap does (no DIS5K, HRS10K, HRSOD
or UHRSD here); 1 epoch (not 100); 8 loader workers (not 16)."""

import numpy as np

from {pkg}.core.registry import LOSSES, MODELS
from {pkg}.data.binary_segmentation import (BinarySegCollater,
                                            BinarySegRandomHorizontalFlip,
                                            BinarySegResize)
from {pkg}.data.segmentation import FakeSegmentationDataset
from {pkg}.data.transforms import Compose


class _BinaryWrap:

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        s = self.ds[i]
        s["mask"] = (s["mask"] > 0).astype(np.float32)
        s["image"] = s["image"] / 255.0
        return s


class config:
    network = "resnet50_pfan_segmentation"
    input_image_size = 832

    model = MODELS.create(network)
    train_criterion = None
    criterion_list = [
        ("BinaryBCELoss", 1.0, LOSSES.create("BinaryBCELoss")),
        ("BCEIouloss", 1.0, LOSSES.create("BCEIouloss")),
    ]

    train_dataset = _BinaryWrap(FakeSegmentationDataset(
        32, 640, 2, transform=Compose([
            BinarySegResize(resize=input_image_size),
            BinarySegRandomHorizontalFlip(prob=0.5)])))
    test_dataset = _BinaryWrap(FakeSegmentationDataset(
        8, 640, 2, transform=BinarySegResize(resize=input_image_size)))
    train_collater = BinarySegCollater(resize=input_image_size)
    test_collater = BinarySegCollater(resize=input_image_size)

    seed = 0
    batch_size = 8
    num_workers = 8
    accumulation_steps = 1
    optimizer = ("AdamW", {{"lr": 1e-4, "global_weight_decay": False,
                           "weight_decay": 1e-3,
                           "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 1, "min_lr": 1e-6}})
    epochs = 1
    print_interval = 1
    use_ema_model = False
'''


def phase_seg_cli(card, resident_ips):
    """The semantic-segmentation train and test CLIs on DeepLabV3+ R50 (the
    ade20k/resnet50_deeplabv3plus recipe's fields and train transforms,
    synthetic data); no hand kernel on this path."""
    return _cli_in_process(card, "seg_cli", seg_train_cli, seg_test_cli,
                           SEG_CLI_TRAIN_CONFIG, resident_ips, ())


def _pfan_resident_ips(card, warm_up=2, timed=5):
    """Images/s of PFAN R50's step at 832^2, batch 8, on a resident batch
    from the pfan_cli config's data."""
    model = init_params(MODELS.create("resnet50_pfan_segmentation"),
                        torch.Generator().manual_seed(0))
    state = _recipe_state(model, PFAN_RECIPE_OPT, PFAN_RECIPE_SCHED, 100, 1)
    step = make_train_step(bseg_task.make_loss_fn(
        [("BinaryBCELoss", 1.0, LOSSES.create("BinaryBCELoss")),
         ("BCEIouloss", 1.0, LOSSES.create("BCEIouloss"))]), EngineConfig())
    ds = FakeSegmentationDataset(PFAN_BATCH, 640, 2,
                                 transform=BinarySegResize(PFAN_IMAGE))
    samples = [ds[i] for i in range(PFAN_BATCH)]
    for s in samples:
        s["mask"] = (s["mask"] > 0).astype(np.float32)
        s["image"] = s["image"] / 255.0
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in BinarySegCollater(PFAN_IMAGE)(samples).items()}
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _timed_steps(step, state, batch, warm_up, timed)
    launches = _no_hand_kernel("pfan_train")
    ips = PFAN_BATCH / step_ms * 1e3
    print(f"PFAN R50 {PFAN_IMAGE}^2 bf16 training, batch {PFAN_BATCH} "
          f"[{card}]: {ips:.2f} images/s, {step_ms:.2f} ms per step over "
          f"{timed} steps, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    del state, model, step, batch
    torch.cuda.empty_cache()
    return launches, ips


def phase_pfan_cli(card):
    """PFAN R50's resident step, then the salient-object-detection train and
    test CLIs on it (the combined/resnet50_pfan recipe's fields at batch 8,
    synthetic data); no hand kernel on either path."""
    launches, ips = _pfan_resident_ips(card)
    return launches, _cli_in_process(
        card, "pfan_cli", sod_train_cli, sod_test_cli, PFAN_CLI_TRAIN_CONFIG,
        ips, ())


def phase_seg_learns(card):
    """``tests/test_torch_convergence.py``'s DeepLabV3+ recipe on the card
    (resnet18_deeplabv3plus, 64 synthetic 64^2 images, 12 epochs): fails
    unless the best mIoU reaches 60."""
    import importlib.util
    import os
    import tempfile
    # by its path: the card's machine may have a package named ``tests``
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_convergence.py")
    spec = importlib.util.spec_from_file_location("test_torch_convergence",
                                                  path)
    convergence = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(convergence)
    _reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work_dir:
        best = convergence.train_deeplab(work_dir, "cuda")
    launches = _no_hand_kernel("seg_learns")
    print(f"seg_learns: resnet18_deeplabv3plus 64^2, 12 epochs in "
          f"{time.perf_counter() - t0:.1f} s [{card}]: best mIoU "
          f"{best:.2f} (60 required)", flush=True)
    if not best >= 60.0:
        raise RuntimeError(f"DeepLabV3+ did not learn: best mIoU {best:.2f}")
    return launches


# ---- dense detection and Sapiens parsing -----------------------------------

# the coco/res50_{fcos,retinanet}_retinaresize800 recipes: 80 classes, the
# retina-style resize to 800 on a 1333^2 canvas, AdamW 1e-4 / 1e-3,
# MultiStepLR x0.1 at epochs 8 and 12 of 13 after a half-epoch warm-up,
# bf16 compute; batch 32 cut to 8 on one card, where COCO's 117,266
# training images with boxes make 14,658 steps an epoch
DET_RECIPE_OPT = SEG_RECIPE_OPT
DET_RECIPE_SCHED = ("MultiStepLR", {"warm_up_epochs": 0.5, "gamma": 0.1,
                                    "milestones": [8, 12]})
DET_EPOCHS, DET_STEPS_PER_EPOCH = 13, 117266 // 8
DET_BATCH, DET_RESIZE, DET_CLASSES = 8, 800, 80
# widerface/resnet50_retinaface: 1 class, the yolo-style resize to 1024,
# AdamW 1e-4 / 1e-3, CosineLR over 100 epochs after a 1-epoch warm-up;
# batch 32 cut to 8, where WIDER FACE's 12,880 training images make 1,610
# steps an epoch
FACE_RECIPE_SCHED = ("CosineLR", {"warm_up_epochs": 1})
FACE_EPOCHS, FACE_STEPS_PER_EPOCH = 100, 12880 // 8
FACE_BATCH, FACE_IMAGE = 8, 1024
# CelebAMask-HQ/sapiens_0_3b_face_parsing: 512^2, 19 classes, SegCELoss +
# softmax SegIoULoss 1:1 with 255 ignored, AdamW 1e-4 / 1e-3, CosineLR to
# 1e-6 over 100 epochs after a 1-epoch warm-up; batch 160 cut to 8, an
# epoch taken as 1,000 steps (it only sets the learning rate's schedule)
SAPIENS_RECIPE_SCHED = ("CosineLR", {"warm_up_epochs": 1, "min_lr": 1e-6})
SAPIENS_EPOCHS, SAPIENS_STEPS_PER_EPOCH = 100, 1000
SAPIENS_BATCH, SAPIENS_IMAGE, SAPIENS_CLASSES = 8, 512, 19
SAPIENS_LOSS = [("SegCELoss", 1.0, {"ignore_index": SEG_IGNORE}),
                ("SegIoULoss", 1.0, {"logit_type": "softmax",
                                     "ignore_index": SEG_IGNORE})]


def _det_batch(n, image_hw, resize, resize_type, classes):
    """A resident batch of ``n`` synthetic images through the recipe's
    resize, normalisation and collater, on the card."""
    ds = FakeDetectionDataset(n, image_hw, classes, transform=Compose([
        DetectionResize(resize=resize, resize_type=resize_type),
        Normalize()]))
    batch = DetectionCollater(resize, resize_type)([ds[i] for i in range(n)])
    return {k: torch.from_numpy(batch[k]).cuda() for k in ("image", "annots")}


def _loss_replay_ms(criterion, preds, annots):
    """Device ms of the criterion alone (assignment, forward and backward)
    on the step's predictions."""
    sizes = [len(group) for group in preds]
    flat = [t.detach() for group in preds for t in group]

    def loss(*tensors):
        groups, i = [], 0
        for n in sizes:
            groups.append(list(tensors[i:i + n]))
            i += n
        return sum(criterion(groups, annots).values())

    return _fwd_bwd_ms(loss, *flat)


def _dense_train(card, path, network, model_kwargs, loss_name, batch, sched,
                 epochs, steps_per_epoch, warm_up, timed):
    """A dense detector at full width through ``make_train_step`` on a
    resident batch: images/s, ms a step, peak memory, a profiled step and
    the loss's share of it. Returns (the hand-kernel launches: none,
    images per second)."""
    t0 = time.perf_counter()
    model = init_params(MODELS.create(network, **model_kwargs),
                        torch.Generator().manual_seed(0))
    state = _recipe_state(model, DET_RECIPE_OPT, sched, epochs,
                          steps_per_epoch)
    criterion = LOSSES.create(loss_name)
    step = make_train_step(det_task.make_loss_fn(criterion), EngineConfig())
    b, side = batch["image"].shape[0], batch["image"].shape[1]
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{network} {side}^2 bf16 ({n_params} parameters), its AdamW "
          f"state and a resident batch of {b} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _timed_steps(step, state, batch, warm_up, timed)
    launches = _no_hand_kernel(path)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ips = b / step_ms * 1e3
    print(f"{path}: {network} {side}^2 bf16 training, batch {b} [{card}]: "
          f"{ips:.2f} images/s, {step_ms:.2f} ms per step over {timed} "
          f"steps, peak memory {peak_gib:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    busy_ms = _profiled_step(card, network, step, state, batch, step_ms)
    with torch.no_grad():
        preds = model(batch["image"], train=True)
    ms = _loss_replay_ms(criterion, preds, batch["annots"])
    print(f"  replayed {loss_name} (assignment over {batch['annots'].shape[1]}"
          f" annotation slots, forward + backward): {ms:.3f} ms, "
          f"{100 * ms / busy_ms:.1f}% of the step's busy time [{card}]",
          flush=True)
    del state, model, step, preds
    torch.cuda.empty_cache()
    return launches, ips


def phase_fcos_train(card, warm_up=3, timed=10):
    """FCOS R50 at the coco/res50_fcos_retinaresize800 recipe's full width
    (80 classes, 1333^2 canvas, FCOSLoss, AdamW, MultiStepLR), batch 8."""
    batch = _det_batch(DET_BATCH, 640, DET_RESIZE, "retina_style",
                       DET_CLASSES)
    return _dense_train(card, "fcos_train", "resnet50_fcos",
                        {"num_classes": DET_CLASSES}, "FCOSLoss", batch,
                        DET_RECIPE_SCHED, DET_EPOCHS, DET_STEPS_PER_EPOCH,
                        warm_up, timed)


def phase_retina_train(card, warm_up=2, timed=5):
    """RetinaNet R50 (coco/res50_retinanet_retinaresize800: 80 classes,
    1333^2 canvas, RetinaLoss, AdamW, MultiStepLR) and RetinaFace R50
    (widerface/resnet50_retinaface: 1024^2, RetinaFaceLoss, AdamW,
    CosineLR), batch 8 each. Returns (the launches of both: none, the
    images per second of each)."""
    batch = _det_batch(DET_BATCH, 640, DET_RESIZE, "retina_style",
                       DET_CLASSES)
    retina, retina_ips = _dense_train(
        card, "retina_train", "resnet50_retinanet",
        {"num_classes": DET_CLASSES}, "RetinaLoss", batch, DET_RECIPE_SCHED,
        DET_EPOCHS, DET_STEPS_PER_EPOCH, warm_up, timed)
    del batch
    batch = _det_batch(FACE_BATCH, 800, FACE_IMAGE, "yolo_style", 1)
    face, face_ips = _dense_train(
        card, "retina_train", "resnet50_retinaface", {}, "RetinaFaceLoss",
        batch, FACE_RECIPE_SCHED, FACE_EPOCHS, FACE_STEPS_PER_EPOCH, warm_up,
        timed)
    return {**retina, **face}, (retina_ips, face_ips)


def _einsum_attention(q, k, v):
    """The ViT's einsum attention (``models/backbones/vit.py``): f32
    products of the compute-dtype q and k, an f32 softmax, the
    probabilities cast to the compute dtype before p.v in f32."""
    attn = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float())
    attn = torch.softmax(attn * q.shape[-1]**-0.5, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", attn.to(q.dtype).float(),
                        v.float())


def phase_sapiens_train(card, warm_up=3, timed=10):
    """Sapiens-0.3B face parsing at the CelebAMask-HQ recipe's full width
    (512^2, 19 classes, SegCombinedLoss, AdamW, CosineLR), batch 8, through
    ``make_train_step`` on a resident batch: the numbers of the dense
    phases, the einsum attention's share (its 24 layers' attention core
    replayed alone at the step's shapes) and the parsing head's (the 8
    transposed and 1x1 convolutions with their f32 InstanceNorms).
    Returns (the launches: none, images per second)."""
    t0 = time.perf_counter()
    model = init_params(MODELS.create(
        "sapiens_0_3b_face_parsing", num_classes=SAPIENS_CLASSES,
        image_size=SAPIENS_IMAGE), torch.Generator().manual_seed(0))
    state = _recipe_state(model, SEG_RECIPE_OPT, SAPIENS_RECIPE_SCHED,
                          SAPIENS_EPOCHS, SAPIENS_STEPS_PER_EPOCH)
    criterion = LOSSES.create("SegCombinedLoss", loss_cfg=SAPIENS_LOSS)
    step = make_train_step(seg_task.make_loss_fn(criterion), EngineConfig())
    batch = _seg_batch(SAPIENS_BATCH, SAPIENS_IMAGE, SAPIENS_CLASSES)
    print(f"sapiens_0_3b_face_parsing {SAPIENS_IMAGE}^2 bf16 "
          f"({sum(p.numel() for p in model.parameters())} parameters), its "
          f"AdamW state and a resident batch of {SAPIENS_BATCH} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _timed_steps(step, state, batch, warm_up, timed)
    launches = _no_hand_kernel("sapiens_train")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ips = SAPIENS_BATCH / step_ms * 1e3
    print(f"sapiens_train: Sapiens-0.3B {SAPIENS_IMAGE}^2 bf16 training, "
          f"batch {SAPIENS_BATCH}, {SAPIENS_CLASSES} classes [{card}]: "
          f"{ips:.2f} images/s, {step_ms:.2f} ms per step over {timed} "
          f"steps, peak memory {peak_gib:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    busy_ms = _profiled_step(card, "Sapiens-0.3B", step, state, batch,
                             step_ms)
    blk = model.blocks[0].attn
    heads, n = blk.head_nums, (SAPIENS_IMAGE // 16)**2
    d = model.patch_embedding.weight.shape[0] // heads
    qkv = [torch.randn(SAPIENS_BATCH, heads, n, d, device="cuda",
                       dtype=torch.bfloat16) for _ in range(3)]
    attn_ms = len(model.blocks) * _fwd_bwd_ms(_einsum_attention, *qkv)
    del qkv

    def head(y):
        for i in range(model.n_deconv):
            y = torch.nn.functional.silu(model.norm(
                getattr(model, f"convt{i + 1}")(y)))
        for i in range(model.n_conv):
            y = torch.nn.functional.silu(model.norm(
                getattr(model, f"conv{i + 1}")(y)))
        return model.pred_conv(y)

    side = SAPIENS_IMAGE // 16
    head_ms = _fwd_bwd_ms(head, torch.randn(
        SAPIENS_BATCH, side, side, model.patch_embedding.weight.shape[0],
        device="cuda"))
    print(f"  replayed einsum attention (f32 scores [{SAPIENS_BATCH}, {heads}"
          f", {n}, {n}], forward + backward) x {len(model.blocks)} layers: "
          f"{attn_ms:.3f} ms, {100 * attn_ms / busy_ms:.1f}% of the step's "
          f"busy time [{card}]", flush=True)
    print(f"  replayed parsing head (4 transposed + 4 1x1 convolutions with "
          f"f32 InstanceNorm and SiLU, to {SAPIENS_IMAGE}^2, forward + "
          f"backward): {head_ms:.3f} ms, {100 * head_ms / busy_ms:.1f}% of "
          f"the busy time [{card}]", flush=True)
    del state, model, step, batch
    torch.cuda.empty_cache()
    return launches, ips


def _grads_on(device, model, loss_fn, batch):
    """(loss, each parameter's gradient as f64 on the CPU) of one f32
    train-mode forward and backward on ``device``."""
    model = model.to(device).train()
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, {k: v.to(device) for k, v in batch.items()},
                      None, True)
    loss.backward()
    return loss.item(), [p.grad.double().cpu() for p in model.parameters()
                         if p.requires_grad]


def _parity(card, label, make_model, loss_fn, batch, loss_rel, grad_rel,
            grad_cos, path="dense_parity", zero_expected=None):
    """The card's f32 step (TF32 off) against the CPU's from the same
    weights and batch: fails unless the loss agrees within ``loss_rel``,
    all gradients within ``grad_rel`` in L2 and each parameter's at a
    cosine of at least ``grad_cos``, but for the parameters whose names
    match the regular expression ``zero_expected`` (a true gradient of 0:
    a bias whose per-channel shift only train-mode BatchNorms see; both
    sides' values are rounding noise), which count in the L2 bound only.
    Returns the CPU model."""
    t0 = time.perf_counter()
    cpu_model = make_model()
    card_model = make_model()
    card_model.load_state_dict(cpu_model.state_dict())
    loss_c, grads_c = _grads_on("cuda", card_model, loss_fn, batch)
    with torch.backends.mkldnn.flags(enabled=False):
        loss_h, grads_h = _grads_on("cpu", cpu_model, loss_fn, batch)
    flat_c = torch.cat([g.flatten() for g in grads_c])
    flat_h = torch.cat([g.flatten() for g in grads_h])
    rel = ((flat_c - flat_h).norm() / flat_h.norm()).item()
    names = [n for n, p in cpu_model.named_parameters() if p.requires_grad]
    cos = min(torch.nn.functional.cosine_similarity(
        a.flatten(), b.flatten(), dim=0).item()
        for n, a, b in zip(names, grads_c, grads_h)
        if b.norm() > 0 and not (zero_expected
                                 and re.fullmatch(zero_expected, n)))
    print(f"{path}: {label}, f32 train step, card (TF32 off) vs CPU "
          f"({time.perf_counter() - t0:.1f} s) [{card}]: loss {loss_c:.6f} "
          f"vs {loss_h:.6f}, gradient relative L2 difference {rel:.3e} "
          f"(bound {grad_rel}), least per-parameter cosine {cos:.6f} "
          f"(bound {grad_cos})", flush=True)
    if not (abs(loss_c - loss_h) <= loss_rel * abs(loss_h) and rel <= grad_rel
            and cos >= grad_cos):
        raise RuntimeError(f"the f32 {label} step on the card disagrees "
                           f"with the CPU")
    del card_model
    torch.cuda.empty_cache()
    return cpu_model


def phase_dense_parity(card):
    """FCOS R50 at 256^2, batch 2, and Sapiens-0.3B at 256^2, batch 1: one
    f32 train step's loss and gradients on the card (TF32 off) against the
    CPU, and the FCOS decoder's output on the card against the CPU's on
    the same predictions. Returns the launches (none)."""
    _reset_launches()
    fcos_batch = _det_batch(2, 256, 256, "yolo_style", DET_CLASSES)
    fcos_batch = {k: v.cpu() for k, v in fcos_batch.items()}
    # train-mode BatchNorm at batch 2 spreads each rounding switch (a ReLU
    # input within f32 rounding of 0) over its channel, as in the ResNet-50
    # f32 step: the gradients are held in L2 and by cosine
    cpu_fcos = _parity(
        card, "resnet50_fcos 256^2, batch 2",
        lambda: init_params(MODELS.create(
            "resnet50_fcos", num_classes=DET_CLASSES, dtype=torch.float32),
            torch.Generator().manual_seed(3)),
        det_task.make_loss_fn(LOSSES.create("FCOSLoss")), fcos_batch,
        loss_rel=1e-3, grad_rel=5e-2, grad_cos=0.99)
    with torch.no_grad():
        preds = cpu_fcos.eval()(fcos_batch["image"])
    decoder = DECODERS.create("FCOSDecoder")
    want = decoder(preds)
    got = decoder([[t.cuda() for t in group] for group in preds])
    valid = int((want[0] > -1).sum())
    same = (np.allclose(got[0], want[0], rtol=1e-6, atol=0)
            and np.array_equal(got[1], want[1])
            and np.array_equal(got[2], want[2]))
    print(f"dense_parity: FCOSDecoder on the card vs the CPU on the same "
          f"predictions: {valid} detections, scores within 1e-6 relative, "
          f"classes and boxes equal: {same}", flush=True)
    if not same or valid == 0:
        raise RuntimeError("the FCOS decoder on the card disagrees with the "
                           "CPU")
    del cpu_fcos, preds
    seg_batch = _seg_batch(1, 256, SAPIENS_CLASSES)
    seg_batch = {k: v.cpu() for k, v in seg_batch.items()}
    _parity(card, "sapiens_0_3b_face_parsing 256^2, batch 1",
            lambda: init_params(MODELS.create(
                "sapiens_0_3b_face_parsing", num_classes=SAPIENS_CLASSES,
                image_size=256, dtype=torch.float32),
                torch.Generator().manual_seed(4)),
            seg_task.make_loss_fn(LOSSES.create(
                "SegCombinedLoss", loss_cfg=SAPIENS_LOSS)), seg_batch,
            loss_rel=1e-4, grad_rel=1e-3, grad_cos=0.9999)
    return _no_hand_kernel("dense_parity")


SAPIENS_CLI_TRAIN_CONFIG = """\"\"\"Sapiens-0.3B face parsing on CelebAMask-HQ
as experiments/11.face_parsing_training/CelebAMask-HQ/sapiens_0_3b_face_parsing/
train_config.py states it (sapiens_0_3b_face_parsing, 19 classes, 512^2,
SegCELoss + softmax SegIoULoss 1:1 with 255 ignored, SegResize(512), the
flip, SegNormalize, the collater at 512, AdamW 1e-4 / 1e-3, CosineLR to
1e-6 with a 1-epoch warm-up), cut to: batch 8 (not 160, one card);
synthetic data, FakeSegmentationDataset of 16 train and 8 test 640^2
images with 19 classes in place of FaceParsingDataset (no CelebAMask-HQ
here); 1 epoch (not 100); 8 loader workers (not 16).\"\"\"

from {pkg}.core.registry import LOSSES, MODELS
from {pkg}.data.segmentation import (FakeSegmentationDataset,
                                     SegNormalize, SegRandomHorizontalFlip,
                                     SegResize, SemanticSegmentationCollater)
from {pkg}.data.transforms import Compose


class config:
    network = "sapiens_0_3b_face_parsing"
    num_classes = 19
    input_image_size = 512
    ignore_index = 255

    model = MODELS.create(network, num_classes=num_classes,
                          image_size=input_image_size)
    train_criterion = LOSSES.create("SegCombinedLoss", loss_cfg=[
        ("SegCELoss", 1.0, {{"ignore_index": ignore_index}}),
        ("SegIoULoss", 1.0, {{"logit_type": "softmax",
                             "ignore_index": ignore_index}}),
    ])
    train_dataset = FakeSegmentationDataset(
        16, 640, num_classes, transform=Compose([
            SegResize(resize=input_image_size),
            SegRandomHorizontalFlip(prob=0.5), SegNormalize()]))
    test_dataset = FakeSegmentationDataset(
        8, 640, num_classes, transform=Compose([
            SegResize(resize=input_image_size), SegNormalize()]))
    train_collater = SemanticSegmentationCollater(resize=input_image_size)
    test_collater = SemanticSegmentationCollater(resize=input_image_size)

    seed = 0
    batch_size = 8
    num_workers = 8
    accumulation_steps = 1
    optimizer = ("AdamW", {{"lr": 1e-4, "global_weight_decay": False,
                           "weight_decay": 1e-3,
                           "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 1, "min_lr": 1e-6}})
    epochs = 1
    print_interval = 1
    use_ema_model = False
"""


def _experiment_cli(card, path, rel, train_cli, test_cli, evaluates=True):
    """A repository experiment (``experiments/<rel>``) through its train CLI
    and, where its family has one (``test_cli`` not None), its test CLI, in
    this process, in a scratch copy whose test config restores the best
    checkpoint. Prints the seconds, peak memory and the metrics; fails when
    a CLI raises or writes no best checkpoint, when a family with a test
    CLI logs no evaluation (unless ``evaluates`` is false: a train config
    without a test set, whose test config falls back on its train set) or
    tests another metric than the best, or when a hand kernel was launched.
    Returns the launches."""
    import os
    import shutil
    import tempfile
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "experiments", rel)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work_dir:
        for name in os.listdir(src):
            if name.endswith(".py"):
                shutil.copy(os.path.join(src, name), work_dir)
        test_path = os.path.join(work_dir, "test_config.py")
        with open(test_path) as f:
            text = f.read()
        with open(test_path, "w") as f:
            f.write(text.replace('trained_model_path = ""',
                                 "trained_model_path = os.path.join(os.path."
                                 "dirname(os.path.abspath(__file__)), "
                                 "\"checkpoints\", \"best\")"))
        argv = ["--work-dir", work_dir]
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        best = train_cli.main(argv)
        train_s = time.perf_counter() - t0
        metrics, test_s = None, 0.0
        if test_cli is not None:
            t0 = time.perf_counter()
            metrics = test_cli.main(argv)
            test_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _no_hand_kernel(path)
        if not os.path.isfile(os.path.join(work_dir, "checkpoints", "best")):
            raise RuntimeError(f"{rel}: no best checkpoint")
        with open(os.path.join(work_dir, "log", "train.log")) as f:
            log = f.read()
    evals = [ln for ln in log.splitlines() if " eval: {" in ln]
    epochs = [ln for ln in log.splitlines() if " done; loss " in ln]
    tested = None if metrics is None else metrics.get("key_metric")
    print(f"{path}: {rel}: train CLI {train_s:.1f} s ({len(epochs)} epochs, "
          f"{len(evals)} with their evaluation), test CLI {test_s:.1f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card}]; best key metric {best:.6f} (mAP, top-1 x 100, minus "
          f"the SAD; minus the loss without an evaluation); test CLI key "
          f"metric {tested}; "
          f"{epochs[-1].split(' - ')[-1] if epochs else 'no epoch'}",
          flush=True)
    if not epochs or not np.isfinite(best) or metrics is not None and (
            evaluates and (not evals or abs(tested - best) > 1e-6)
            or not np.isfinite(tested)):
        raise RuntimeError(f"{rel}: no epoch or evaluation logged, or the "
                           f"test CLI's {tested} is not the best {best}")
    return launches


def phase_dense_cli(card, sapiens_ips):
    """fake_synthetic/resnet18_fcos and resnet18_retinaface through the
    detection and face-detection train and test CLIs, and Sapiens-0.3B
    through the face-parsing ones on the CelebAMask-HQ recipe's fields
    with synthetic data; no hand kernel on these paths."""
    launches = {}
    for rel, train_cli, test_cli in (
            ("3.detection_training/fake_synthetic/resnet18_fcos",
             dense_train_cli, det_test_cli),
            ("10.face_detection_training/fake_synthetic/resnet18_retinaface",
             face_det_train_cli, face_det_test_cli)):
        launches.update(_experiment_cli(card, "dense_cli", rel, train_cli,
                                        test_cli))
    launches.update(_cli_in_process(
        card, "dense_cli", face_parsing_train_cli, face_parsing_test_cli,
        SAPIENS_CLI_TRAIN_CONFIG, sapiens_ips, ()))
    return launches


def phase_fcos_learns(card):
    """``tests/test_torch_convergence.py``'s FCOS recipe on the card
    (resnet18_fcos, 64 synthetic 96^2 images of one rectangle, 16 epochs):
    fails unless the best mAP reaches 30 and the final model's mAP at IoU
    0.5 reaches 0.5."""
    import importlib.util
    import os
    import tempfile
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_convergence.py")
    spec = importlib.util.spec_from_file_location("test_torch_convergence",
                                                  path)
    convergence = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(convergence)
    _reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work_dir:
        best, final = convergence.train_fcos(work_dir, "cuda")
    launches = _no_hand_kernel("fcos_learns")
    ap50 = final["IoU=0.5,area=all,maxDets=100,mAP"]
    print(f"fcos_learns: resnet18_fcos 96^2, 16 epochs in "
          f"{time.perf_counter() - t0:.1f} s [{card}]: best mAP {best:.2f} "
          f"(30 required), final mAP at IoU 0.5 {ap50:.4f} (0.5 required)",
          flush=True)
    if not (best >= 30.0 and ap50 >= 0.5):
        raise RuntimeError(f"FCOS did not learn: best mAP {best:.2f}, final "
                           f"mAP at IoU 0.5 {ap50:.4f}")
    return launches


# ---------------------------------------------------------------- slice 15

MOE_RECIPE_OPT = ("AdamW", {"lr": 1e-3, "global_weight_decay": False,
                            "weight_decay": 0.05, "beta1": 0.9,
                            "beta2": 0.999,
                            "no_weight_decay_layer_name_list": [
                                "position_encoding", "cls_token", "router"],
                            "lr_layer_decay": 0.75,
                            "lr_layer_decay_block_nums": 12,
                            "block_name": "blocks"})
MOE_RECIPE_SCHED = ("CosineLR", {"warm_up_epochs": 5, "min_lr": 1e-6})
MAE_BATCH = 256  # the imagenet/vit_base_mae recipe's 1024, cut
MAE_RECIPE_OPT = ("AdamW", {"lr": 1.5e-4 * 1024 / 256, "beta1": 0.9,
                            "beta2": 0.95, "global_weight_decay": False,
                            "weight_decay": 0.05,
                            "no_weight_decay_layer_name_list": [
                                "cls_token", "mask_token"]})
MAE_RECIPE_SCHED = ("CosineLR", {"warm_up_epochs": 40})
KD_BATCH = 128  # the resnet152_to_resnet50_kd recipe's 256, cut
KD_RECIPE_OPT = ("SGD", {"lr": 0.1, "momentum": 0.9,
                         "global_weight_decay": False, "weight_decay": 1e-4,
                         "no_weight_decay_layer_name_list": []})
KD_RECIPE_SCHED = ("CosineLR", {"warm_up_epochs": 5})
KD_LOSS_LIST = [{"loss_name": "CELoss", "loss_ratio": 1.0},
                {"loss_name": "KDLoss", "loss_ratio": 1.0, "T": 1.0}]
# epochs cut to 4 steps, so that a warm-up spans a few steps of this run
RECIPE_STEPS_PER_EPOCH = 4


def _moe_layers(model):
    return [m for m in model.modules() if isinstance(m, moe.MoEFeedForward)]


def _routing_alone(layer, xt):
    """A callable running one MoE layer's routing alone, forward and
    backward: the router, the positions, the dispatch gather into the expert
    buffers and the combine gather, with the experts' FFN left out (the
    buffers go straight to the combine)."""
    xt = xt.detach().requires_grad_()
    e, cap = layer.num_experts, layer.capacity(xt.shape[0])

    def run():
        xt.grad = None
        layer.router.grad = None
        _, slots, gates, aux = layer.route(xt)
        out = moe.dispatch(xt, slots, cap, e).float()
        y = moe.combine(out.reshape(e * cap, -1), slots, gates)
        (y.sum() + aux).backward()

    return run


def _moe_dispatch_vs_one_hot(card, batch=16):
    """One MoE layer's index dispatch and combine against the one-hot
    einsums (``top_k_dispatch``, the JAX formula, which shares no code with
    the index routing) on the card at ``batch`` images of 197 tokens: the
    expert buffers exactly, the combine to 1e-6 of its scale, and the
    card's slots equal to the CPU's on the same probabilities."""
    g = torch.Generator(device="cuda").manual_seed(3)
    t, e, c = batch * 197, 8, 768
    layer = init_params(moe.MoEFeedForward(c, 4 * c, num_experts=e, top_k=2),
                        torch.Generator().manual_seed(0)).cuda()
    cap = layer.capacity(t)
    xt = torch.randn(t, c, generator=g, device="cuda").bfloat16()
    _, slots, gates, _ = layer.route(xt)
    probs = torch.softmax(xt.float() @ layer.router, -1)
    one_hot, gated, _ = moe.top_k_dispatch(probs, cap, 2)
    cpu_slots, _, _ = moe.top_k_route(probs.cpu(), cap, 2)
    same_slots = all(torch.equal(a.cpu(), b) for a, b in zip(slots,
                                                              cpu_slots))
    buffers = moe.dispatch(xt, slots, cap, e)
    want = torch.einsum("tec,td->ecd", one_hot, xt.float())
    out = torch.randn(e * cap, c, generator=g, device="cuda")
    y = moe.combine(out, slots, gates)
    y_ref = torch.einsum("tec,ecd->td", gated, out.reshape(e, cap, c))
    err = ((y - y_ref).abs().max() / y_ref.abs().max()).item()
    exact = torch.equal(buffers.float(), want)
    print(f"moe_train: one MoE layer's index dispatch against the one-hot "
          f"form at batch {batch} (T {t}, Cap {cap}, [T, E, Cap] f32 "
          f"{one_hot.numel() * 4 / 1e6:.0f} MB) [{card}]: expert buffers "
          f"{'equal' if exact else 'DIFFER'}, combine max error {err:.3e} of "
          f"its scale, slots {'equal to' if same_slots else 'DIFFER from'} "
          f"the CPU's", flush=True)
    if not exact or err > 1e-6 or not same_slots:
        raise RuntimeError("the MoE index dispatch disagrees with the "
                           "one-hot form")


def phase_moe_train(card, warm_up=2, timed=6):
    """ViT-MoE-B/16 at 224^2, bf16, batch 128, with the
    imagenet/vit_moe_base_patch16 recipe's model fields (global pool,
    drop-path 0.1, 8 experts, top-2, capacity factor 1.25), flash attention
    on, OneHotLabelCELoss plus 0.01 x the MoE auxiliary loss, the recipe's
    AdamW (layer decay 0.75, no decay on the router) and CosineLR, through
    ``make_train_step`` on a resident batch. K1-K3: 12 launches each a
    step, none narrow. Returns (the launches of the timed run, images
    per second)."""
    t0 = time.perf_counter()
    model = init_params(BACKBONES.create(
        "vit_moe_base_patch16", image_size=224, num_classes=1000,
        global_pool=True, drop_path_prob=0.1, num_experts=8, top_k=2,
        capacity_factor=1.25, use_flash_attention=True),
        torch.Generator().manual_seed(0))
    state = _recipe_state(model, MOE_RECIPE_OPT, MOE_RECIPE_SCHED, 100,
                          RECIPE_STEPS_PER_EPOCH)
    step = make_train_step(make_loss_fn(LOSSES.create("OneHotLabelCELoss"),
                                        moe_aux_weight=0.01), EngineConfig())
    g = torch.Generator(device="cuda").manual_seed(1)
    labels = torch.randint(0, 1000, (TRAIN_BATCH,), generator=g,
                           device="cuda")
    batch = {"image": torch.randn(TRAIN_BATCH, 224, 224, 3, generator=g,
                                  device="cuda"),
             "label": torch.nn.functional.one_hot(labels, 1000).float()}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"vit_moe_base_patch16 224^2 bf16 ({n_params} parameters, "
          f"{len(_moe_layers(model))} MoE layers), its AdamW state and a "
          f"resident batch of {TRAIN_BATCH} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _timed_steps(step, state, batch, warm_up, timed)
    launches = dict(fa.KERNEL_LAUNCHES)
    steps = warm_up + timed
    print(f"moe_train: kernel launches "
          f"{ {k: launches[k] for k in TRAIN_KERNELS} } over {steps} steps "
          f"(12 per step each expected)", flush=True)
    if any(launches[k] != 12 * steps for k in TRAIN_KERNELS):
        raise RuntimeError("the ViT-MoE step did not launch each flash "
                           "kernel 12 times")
    _wide_kernels_only("the ViT-MoE train step")
    dropped = [float(m.dropped) for m in _moe_layers(model)]
    aux = moe.moe_aux_loss(model).item()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ips = TRAIN_BATCH / step_ms * 1e3
    print(f"moe_train: ViT-MoE-B/16 224^2 bf16 training, batch "
          f"{TRAIN_BATCH} [{card}]: {ips:.2f} images/s, {step_ms:.2f} ms per "
          f"step over {timed} steps, peak memory {peak_gib:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; last step's summed "
          f"auxiliary loss {aux:.4f}; share of token choices dropped past "
          f"capacity by layer {' '.join(f'{d:.4f}' for d in dropped)} "
          f"(mean {np.mean(dropped):.4f}); expert products' route: "
          f"torch.bmm(out_dtype=float32), the backward's on the f32 "
          f"gradient in two bf16 parts", flush=True)
    busy_ms = _profiled_step(card, "ViT-MoE-B/16", step, state, batch,
                             step_ms)
    # the routing of each MoE layer replayed alone on a layer input of the
    # step's shape (the normalised residual stream, bf16)
    seen = {}
    layer = _moe_layers(model)[0]
    hook = layer.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("x", args[0].detach()))
    with torch.no_grad():
        model(batch["image"])
    hook.remove()
    xt = seen["x"].reshape(-1, seen["x"].shape[-1])
    routing = _routing_alone(layer, xt)
    ms = _cuda_ms(routing, 10) * len(_moe_layers(model))
    print(f"  replayed the routing alone (router, positions, dispatch and "
          f"combine gathers, forward + backward) x {len(_moe_layers(model))}"
          f" layers: {ms:.3f} ms, {100 * ms / busy_ms:.1f}% of the step's "
          f"busy time [{card}]; one layer's rows:", flush=True)
    one_ms, events = _profile_device(routing)
    _print_rows(events, one_ms, 8)
    del state, model, step, batch, seen, xt
    torch.cuda.empty_cache()
    _moe_dispatch_vs_one_hot(card)
    return launches, ips


def phase_mae_train(card, warm_up=2, timed=6):
    """The imagenet/vit_base_mae recipe: ViT-B/16 encoder, an 8-block
    512-wide decoder, mask ratio 0.75, MAEMSELoss, AdamW at beta2 0.95,
    bf16, at batch 256 (cut from 1024) on a resident batch. No hand
    kernel. Returns (the launches: none, images per second)."""
    t0 = time.perf_counter()
    model = init_params(MODELS.create(
        "vit_base_patch16_224_mae_pretrain_model"),
        torch.Generator().manual_seed(0))
    state = _recipe_state(model, MAE_RECIPE_OPT, MAE_RECIPE_SCHED, 400,
                          RECIPE_STEPS_PER_EPOCH)
    step = make_train_step(mae_task.make_loss_fn(LOSSES.create("MAEMSELoss")),
                           EngineConfig())
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = {"image": torch.randn(MAE_BATCH, 224, 224, 3, generator=g,
                                  device="cuda")}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"vit_base_patch16_224_mae_pretrain_model 224^2 bf16 ({n_params} "
          f"parameters), its AdamW state and a resident batch of "
          f"{MAE_BATCH} built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _timed_steps(step, state, batch, warm_up, timed)
    launches = _no_hand_kernel("mae_train")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ips = MAE_BATCH / step_ms * 1e3
    print(f"mae_train: ViT-B/16 MAE 224^2 bf16 pretraining, batch "
          f"{MAE_BATCH} [{card}]: {ips:.2f} images/s, {step_ms:.2f} ms per "
          f"step over {timed} steps, peak memory {peak_gib:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the MAE loss did not fall: {losses}")
    _profiled_step(card, "MAE", step, state, batch, step_ms)
    del state, model, step, batch
    torch.cuda.empty_cache()
    return launches, ips


def phase_kd_train(card, warm_up=2, timed=6):
    """The imagenet/resnet152_to_resnet50_kd recipe: a frozen R152 teacher
    and an R50 student, CE + KD at T 1, SGD 0.1, 224^2, bf16, batch 128
    (cut from 256) on a resident batch; the teacher's BatchNorm statistics
    must not move. No hand kernel. Returns (the launches: none, images per
    second)."""
    t0 = time.perf_counter()
    model = init_params(MODELS.create(
        "KDTeacherStudent", teacher_type="resnet152",
        student_type="resnet50", num_classes=1000),
        torch.Generator().manual_seed(0))
    state = _recipe_state(model, KD_RECIPE_OPT, KD_RECIPE_SCHED, 300,
                          RECIPE_STEPS_PER_EPOCH)
    step = make_train_step(kd_task.make_loss_fn(
        kd_task.build_criterion_list(KD_LOSS_LIST)), EngineConfig())
    g = torch.Generator(device="cuda").manual_seed(4)
    batch = {"image": torch.randn(KD_BATCH, 224, 224, 3, generator=g,
                                  device="cuda"),
             "label": torch.randint(0, 1000, (KD_BATCH,), generator=g,
                                    device="cuda")}
    stats = {k: v.clone() for k, v in model.teacher.state_dict().items()
             if "running" in k}
    print(f"KDTeacherStudent resnet152 -> resnet50 224^2 bf16, its SGD "
          f"state and a resident batch of {KD_BATCH} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _timed_steps(step, state, batch, warm_up, timed)
    launches = _no_hand_kernel("kd_train")
    moved = [k for k, v in model.teacher.state_dict().items()
             if "running" in k and not torch.equal(v, stats[k])]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ips = KD_BATCH / step_ms * 1e3
    print(f"kd_train: R152 -> R50 distillation 224^2 bf16, batch {KD_BATCH} "
          f"[{card}]: {ips:.2f} images/s, {step_ms:.2f} ms per step over "
          f"{timed} steps, peak memory {peak_gib:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}; teacher BatchNorm "
          f"statistics moved in {len(moved)} of {len(stats)} buffers",
          flush=True)
    if moved:
        raise RuntimeError(f"the frozen teacher's statistics moved: "
                           f"{moved[:4]}")
    _profiled_step(card, "KD", step, state, batch, step_ms)
    del state, model, step, batch
    torch.cuda.empty_cache()
    return launches, ips


def _to_device(tree, device):
    """A nest of dicts, lists and tuples with its tensors on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


# pixels a rotated image may move between the card and the CPU: the bound
# tests/test_torch_device_augment.py holds (torch's f32 cos/sin against
# XLA's moved at most 5 of 224^2 over 20,000 angles)
ROTATED_PX = 32


def _augment_vs_cpu(card, label, pipe, batch):
    """The card's augmented batch against the CPU's on the same draws (the
    card's): the augment stage's lattice off by more than one level only in
    rotated images, at most ROTATED_PX pixels in each, at most 0.5% of its
    pixels off at all; the final batch
    the same share, the labels to 1e-6 (the tests' bound)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    draws = pipe.draw(batch, g)
    out = pipe.apply(batch, draws)
    lattice = pipe.augment.apply(batch["image"].float(), draws["augment"])
    cpu_draws = _to_device(draws, "cpu")
    cpu_batch = _to_device(batch, "cpu")
    t0 = time.perf_counter()
    ref = pipe.apply(cpu_batch, cpu_draws)
    cpu_s = time.perf_counter() - t0
    ref_lattice = pipe.augment.apply(cpu_batch["image"].float(),
                                     cpu_draws["augment"])
    rotated = torch.zeros(batch["image"].shape[0], dtype=torch.bool)
    for apply, _, cls, kind in cpu_draws["augment"]["slots"]:
        rotated |= apply & (cls == dev_aug._CLS_GEOM) & (
            kind == dev_aug._G_ROT)
    diff = (lattice.cpu() - ref_lattice).abs()
    far = (diff > 1).any(-1).sum((1, 2))
    off = (diff > 0).any(-1).float().mean().item()
    final_off = ((out["image"].cpu() - ref["image"]).abs() > 1e-6).any(
        -1).float().mean().item()
    label_err = (out["label"].cpu() - ref["label"]).abs().max().item()
    print(f"  {label}: card against CPU on the same draws: {int(rotated.sum())}"
          f" rotated images, pixels off by more than a level "
          f"{int(far[rotated].sum())} in them and {int(far[~rotated].sum())} "
          f"elsewhere; lattice pixels off {off:.2e}, final {final_off:.2e}; "
          f"label max error {label_err:.1e}; the CPU's apply took "
          f"{cpu_s:.1f} s [{card}]", flush=True)
    if (far[~rotated] > 0).any() or (far[rotated] > ROTATED_PX).any() \
            or off > 5e-3 or final_off > 5e-3 or label_err > 1e-6:
        raise RuntimeError(f"{label}: the card's augmented batch parts from "
                           f"the CPU's beyond the stated bound")


def phase_deviceaug_train(card, warm_up=2, timed=6):
    """The ResNet-50 step at 224^2, batch 128, on resident uint8 batches
    through ``make_train_step``'s ``augment_fn``: the
    imagenet/vit_base_patch16_deviceaug pipeline (RandAugment(2, 9),
    erasing 0.25, mixup/cutmix) and AutoAugment v0 in its place; the
    augmentation timed alone beside the step, and the card's augmented
    batch held against the CPU's. No hand kernel. Returns (the launches:
    none, images per second of each pipeline)."""
    g = torch.Generator(device="cuda").manual_seed(6)
    batch = {"image": torch.randint(0, 256, (RESNET_BATCH, 224, 224, 3),
                                    generator=g, device="cuda").to(
                                        torch.uint8),
             "label": torch.randint(0, 1000, (RESNET_BATCH,), generator=g,
                                    device="cuda")}
    launches, rates = {}, {}
    for label, augment in (("RandAugment(2, 9)",
                            dev_aug.DeviceRandAugment(2, 9)),
                           ("AutoAugment v0",
                            dev_aug.DeviceAutoAugment("v0"))):
        pipe = dev_aug.DeviceAugmentPipeline(
            augment=augment, erasing=dev_aug.DeviceRandomErasing(prob=0.25),
            mixupcutmix=dev_aug.DeviceMixupCutmix(
                use_mixup=True, mixup_alpha=0.8, cutmix_alpha=1.0,
                num_classes=1000))
        model = _resnet50()
        state = _resnet_state(model)
        step = make_train_step(make_loss_fn(
            LOSSES.create("OneHotLabelCELoss")), RESNET_CFG, augment_fn=pipe)
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses = _timed_steps(step, state, batch, warm_up, timed)
        launches.update(_no_hand_kernel("deviceaug_train"))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        gen = torch.Generator(device="cuda").manual_seed(7)
        aug_ms = _cuda_ms(lambda: pipe(batch, gen), 10)
        rates[label] = RESNET_BATCH / step_ms * 1e3
        print(f"deviceaug_train: ResNet-50 224^2 bf16 on uint8 batches with "
              f"{label} + erasing 0.25 + mixup/cutmix, batch {RESNET_BATCH} "
              f"[{card}]: {rates[label]:.2f} images/s, {step_ms:.2f} ms per "
              f"step over {timed} steps, the augmentation alone "
              f"{aug_ms:.3f} ms ({100 * aug_ms / step_ms:.1f}% of the step),"
              f" peak memory {peak_gib:.2f} GiB; losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
        _profiled_step(card, f"ResNet-50 + {label}", step, state, batch,
                       step_ms, top=10)
        _augment_vs_cpu(card, label, pipe, batch)
        del state, model, step
        torch.cuda.empty_cache()
    return launches, rates


def phase_cls_cli(card):
    """fake_synthetic/{vit_moe_tiny, resnet18_kd, tiny_vit_mae,
    resnet18_deviceaug} through the port's train CLIs in this process, and
    test_classification where the family has a test CLI. No hand kernel
    (the tiny ViT-MoE config leaves flash off)."""
    launches = {}
    for rel, train_cli, test_cli in (
            ("0.classification_training/fake_synthetic/vit_moe_tiny",
             cls_train_cli, cls_test_cli),
            ("1.distillation_training/fake_synthetic/resnet18_kd",
             kd_train_cli, None),
            ("2.masked_image_modeling_training/fake_synthetic/tiny_vit_mae",
             mae_train_cli, None),
            ("0.classification_training/fake_synthetic/resnet18_deviceaug",
             cls_train_cli, cls_test_cli)):
        launches.update(_experiment_cli(card, "cls_cli", rel, train_cli,
                                        test_cli))
    return launches


def _slice_15(card):
    """The phases of slice 15: {path: launches}."""
    paths = {}
    paths["moe_train"], _ = phase_moe_train(card)
    paths["mae_train"], _ = phase_mae_train(card)
    paths["kd_train"], _ = phase_kd_train(card)
    paths["deviceaug_train"], _ = phase_deviceaug_train(card)
    paths["cls_cli"] = phase_cls_cli(card)
    return paths


# ------------------------------ slice 16 ------------------------------

SAM_IMAGE = 1024

# per optimizer step of SAM-B (4 global layers, no gradient checkpointing):
# a distillation's frozen teacher and its student each launch the forward
# kernel once per global layer, the student's backward each backward kernel
# once; a matting model launches the forward and backward once each
DISTILL_STEP_LAUNCHES = {"flash_attention_relpos_fwd": 8,
                         "flash_attention_relpos_dq": 4,
                         "flash_attention_relpos_dkv": 4}
MATTING_STEP_LAUNCHES = {k: 4 for k in SAM_KERNELS}
SAM_RECIPE_OPT = ("AdamW", {"lr": 1e-4, "global_weight_decay": False,
                            "weight_decay": 1e-4,
                            "no_weight_decay_layer_name_list": [],
                            "frozen_layer_name_list": ["teacher"]})
SAM_RECIPE_SCHED = ("CosineLR", {"warm_up_epochs": 1})
MATTING_RECIPE_OPT = ("AdamW", {"lr": 1e-4, "global_weight_decay": False,
                                "weight_decay": 1e-3,
                                "no_weight_decay_layer_name_list": []})
MATTING_RECIPE_SCHED = ("CosineLR", {"warm_up_epochs": 1, "min_lr": 1e-6})
MATTING_LOSSES = ("GlobalTrimapCELoss", "GloabelTrimapIouLoss",
                  "LocalAlphaLoss", "LocalLaplacianLoss", "FusionAlphaLoss",
                  "FusionLaplacianLoss", "CompositionLoss")


def _sam_distill_batch(n=SAM_BATCH):
    """``n`` synthetic 1024^2 samples through the SAM collater, on the
    card; the distillation CLIs pass its point and box prompts."""
    ds = FakeSAMSegmentationDataset(n, image_hw=SAM_IMAGE)
    batch = SAMBatchCollater(resize=SAM_IMAGE, rng=random.Random(0),
                             np_rng=np.random.RandomState(0))(
        [ds[i] for i in range(n)])
    return {k: torch.from_numpy(batch[k]).cuda()
            for k in ("image", "prompt_point", "prompt_box")}


def _matting_batch(collate, image_hw, n=SAM_BATCH):
    """``n`` synthetic portraits at ``image_hw``^2 (normalised) through
    ``collate``, on the card."""
    ds = FakeHumanMattingDataset(n, image_hw, transform=MattingNormalize())
    return {k: torch.from_numpy(v).cuda()
            for k, v in collate([ds[i] for i in range(n)]).items()}


def _launched_per_step(path, steps, per_step):
    """Fails unless the rel-pos kernels launched ``per_step`` times each per
    step over ``steps`` steps since the counts were set to 0, and no narrow
    variant; returns the counts."""
    launches = {k: fa.KERNEL_LAUNCHES[k] for k in SAM_KERNELS}
    want = {k: n * steps for k, n in per_step.items()}
    print(f"{path}: kernel launches {launches} over {steps} steps "
          f"({per_step} per step expected)", flush=True)
    if launches != want:
        raise RuntimeError(f"{path}: launched {launches}, expected {want}")
    _wide_kernels_only(f"the {path} path")
    return dict(fa.KERNEL_LAUNCHES)


def _slice16_train(card, path, label, model, loss_fn, batch, opt, sched,
                   per_step, warm_up=2, timed=6, epochs=100):
    """``warm_up`` + ``timed`` steps of ``loss_fn`` through
    ``make_train_step`` on a resident batch; prints ms a step, images/s,
    peak memory and the losses, checks the launches a step (``per_step``;
    None: no hand kernel), profiles one step for the idle share. Returns
    (the launches of the timed run, images per second, the state, the
    step, the profiled step's busy ms)."""
    state = _recipe_state(model, opt, sched, epochs, RECIPE_STEPS_PER_EPOCH)
    step = make_train_step(loss_fn, EngineConfig())
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _timed_steps(step, state, batch, warm_up, timed)
    launches = (_no_hand_kernel(path) if per_step is None else
                _launched_per_step(path, warm_up + timed, per_step))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n = batch["image"].shape[0]
    ips = n / step_ms * 1e3
    print(f"{path}: {label}, batch {n} [{card}]: {ips:.2f} images/s, "
          f"{step_ms:.2f} ms per step over {timed} steps, peak memory "
          f"{peak_gib:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    busy_ms = _profiled_step(card, label, step, state, batch, step_ms,
                             top=12)
    return launches, ips, state, step, busy_ms


def _teacher_unmoved(path, model, before):
    moved = [k for k, v in model.teacher.state_dict().items()
             if not torch.equal(v, before[k].to(v.device))]
    print(f"{path}: frozen teacher tensors moved: {len(moved)} of "
          f"{len(before)}", flush=True)
    if moved:
        raise RuntimeError(f"{path}: the frozen teacher moved: {moved[:4]}")


def phase_sam_distill_train(card):
    """Whole-SAM distillation, SAM-B -> SAM-B at 1024^2, batch 8 (the
    sa_1b/sam_b recipe's batch and AdamW, the teacher frozen by
    ``frozen_layer_name_list``), SAMDistillLoss on the point and box
    prompts, through the CLI's loss function. 8/4/4 launches of K4/K5/K6 a
    step. Returns (the launches, images per second)."""
    t0 = time.perf_counter()
    model = init_params(
        SAMDistillModel(MODELS.create("sam_b"), MODELS.create("sam_b")),
        torch.Generator().manual_seed(0))
    batch = _sam_distill_batch()
    print(f"SAMDistillModel(sam_b, sam_b) 1024^2 and a resident batch of "
          f"{SAM_BATCH} built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    teacher = {k: v.clone() for k, v in model.teacher.state_dict().items()}
    launches, ips, state, _, _ = _slice16_train(
        card, "sam_distill_train",
        f"SAM-B -> SAM-B distillation {SAM_IMAGE}^2 bf16",
        model, sam_distill_cli.make_loss_fn(LOSSES.create("SAMDistillLoss")),
        batch, SAM_RECIPE_OPT, SAM_RECIPE_SCHED, DISTILL_STEP_LAUNCHES)
    _teacher_unmoved("sam_distill_train", model, teacher)
    del state, model, batch, teacher
    torch.cuda.empty_cache()
    return launches, ips


def phase_sam_encoder_distill_train(card):
    """Encoder distillation, SAM-B -> SAM-B at 1024^2, batch 8 (the
    sa_1b_multi_node recipe's fields with SAM-B on both sides: its
    ConvFormer-M36 student waits for its backbone), SAMDistillMSELoss of the
    embeddings, the teacher frozen, through the CLI's loss function. 8/4/4
    launches a step. Returns (the launches, images per second)."""
    t0 = time.perf_counter()
    model = init_params(SAMDistillEncoderModel(MODELS.create("sam_b"),
                                               MODELS.create("sam_b")),
                        torch.Generator().manual_seed(0))
    batch = _sam_distill_batch()
    print(f"SAMDistillEncoderModel(sam_b, sam_b) 1024^2 "
          f"({sum(p.numel() for p in model.parameters())} parameters: the "
          f"two image encoders) and a resident batch of {SAM_BATCH} built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    teacher = {k: v.clone() for k, v in model.teacher.state_dict().items()}
    launches, ips, state, _, _ = _slice16_train(
        card, "sam_encoder_distill_train",
        f"SAM-B -> SAM-B encoder distillation {SAM_IMAGE}^2 bf16", model,
        sam_encoder_distill_cli.make_loss_fn(
            LOSSES.create("SAMDistillMSELoss")), batch, SAM_RECIPE_OPT,
        SAM_RECIPE_SCHED, DISTILL_STEP_LAUNCHES)
    _teacher_unmoved("sam_encoder_distill_train", model, teacher)
    del state, model, batch, teacher
    torch.cuda.empty_cache()
    return launches, ips


def phase_sam_matting_train(card):
    """sam_b_matting1 at 1024^2, batch 8 (cut from 16), with
    human_matting/convformer_m36_sam_matting1's SAMMattingOneLevelLoss (unit
    weights, mask_threshold 0.5), AdamW and CosineLR, through the matting
    CLI's loss function on the collater's point and box prompts: 4 launches
    of each rel-pos kernel a step. Then one checked step of sam_b_matting2
    with SAMMattingMultiLevelAssignLoss. Returns (the launches, images per
    second)."""
    t0 = time.perf_counter()
    model = init_params(MODELS.create("sam_b_matting1"),
                        torch.Generator().manual_seed(0))
    batch = _matting_batch(SAMMattingCollater(
        resize=SAM_IMAGE, rng=random.Random(0),
        np_rng=np.random.RandomState(0)), SAM_IMAGE)
    print(f"sam_b_matting1 1024^2 and a resident batch of {SAM_BATCH} "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, ips, state, _, _ = _slice16_train(
        card, "sam_matting_train", f"SAM-B matting1 {SAM_IMAGE}^2 bf16",
        model,
        sam_matting_cli.make_loss_fn(LOSSES.create(
            "SAMMattingOneLevelLoss", mask_threshold=0.5)), batch,
        MATTING_RECIPE_OPT, MATTING_RECIPE_SCHED, MATTING_STEP_LAUNCHES)
    del state, model
    torch.cuda.empty_cache()
    model = init_params(MODELS.create("sam_b_matting2"),
                        torch.Generator().manual_seed(0))
    state = _recipe_state(model, MATTING_RECIPE_OPT, MATTING_RECIPE_SCHED,
                          100, RECIPE_STEPS_PER_EPOCH)
    step = make_train_step(sam_matting_cli.make_loss_fn(LOSSES.create(
        "SAMMattingMultiLevelAssignLoss", mask_threshold=0.5)),
        EngineConfig())
    before = dict(fa.KERNEL_LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, seed=0)
    loss = metrics["loss"].item()
    ms = (time.perf_counter() - t0) * 1e3
    delta = {k: fa.KERNEL_LAUNCHES[k] - before[k] for k in SAM_KERNELS}
    print(f"sam_matting_train: one sam_b_matting2 step with "
          f"SAMMattingMultiLevelAssignLoss, batch {SAM_BATCH} [{card}]: loss "
          f"{loss:.4f}, skipped {float(metrics['skipped'])}, {ms:.1f} ms "
          f"(the first, with its allocations), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
          f"{delta}", flush=True)
    if not np.isfinite(loss) or float(metrics["skipped"]) != 0.0 \
            or delta != MATTING_STEP_LAUNCHES:
        raise RuntimeError("the sam_b_matting2 step failed its checks")
    _wide_kernels_only("the sam_b_matting2 step")
    for k, v in delta.items():
        launches[k] += v
    del state, model, step, batch
    torch.cuda.empty_cache()
    return launches, ips


def phase_pfan_matting_train(card):
    """resnet50_pfan_matting at 832^2, batch 8 (cut from 96), the
    human_matting/resnet50_pfan_matting recipe's seven-loss stack, AdamW and
    CosineLR on a resident batch; both BatchNorm kinds' calls of a step
    replayed alone for their share of the busy time. No hand kernel.
    Returns (the launches: none, images per second)."""
    t0 = time.perf_counter()
    model = init_params(MODELS.create("resnet50_pfan_matting"),
                        torch.Generator().manual_seed(0))
    batch = _matting_batch(HumanMattingCollater(PFAN_IMAGE), PFAN_IMAGE)
    criteria = {n: (1.0, LOSSES.create(n)) for n in MATTING_LOSSES}
    print(f"resnet50_pfan_matting {PFAN_IMAGE}^2 and a resident batch of "
          f"{SAM_BATCH} built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches, ips, state, step, busy_ms = _slice16_train(
        card, "pfan_matting_train", f"PFAN R50 matting {PFAN_IMAGE}^2 bf16",
        model, matting_task.make_loss_fn(criteria), batch,
        MATTING_RECIPE_OPT, MATTING_RECIPE_SCHED, None, timed=5)
    calls = _norm_calls(model, lambda: step(state, batch, seed=0))
    shares = _norm_replay_ms(calls)
    counts = {}
    for (kind, _, _), n in calls.items():
        counts[kind] = counts.get(kind, 0) + n
    for kind, ms in shares.items():
        print(f"  replayed alone: {counts[kind]} {kind} BatchNorm calls "
              f"(forward + backward) {ms:.3f} ms, "
              f"{100 * ms / busy_ms:.1f}% of a step's {busy_ms:.2f} ms busy "
              f"[{card}]", flush=True)
    _no_hand_kernel("pfan_matting_train")
    del state, model, step, batch
    torch.cuda.empty_cache()
    return launches, ips


SAM_MATTING_CLI_TRAIN_CONFIG = '''"""SAM-B matting as
experiments/13.interactive_segmentation_training/human_matting/
convformer_m36_sam_matting1/train_config.py states it, with the SAM-B
encoder (sam_b_matting1 at 1024^2, SAMMattingOneLevelLoss with unit weights
and mask_threshold 0.5, AdamW 1e-4 / 1e-3, CosineLR with a 1-epoch warm-up
and min_lr 1e-6), cut to: synthetic data, FakeHumanMattingDataset of 16
train and 8 test 1024^2 portraits (no matting sets here); batch 8 (not 16);
1 epoch (not 100); 8 loader workers (not 16); no flip."""

from {pkg}.core.registry import LOSSES, MODELS
from {pkg}.data.interactive_segmentation import SAMMattingCollater
from {pkg}.data.matting import FakeHumanMattingDataset, MattingNormalize


class config:
    network = "sam_b_matting1"
    input_image_size = 1024

    model = MODELS.create(network, image_size=input_image_size)
    train_criterion = LOSSES.create("SAMMattingOneLevelLoss",
                                    mask_threshold=0.5)

    train_dataset = FakeHumanMattingDataset(
        num_samples=16, image_hw=input_image_size,
        transform=MattingNormalize())
    test_dataset = FakeHumanMattingDataset(
        num_samples=8, image_hw=input_image_size, seed=1,
        transform=MattingNormalize())
    train_collater = SAMMattingCollater(resize=input_image_size)
    test_collater = SAMMattingCollater(resize=input_image_size,
                                       use_noise_bbox=False)

    seed = 0
    batch_size = 8
    num_workers = 8
    accumulation_steps = 1
    optimizer = ("AdamW", {{"lr": 1e-4, "global_weight_decay": False,
                           "weight_decay": 1e-3,
                           "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 1, "min_lr": 1e-6}})
    epochs = 1
    print_interval = 1
    use_ema_model = False
'''

SLICE_16_EXPERIMENTS = (
    ("13.interactive_segmentation_training/fake_synthetic/tiny_sam_distill",
     sam_distill_cli, None, True),
    ("13.interactive_segmentation_training/fake_synthetic/"
     "tiny_sam_encoder_distill", sam_encoder_distill_cli, None, True),
    ("13.interactive_segmentation_training/fake_synthetic/tiny_sam_matting",
     sam_matting_cli, sam_matting_test_cli, False),
    ("7.human_matting_training/fake_synthetic/resnet18_pfan_matting",
     human_matting_cli, human_matting_test_cli, True))


def phase_matting_cli(card, resident_ips):
    """The four fake_synthetic configs of slice 16 through the port's CLIs
    in this process (the tiny SAMs' 64^2 images give their global layer 16
    tokens, under the flash path's 128: no hand kernel, checked), then
    SAM-B matting 1024^2 through the SAM-matting train and test CLIs: 2
    steps, the epoch's evaluation and the test CLI's (one batch each), so
    4/2/2 x 4 launches of K4/K5/K6. Returns the launches of the SAM-B run."""
    for rel, train_cli, test_cli, evaluates in SLICE_16_EXPERIMENTS:
        _experiment_cli(card, "matting_cli", rel, train_cli, test_cli,
                        evaluates=evaluates)
    launches = _cli_in_process(card, "matting_cli", sam_matting_cli,
                               sam_matting_test_cli,
                               SAM_MATTING_CLI_TRAIN_CONFIG, resident_ips,
                               SAM_KERNELS)
    want = {"flash_attention_relpos_fwd": 16,
            "flash_attention_relpos_dq": 8, "flash_attention_relpos_dkv": 8}
    if {k: launches[k] for k in SAM_KERNELS} != want:
        raise RuntimeError(f"matting_cli: launched "
                           f"{ {k: launches[k] for k in SAM_KERNELS} }, "
                           f"expected {want}")
    return launches


def _slice_16(card):
    """The phases of slice 16: {path: launches}."""
    paths = {}
    paths["sam_distill_train"], _ = phase_sam_distill_train(card)
    paths["sam_encoder_distill_train"], _ = \
        phase_sam_encoder_distill_train(card)
    paths["sam_matting_train"], matting_ips = phase_sam_matting_train(card)
    paths["pfan_matting_train"], _ = phase_pfan_matting_train(card)
    paths["matting_cli"] = phase_matting_cli(card, matting_ips)
    return paths


# ---------------------------------------------------------------- slice 17

# coco/res50_solov2 and coco/res50_yolact: resnet50 at 1024^2, 80 classes
# (YOLACT's head 81 with the background), AdamW 1e-4 / 1e-3, MultiStepLR
# (SOLOv2: a half-epoch warm-up, [24, 33] of 39 epochs; YOLACT: 1 epoch,
# [24, 36] of 39); COCO's 117,266 training images at the recipe's batch
# make the epoch's steps. The batches tried in turn: the recipe's, then
# halves, until one fits
INST_IMAGE, INST_CLASSES = 1024, 80
INST_RECIPE_OPT = SEG_RECIPE_OPT
SOLO_RECIPE_SCHED = ("MultiStepLR", {"warm_up_epochs": 0.5, "gamma": 0.1,
                                     "milestones": [24, 33]})
YOLACT_RECIPE_SCHED = ("MultiStepLR", {"warm_up_epochs": 1, "gamma": 0.1,
                                       "milestones": [24, 36]})
INST_EPOCHS = 39
SOLO_BATCHES = (16, 8, 4, 2)
YOLACT_BATCHES = (64, 32, 16, 8)
# celebahq/ddpm_64: the UNet at planes 128, (1, 2, 2, 2), attention at
# index 1, DDPMTrainer(t=1000), MSE, AdamW 2e-4 without decay, CosineLR
# with a 1-epoch warm-up over 500 epochs, batch 64 (the recipe's), f32;
# CelebA-HQ's 30,000 images make 468 steps an epoch
DDPM_BATCH, DDPM_IMAGE = 64, 64
DDPM_UNET = dict(inplanes=3, planes=128, planes_multi=(1, 2, 2, 2),
                 use_attention_planes_multi_idx=(1,))
DDPM_RECIPE_OPT = ("AdamW", {"lr": 2e-4, "global_weight_decay": False,
                             "weight_decay": 0.0,
                             "no_weight_decay_layer_name_list": []})
DDPM_RECIPE_SCHED = ("CosineLR", {"warm_up_epochs": 1})
DDPM_EPOCHS, DDPM_STEPS_PER_EPOCH = 500, 30000 // 64
# the 1000-step DDPM run's batch, cut from 16 to make room for the HTTP
# phase (it took 70.9 s at 16, a step's time nearly proportional); the
# 50-step DDIM run keeps 16, whose samples feed the FID and IS (10 splits)
DDPM_SAMPLE_IMAGES = 4
SAMPLE_IMAGES = 16


def _no_launch_at_all(path):
    """Fails if any hand kernel or narrow variant was launched since the
    counts were last set to 0 (the slice-17 paths run none)."""
    _wide_kernels_only(f"the {path} path")
    return _no_hand_kernel(path)


def _inst_batch(collater, n, image=INST_IMAGE, classes=INST_CLASSES):
    """A resident batch of ``n`` synthetic images (1 to 3 rectangles with
    masks) through the recipe's resize, normalisation and ``collater``,
    on the card."""
    ds = FakeInstanceSegmentationDataset(n, image, classes, transform=Compose(
        [InstanceSegmentationResize(image), InstanceNormalize()]))
    batch = collater(image)([ds[i] for i in range(n)])
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _inst_loss_replay_ms(criterion, preds, annots, masks):
    """Device ms of the criterion alone (assignment, forward and backward)
    on the step's predictions."""
    leaves, shapes = [], []
    for p in preds:
        group = list(p) if isinstance(p, (list, tuple)) else [p]
        shapes.append(len(group) if isinstance(p, (list, tuple)) else None)
        leaves.extend(t.detach() for t in group)

    def loss(*tensors):
        out, i = [], 0
        for n in shapes:
            out.append(tensors[i] if n is None else list(tensors[i:i + n]))
            i += 1 if n is None else n
        return sum(criterion(out, annots, masks).values())

    return _fwd_bwd_ms(loss, *leaves)


def _largest_batch_that_fits(path, batches, make_batch, build, warm_up,
                             timed):
    """Tries the recipe's batch and then each cut of ``batches`` in turn:
    builds the model and state (``build``) and takes ``warm_up`` +
    ``timed`` steps; a batch whose step runs out of device memory is cut,
    and printed so. Returns (batch size, the built model, criterion, state,
    step, batch, ms a step, losses); fails if none fits."""
    import gc
    for n in batches:
        built = []
        try:
            built.append(make_batch(n))
            built.extend(build())
            _reset_launches()
            torch.cuda.reset_peak_memory_stats()
            step_ms, losses = _timed_steps(built[4], built[3], built[0],
                                           warm_up, timed)
            batch, model, criterion, state, step = built
            return n, model, criterion, state, step, batch, step_ms, losses
        except torch.cuda.OutOfMemoryError:
            pass
        # out of the handler, so that its traceback no longer holds the
        # failed step's tensors
        built.clear()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{path}: batch {n} does not fit on the card (out of memory); "
              f"cut", flush=True)
    raise RuntimeError(f"{path}: no batch of {batches} fits")


def _inst_train(card, path, network, classes, loss_name, loss_kw, collater,
                batches, sched, warm_up=2, timed=5):
    """An instance segmenter at 1024^2 through ``make_train_step`` on a
    resident batch, the recipe's batch or the largest cut that fits:
    images/s, ms a step, peak memory, a profiled step and the loss's share
    replayed alone. Returns (the launches: none, images per second)."""
    t0 = time.perf_counter()

    def build():
        model = init_params(MODELS.create(network, num_classes=classes),
                            torch.Generator().manual_seed(0))
        state = _recipe_state(model, INST_RECIPE_OPT, sched, INST_EPOCHS,
                              117266 // batches[0])
        criterion = LOSSES.create(loss_name, **loss_kw)
        return model, criterion, state, make_train_step(
            inst_task.make_loss_fn(criterion), EngineConfig())

    n, model, criterion, state, step, batch, step_ms, losses = \
        _largest_batch_that_fits(path, batches,
                                 lambda n: _inst_batch(collater, n), build,
                                 warm_up, timed)
    launches = _no_launch_at_all(path)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ips = n / step_ms * 1e3
    cut = "the recipe's" if n == batches[0] else f"cut from {batches[0]}"
    print(f"{path}: {network} {INST_IMAGE}^2 bf16 training, batch {n} "
          f"({cut}) [{card}]: {ips:.2f} images/s, {step_ms:.2f} ms per step "
          f"over {timed} steps, peak memory {peak_gib:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)} (set-up and the batch "
          f"search {time.perf_counter() - t0:.1f} s)", flush=True)
    busy_ms = _profiled_step(card, network, step, state, batch, step_ms,
                             top=12)
    with torch.no_grad():
        preds = model(batch["image"], train=True)
    ms = _inst_loss_replay_ms(criterion, preds, batch["annots"],
                              batch["gt_masks"])
    print(f"  replayed {loss_name} alone ({batch['annots'].shape[1]} "
          f"annotation slots, forward + backward): {ms:.3f} ms, "
          f"{100 * ms / busy_ms:.1f}% of the step's busy time [{card}]",
          flush=True)
    _no_launch_at_all(path)
    del state, model, step, preds, batch
    torch.cuda.empty_cache()
    return launches, ips


def phase_solov2_train(card):
    """SOLOv2 R50 at coco/res50_solov2's fields (1024^2, 80 classes,
    SOLOV2Loss, AdamW, MultiStepLR), batch 16 or the largest cut that
    fits."""
    return _inst_train(card, "solov2_train", "resnet50_solov2", INST_CLASSES,
                       "SOLOV2Loss", {}, SOLOV2InstanceSegmentationCollater,
                       SOLO_BATCHES, SOLO_RECIPE_SCHED)


def phase_yolact_train(card):
    """YOLACT R50 at coco/res50_yolact's fields (1024^2, 81 classes with the
    background, 65,472 anchors, YOLACTLoss, AdamW, MultiStepLR), batch 64
    or the largest cut that fits."""
    return _inst_train(card, "yolact_train", "resnet50_yolact",
                       INST_CLASSES + 1, "YOLACTLoss",
                       {"resize": INST_IMAGE},
                       YOLACTInstanceSegmentationCollater, YOLACT_BATCHES,
                       YOLACT_RECIPE_SCHED)


def _decoded_agree(label, got, want):
    """Prints and checks a decoder's output on the card against the CPU's
    on the same predictions: the labels equal, the scores within 1e-5
    relative, at most 1e-5 of the kept masks' pixels apart (a pixel whose
    value lies within f32 rounding of the 0.5 threshold may fall either
    side: the two devices sum the products in other orders)."""
    (gm, gl, gs), (wm, wl, ws) = got, want
    kept = ws > 0
    differ = int((gm != wm).sum())
    pixels = int(kept.sum()) * wm.shape[-1] * wm.shape[-2]
    same = (np.array_equal(gl, wl)
            and np.allclose(gs, ws, rtol=1e-5, atol=0)
            and differ <= 1e-5 * max(pixels, 1))
    print(f"inst_parity: {label} on the card vs the CPU on the same "
          f"predictions: {int(kept.sum())} instances, labels equal "
          f"{np.array_equal(gl, wl)}, largest score difference "
          f"{np.abs(gs - ws).max():.3e}, {differ} of {pixels} kept mask "
          f"pixels apart", flush=True)
    if not same or not kept.any():
        raise RuntimeError(f"the {label} on the card disagrees with the CPU")


def phase_inst_parity(card):
    """One f32 SOLOv2 R50 train step at 256^2, batch 2, on the card (TF32
    off) against the CPU, and both decoders on the card against the CPU on
    the same seeded predictions at R50's 256^2 shapes. Returns the
    launches (none)."""
    _reset_launches()
    batch = _inst_batch(SOLOV2InstanceSegmentationCollater, 2, 256)
    batch = {k: v.cpu() for k, v in batch.items()}
    # train-mode BatchNorm at batch 2 spreads each rounding switch over its
    # channel, as in dense_parity's FCOS step: L2 and cosine bounds
    _parity(card, "resnet50_solov2 256^2, batch 2",
            lambda: init_params(MODELS.create(
                "resnet50_solov2", num_classes=INST_CLASSES,
                dtype=torch.float32), torch.Generator().manual_seed(3)),
            inst_task.make_loss_fn(LOSSES.create("SOLOV2Loss")), batch,
            loss_rel=1e-3, grad_rel=5e-2, grad_cos=0.99, path="inst_parity")
    g = torch.Generator().manual_seed(5)
    grids = (40, 36, 24, 16, 12)
    # integer mask features and kernels in {-1, 0, 1} plus half of a
    # constant channel: every mask logit is an integer plus 0.5, exact in
    # any order of summation, so no mask pixel lies at the threshold and
    # both devices keep the same masks before the x4 resize
    feat = torch.randint(-3, 4, (2, 64, 64, 256), generator=g).float()
    feat[..., 0] = 1.0
    kernels = []
    for s in grids:
        k = (torch.rand(2, s, s, 256, generator=g) < 0.05).float() * (
            torch.randint(0, 2, (2, s, s, 256), generator=g) * 2 - 1)
        k[..., 0] = 0.5
        kernels.append(k)
    solo = (feat, kernels,
            [torch.randn(2, s, s, INST_CLASSES, generator=g) * 2 - 3
             for s in grids])
    decoder = DECODERS.create("SOLOV2Decoder")
    want = decoder(solo)
    got = decoder((solo[0].cuda(), [t.cuda() for t in solo[1]],
                   [t.cuda() for t in solo[2]]))
    _decoded_agree("SOLOV2Decoder", got, want)
    levels = [256 // s for s in (8, 16, 32, 64, 128)]
    yolact = ([torch.randn(2, h, h, 3, INST_CLASSES + 1, generator=g) * 2
               for h in levels],
              [torch.randn(2, h, h, 3, 4, generator=g) * 0.5 for h in levels],
              [torch.tanh(torch.randn(2, h, h, 3, 32, generator=g))
               for h in levels],
              torch.relu(torch.randn(2, 64, 64, 32, generator=g)))
    decoder = DECODERS.create("YOLACTDecoder", resize=256)
    want = decoder(yolact)
    got = decoder(([t.cuda() for t in yolact[0]],
                   [t.cuda() for t in yolact[1]],
                   [t.cuda() for t in yolact[2]], yolact[3].cuda()))
    _decoded_agree("YOLACTDecoder", got, want)
    return _no_launch_at_all("inst_parity")


def phase_inst_cli(card):
    """fake_synthetic/resnet18_solov2 and resnet18_yolact through the
    instance-segmentation train and test CLIs, in this process."""
    launches = {}
    for rel in ("5.instance_segmentation_training/fake_synthetic/"
                "resnet18_solov2",
                "5.instance_segmentation_training/fake_synthetic/"
                "resnet18_yolact"):
        launches.update(_experiment_cli(card, "inst_cli", rel,
                                        inst_train_cli, inst_test_cli))
    _wide_kernels_only("the inst_cli path")
    return launches


def phase_ddpm_train(card, warm_up=2, timed=6):
    """The celebahq/ddpm_64 UNet at 64^2, batch 64, f32 through
    ``make_train_step`` on a resident batch (synthetic images in [-1, 1]);
    then the full 1000-step DDPM sampler on 4 images, a 50-step DDIM
    sampler on 16, and the InceptionV3 features of its 16 samples at 299^2 with
    the FID and IS arithmetic on seeded weights (their value means nothing
    without the pretrained weights; the time is the reading). Returns (the
    launches: none, images per second)."""
    t0 = time.perf_counter()
    model = init_params(MODELS.create("DiffusionUNet", **DDPM_UNET),
                        torch.Generator().manual_seed(0))
    trainer = DDPMTrainer(t=1000)
    state = _recipe_state(model, DDPM_RECIPE_OPT, DDPM_RECIPE_SCHED,
                          DDPM_EPOCHS, DDPM_STEPS_PER_EPOCH)
    step = make_train_step(diff_task.make_loss_fn(diff_task.MSELoss(),
                                                  trainer), EngineConfig())
    ds = FakeClassificationDataset(DDPM_BATCH, DDPM_IMAGE, 10)
    images = np.stack([ds[i]["image"] for i in range(DDPM_BATCH)])
    batch = {"image": torch.from_numpy(images / 127.5 - 1.0).float().cuda()}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"DiffusionUNet 128 (1, 2, 2, 2) {DDPM_IMAGE}^2 f32 ({n_params} "
          f"parameters), its AdamW state and a resident batch of "
          f"{DDPM_BATCH} built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = _timed_steps(step, state, batch, warm_up, timed)
    launches = _no_launch_at_all("ddpm_train")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ips = DDPM_BATCH / step_ms * 1e3
    print(f"ddpm_train: DiffusionUNet {DDPM_IMAGE}^2 f32 training (TF32 "
          f"off), batch {DDPM_BATCH} (the recipe's) [{card}]: {ips:.2f} "
          f"images/s, {step_ms:.2f} ms per step over {timed} steps, peak "
          f"memory {peak_gib:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    _profiled_step(card, "DiffusionUNet", step, state, batch, step_ms,
                   top=12)
    samples, seconds = None, {}
    for name, sampler, n in (
            ("DDPM, 1000 steps", DDPMSampler(t=1000), DDPM_SAMPLE_IMAGES),
            ("DDIM, 50 steps", DDIMSampler(ddpm_t=1000, ddim_t=50),
             SAMPLE_IMAGES)):
        shape = (n, DDPM_IMAGE, DDPM_IMAGE, 3)
        generate = diff_task.make_generate_fn(model, sampler, shape,
                                              device="cuda")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        s = seconds[name] = time.perf_counter() - t0
        print(f"ddpm_train: {name} on {n} images [{card}]: "
              f"{s:.2f} s, {1e3 * s / n:.1f} ms an image, peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"samples finite {bool(torch.isfinite(out).all())}, in "
              f"[{out.min().item():.3f}, {out.max().item():.3f}]",
              flush=True)
        if not torch.isfinite(out).all() or tuple(out.shape) != shape:
            raise RuntimeError(f"ddpm_train: the {name} sampler gave "
                               f"{tuple(out.shape)}, finite "
                               f"{bool(torch.isfinite(out).all())}")
        samples = out  # the DDIM run's, for the FID and IS
    model.eval()
    x = torch.randn((DDPM_SAMPLE_IMAGES, DDPM_IMAGE, DDPM_IMAGE, 3),
                    device="cuda")
    t = torch.full((DDPM_SAMPLE_IMAGES,), 500, dtype=torch.int64,
                   device="cuda")
    with torch.no_grad():
        busy_ms, events = _profile_device(lambda: model(x, t, None, False))
    print(f"ddpm_train: one sampler step's UNet forward at batch "
          f"{DDPM_SAMPLE_IMAGES}, profiled: device busy {busy_ms:.2f} ms, "
          f"beside "
          f"{1e3 * seconds['DDPM, 1000 steps'] / 1000:.4f} ms a step of "
          f"the 1000-step run "
          f"[{card}]", flush=True)
    _print_rows(events, busy_ms, 8)
    fake = ((samples.clamp(-1, 1) + 1) / 2).cpu().numpy()
    real = ((batch["image"][:SAMPLE_IMAGES] + 1) / 2).cpu().numpy()
    t0 = time.perf_counter()
    feature_fn = fid_is.make_inception_feature_fn(device="cuda")
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fake_feats, fake_probs = feature_fn(fake)
    real_feats, _ = feature_fn(real)
    feats_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid = fid_is.compute_fid(real_feats, fake_feats)
    is_mean, is_std = fid_is.compute_inception_score(fake_probs)
    arith_s = time.perf_counter() - t0
    print(f"ddpm_train: InceptionV3 (FID variant, seeded weights: the "
          f"values measure nothing) built in {build_s:.2f} s; features of "
          f"2 x {SAMPLE_IMAGES} images at 299^2 {1e3 * feats_s:.1f} ms; "
          f"the FID (2048^2 square root) and IS on the host "
          f"{arith_s:.2f} s [{card}]; FID {fid:.6e}, IS {is_mean:.6f}",
          flush=True)
    if not (np.isfinite(fid) and np.isfinite(is_mean)
            and fake_feats.shape == (SAMPLE_IMAGES, 2048)):
        raise RuntimeError("ddpm_train: the FID path gave no finite value")
    _no_launch_at_all("ddpm_train")
    del state, model, step, batch, samples
    torch.cuda.empty_cache()
    return launches, ips


def phase_diffusion_cli(card):
    """fake_synthetic/tiny_ddpm through the diffusion train and test CLIs
    in this process; reads back the sample grid and the 16 generated PNGs
    and checks their shapes."""
    import os
    import shutil
    import tempfile
    from simpleaicv_tpu_torch.core.png import read_png
    rel = "20.diffusion_model_training/fake_synthetic/tiny_ddpm"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "experiments", rel)
    with tempfile.TemporaryDirectory() as work_dir:
        for name in os.listdir(src):
            if name.endswith(".py"):
                shutil.copy(os.path.join(src, name), work_dir)
        test_path = os.path.join(work_dir, "test_config.py")
        with open(test_path) as f:
            text = f.read()
        with open(test_path, "w") as f:
            f.write(text.replace('trained_model_path = ""',
                                 "trained_model_path = os.path.join(os.path."
                                 "dirname(os.path.abspath(__file__)), "
                                 "\"checkpoints\", \"best\")"))
        argv = ["--work-dir", work_dir]
        _reset_launches()
        t0 = time.perf_counter()
        best = diffusion_train_cli.main(argv)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = diffusion_test_cli.main(argv)
        test_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _no_launch_at_all("diffusion_cli")
        grid = read_png(os.path.join(work_dir, "samples", "grid_0001.png"))
        generated = [read_png(os.path.join(work_dir, "generated",
                                           f"{i}.png"))
                     for i in range(stats["generated"])]
    print(f"diffusion_cli: {rel}: train CLI {train_s:.1f} s (best "
          f"{best:.6f}, minus the loss), test CLI {test_s:.1f} s [{card}]; "
          f"sample grid {grid.shape}, {len(generated)} generated PNGs of "
          f"{sorted({g.shape for g in generated})}", flush=True)
    if (grid.shape != (32, 32, 3) or len(generated) != 16
            or any(g.shape != (16, 16, 3) for g in generated)
            or not np.isfinite(best)):
        raise RuntimeError("diffusion_cli: the PNGs have other shapes than "
                           "the config's")
    return launches


def phase_ddpm_learns(card, draws=10):
    """``tests/test_torch_convergence.py``'s DDPM recipe on the card (the
    tiny UNet, 64 two-mode 16^2 images, cosine schedule at T=100, 90
    epochs), then the JAX test's statistic on 64 DDPM samples (the
    generator seeded with 123) and on ``draws`` such draws (seeds 123,
    124, ...): fails unless both modes hold 0.15 of the first draw's
    samples, the JAX test's bound. The first draw's mean distance to the
    nearer mode is printed beside the JAX test's 0.33, with the mean over
    the draws, and is not a gate: the recipe's expected distance sits at
    that bound in both packages (over 640 samples: 0.3285 for a
    JAX-trained model, 0.3263 to 0.3317 for four port-trained ones on the
    CPU), so one 64-sample draw (spread 0.03) meets it about half the
    time in either, and the card's draws are fixed by their seeds."""
    import importlib.util
    import os
    import tempfile
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_convergence.py")
    spec = importlib.util.spec_from_file_location("test_torch_convergence",
                                                  path)
    convergence = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(convergence)
    _reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work_dir:
        generate = convergence.train_ddpm(work_dir, "cuda")
    train_s = time.perf_counter() - t0
    stats = [convergence.two_mode_stats(generate(
        torch.Generator("cuda").manual_seed(123 + k))) for k in range(draws)]
    launches = _no_launch_at_all("ddpm_learns")
    hi, lo, near = stats[0]
    nears = [float(st[2].mean()) for st in stats]
    print(f"ddpm_learns: tiny DDPM 16^2, 90 epochs in {train_s:.1f} s "
          f"[{card}]: 64 samples (seed 123): share above 0.3 {hi:.4f}, "
          f"below -0.3 {lo:.4f} (0.15 each required), mean distance to the "
          f"nearer mode {nears[0]:.4f} (the JAX test's bound 0.33; not a "
          f"gate, see the phase's note); over {draws} draws of 64: shares "
          f"{np.mean([st[0] for st in stats]):.4f} and "
          f"{np.mean([st[1] for st in stats]):.4f}, distance "
          f"{np.mean(nears):.4f} (draws from {min(nears):.4f} to "
          f"{max(nears):.4f})", flush=True)
    if not (hi >= 0.15 and lo >= 0.15):
        raise RuntimeError(f"the DDPM did not learn both modes: {hi}, {lo}")
    return launches


def _slice_17(card):
    """The phases of slice 17: {path: launches}; none launches a hand
    kernel."""
    t0 = time.perf_counter()
    paths = {}
    paths["solov2_train"], _ = phase_solov2_train(card)
    paths["yolact_train"], _ = phase_yolact_train(card)
    paths["inst_parity"] = phase_inst_parity(card)
    paths["inst_cli"] = phase_inst_cli(card)
    paths["ddpm_train"], _ = phase_ddpm_train(card)
    paths["diffusion_cli"] = phase_diffusion_cli(card)
    paths["ddpm_learns"] = phase_ddpm_learns(card)
    print(f"slice 17: seven phases in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    return paths


# ---- slice 18: OCR text detection and recognition --------------------------

# combined/convformerm36_dbnet's fields with the R50 trunk in place of
# ConvFormer-M36 (item 4b): 1024^2, DBNetLoss, AdamW 1e-4 / 1e-3, PolyLR
# power 0.9 after a 1-epoch warm-up over 100 epochs, batch 16 (cut to what
# fits); the five real sets are not here, so the steps of an epoch are a
# nominal 1000
DBNET_IMAGE = 1024
DBNET_BATCHES = (16, 8, 4)
DBNET_RECIPE_OPT = ("AdamW", {"lr": 1e-4, "global_weight_decay": False,
                              "weight_decay": 1e-3,
                              "no_weight_decay_layer_name_list": []})
DBNET_RECIPE_SCHED = ("PolyLR", {"warm_up_epochs": 1, "power": 0.9})
DBNET_EPOCHS, OCR_STEPS_PER_EPOCH = 100, 1000
# combined/convformerm36_ctc's fields with the OCR R50 trunk: 32 x 512
# canvases, str_max_length 80 (T = 64), the reference's 12,111 characters
# and the blank, TransformerEncoder, predictor 512, CTCLoss, AdamW 1e-4 /
# 1e-4, CosineLR after a 1-epoch warm-up over 50 epochs, batch 512
CTC_BATCHES = (512, 256, 128)
CTC_MAX_W, CTC_STR_MAX = 512, 80
CTC_RECIPE_OPT = ("AdamW", {"lr": 1e-4, "global_weight_decay": False,
                            "weight_decay": 1e-4,
                            "no_weight_decay_layer_name_list": []})
CTC_RECIPE_SCHED = ("CosineLR", {"warm_up_epochs": 1, "min_lr": 1e-6})
CTC_EPOCHS = 50
# samples of the CTC batch given 80-character labels, more than T = 64
# steps can align: the loss's mask must give them 0
CTC_LONG_LABELS = 4


def _ocr_train(card, path, network, batches, make_batch, build, loss_name,
               replay, host_ms, warm_up=2, timed=5):
    """An OCR model through ``make_train_step`` on a resident batch, the
    recipe's batch or the largest cut that fits: images/s, ms a step, peak
    memory, a profiled step and its top rows, the loss replayed alone
    (``replay(criterion, preds, batch)`` prints its parts and returns its
    ms) and the host data's ms a sample. Returns (the launches: none,
    images per second)."""
    t0 = time.perf_counter()
    n, model, criterion, state, step, batch, step_ms, losses = \
        _largest_batch_that_fits(path, batches, make_batch, build, warm_up,
                                 timed)
    launches = _no_launch_at_all(path)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ips = n / step_ms * 1e3
    cut = "the recipe's" if n == batches[0] else f"cut from {batches[0]}"
    print(f"{path}: {network} bf16 training, batch {n} ({cut}) [{card}]: "
          f"{ips:.2f} images/s, {step_ms:.2f} ms per step over {timed} "
          f"steps, peak memory {peak_gib:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)} (set-up and the batch "
          f"search {time.perf_counter() - t0:.1f} s)", flush=True)
    busy_ms = _profiled_step(card, network, step, state, batch, step_ms,
                             top=12)
    with torch.no_grad():
        preds = model(batch["image"], train=True)
    ms = replay(criterion, preds, batch)
    print(f"  replayed {loss_name} alone (forward + backward): {ms:.3f} ms, "
          f"{100 * ms / busy_ms:.1f}% of the step's busy time; the host "
          f"data {host_ms:.1f} ms a sample, {host_ms * n:.0f} ms a batch "
          f"beside the {step_ms:.2f} ms step [{card}]", flush=True)
    _no_launch_at_all(path)
    del state, model, step, preds, batch
    torch.cuda.empty_cache()
    return launches, ips


def phase_dbnet_train(card):
    """resnet50_dbnet at 1024^2 (combined/convformerm36_dbnet's fields,
    the R50 trunk) on resident batches from the port's
    ``FakeTextDetectionDataset``, ``DBNetMapGenerator`` and
    ``TextDetectionCollater``, made on the host once (the generator's ms a
    1024^2 sample printed); the loss replayed alone with its OHEM sort."""
    t0 = time.perf_counter()
    ds = FakeTextDetectionDataset(DBNET_BATCHES[0], image_hw=DBNET_IMAGE)
    samples = [ds[i] for i in range(DBNET_BATCHES[0])]
    gen_s = time.perf_counter() - t0
    host_ms = 1e3 * gen_s / len(samples)
    host = TextDetectionCollater(DBNET_IMAGE)(samples)
    print(f"dbnet_train: {len(samples)} synthetic {DBNET_IMAGE}^2 samples "
          f"with their DB maps on the host in {gen_s:.2f} s "
          f"({host_ms:.1f} ms a sample, the map generator included) "
          f"[{card}]", flush=True)

    def make_batch(n):
        return {k: torch.from_numpy(host[k][:n]).cuda()
                for k in ("image",) + text_det_task.MAP_KEYS}

    def build():
        model = init_params(MODELS.create("resnet50_dbnet"),
                            torch.Generator().manual_seed(0))
        state = _recipe_state(model, DBNET_RECIPE_OPT, DBNET_RECIPE_SCHED,
                              DBNET_EPOCHS, OCR_STEPS_PER_EPOCH)
        criterion = LOSSES.create("DBNetLoss")
        return model, criterion, state, make_train_step(
            text_det_task.make_loss_fn(criterion), EngineConfig())

    def replay(criterion, preds, batch):
        maps = {k: batch[k] for k in text_det_task.MAP_KEYS}
        ms = _fwd_bwd_ms(lambda p: sum(criterion(p, maps).values()),
                         preds.float())
        flat = torch.rand(preds[..., 0].numel(), device="cuda")
        sort_ms = _cuda_ms(lambda: torch.sort(flat, descending=True), 10)
        print(f"  DBNetLoss's OHEM sort alone: {flat.numel()} f32, "
              f"{sort_ms:.3f} ms a sort [{card}]", flush=True)
        return ms

    return _ocr_train(card, "dbnet_train", "resnet50_dbnet 1024^2",
                      DBNET_BATCHES, make_batch, build, "DBNetLoss", replay,
                      host_ms)


def phase_ctc_train(card):
    """CTCModel (the OCR R50 trunk, TransformerEncoder, predictor 512,
    12,112 classes) at 32 x 512 (combined/convformerm36_ctc's fields, the
    R50 trunk) on resident batches from the port's
    ``FakeTextRecognitionDataset`` and
    ``KeepRatioResizeTextRecognitionCollater``; 4 samples carry
    80-character labels that T = 64 steps cannot align, and the replayed
    loss checks that they add 0."""
    converter = CTCTextLabelConverter("reference",
                                      str_max_length=CTC_STR_MAX)
    t0 = time.perf_counter()
    ds = FakeTextRecognitionDataset(CTC_BATCHES[0])
    host = KeepRatioResizeTextRecognitionCollater(
        converter, 32, CTC_MAX_W)([ds[i] for i in range(CTC_BATCHES[0])])
    host_ms = 1e3 * (time.perf_counter() - t0) / CTC_BATCHES[0]
    rng = np.random.RandomState(0)
    long = rng.randint(1, 11, (CTC_LONG_LABELS, CTC_STR_MAX))
    host["targets"][:CTC_LONG_LABELS] = long
    host["target_lengths"][:CTC_LONG_LABELS] = CTC_STR_MAX
    print(f"ctc_train: {CTC_BATCHES[0]} synthetic 32 x {CTC_MAX_W} samples "
          f"on the host ({host_ms:.2f} ms a sample), {converter.num_classes} "
          f"classes, {CTC_LONG_LABELS} labels of {CTC_STR_MAX} characters "
          f"[{card}]", flush=True)

    def make_batch(n):
        return {k: torch.from_numpy(host[k][:n]).cuda()
                for k in ("image", "targets", "target_lengths")}

    def build():
        model = init_params(CTCModel(
            backbone_type="resnet50", encoder_type="TransformerEncoder",
            predictor_hidden_planes=512, num_classes=converter.num_classes),
            torch.Generator().manual_seed(0))
        state = _recipe_state(model, CTC_RECIPE_OPT, CTC_RECIPE_SCHED,
                              CTC_EPOCHS, OCR_STEPS_PER_EPOCH)
        criterion = LOSSES.create("CTCLoss")
        return model, criterion, state, make_train_step(
            text_rec_task.make_loss_fn(criterion), EngineConfig())

    def replay(criterion, preds, batch):
        t, l = batch["targets"], batch["target_lengths"]
        ms = _fwd_bwd_ms(lambda p: criterion(p, t, l), preds)
        k = CTC_LONG_LABELS
        long_loss = criterion(preds[:k], t[:k], l[:k]).item()
        rest = criterion(preds[k:], t[k:], l[k:]).item()
        print(f"  CTCLoss on the {k} unalignable labels: {long_loss} (0 "
              f"required), on the others {rest:.4f}; logits "
              f"{tuple(preds.shape)} [{card}]", flush=True)
        if long_loss != 0.0 or not np.isfinite(rest) or rest <= 0:
            raise RuntimeError("ctc_train: the CTC mask did not give the "
                               "unalignable labels 0")
        return ms

    return _ocr_train(card, "ctc_train",
                      "CTCModel R50 + TransformerEncoder 32 x 512",
                      CTC_BATCHES, make_batch, build, "CTCLoss", replay,
                      host_ms)


def _convergence_module():
    """``tests/test_torch_convergence.py``, by its path (the card's machine
    may have a package named ``tests``)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_convergence.py")
    spec = importlib.util.spec_from_file_location("test_torch_convergence",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_dbnet_learns(card):
    """``tests/test_torch_convergence.py``'s DBNet recipe on the card
    (resnet18_dbnet, 32 synthetic 128^2 images, 20 epochs, AdamW 1e-3):
    fails unless the best polygon F1 reaches the JAX test's 40. Returns
    (the launches: none, the trained model)."""
    import tempfile
    convergence = _convergence_module()
    _reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work_dir:
        best, f1s, model = convergence.train_dbnet(work_dir, "cuda")
    launches = _no_launch_at_all("dbnet_learns")
    print(f"dbnet_learns: resnet18_dbnet 128^2, {len(f1s)} epochs in "
          f"{time.perf_counter() - t0:.1f} s [{card}]: polygon F1 by epoch "
          f"{' '.join(f'{f:.2f}' for f in f1s)}; best {best:.2f} (40 "
          f"required)", flush=True)
    if not best >= 40.0:
        raise RuntimeError(f"DBNet did not learn: best F1 {best:.2f}")
    return launches, model


def _boxes_outside_flips_agree(card_maps, cpu_maps):
    """``DBNetDecoder``'s boxes of two [B, H, W, 2] maps, each region that
    holds a pixel binarised differently left out of both: (equal, boxes
    compared, pixels binarised differently, regions left out, largest map
    difference)."""
    from scipy import ndimage
    card_maps, cpu_maps = card_maps.copy(), cpu_maps.copy()
    decoder = DBNetDecoder()
    thr = decoder.prob_threshold
    diff = float(np.abs(card_maps - cpu_maps).max())
    flipped = (card_maps[..., 0] > thr) != (cpu_maps[..., 0] > thr)
    regions = 0
    for i in np.nonzero(flipped.any(axis=(1, 2)))[0]:
        labels, _ = ndimage.label((card_maps[i, ..., 0] > thr)
                                  | (cpu_maps[i, ..., 0] > thr),
                                  structure=np.ones((3, 3)))
        touched = np.unique(labels[flipped[i]])
        regions += touched.size
        out = np.isin(labels, touched)
        card_maps[i, out, 0] = cpu_maps[i, out, 0] = 0.0
    got, want = decoder(card_maps), decoder(cpu_maps)
    same = all(len(gb) == len(wb)
               and all(g.shape == w.shape and np.abs(g - w).max() <= 1e-3
                       for g, w in zip(gb, wb))
               and np.allclose(gs, ws, rtol=1e-5, atol=0)
               for (gb, gs), (wb, ws) in zip(got, want))
    return (same, sum(len(b) for b, _ in want), int(flipped.sum()),
            regions, diff)


def _decoded_boxes_agree(card, model):
    """``DBNetDecoder`` on the card's probability maps against the CPU's,
    the same trained model (computing in f32, TF32 off) on 8 test images:
    the same boxes within 1e-3 pixels and scores within 1e-5. A pixel
    whose probability lies within the devices' rounding of the 0.3
    threshold binarises differently on the two, and may rightly change the
    contours of its region. So each 8-connected region of either binary
    map that holds such a pixel is set below the threshold in both maps
    first; every other region, and so every box that no flipped pixel
    touches, is compared, and the phase fails unless one box is left."""
    import copy
    ds = FakeTextDetectionDataset(8, image_hw=128)
    batch = TextDetectionCollater(128)([ds[100 + i] for i in range(8)])
    image = torch.from_numpy(batch["image"])
    # the model trained in bf16 compute; both copies compute in f32 here
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float32
    card_model = model.float().cuda().eval()
    cpu_model = copy.deepcopy(model).cpu().eval()
    with torch.no_grad():
        card_maps = card_model(image.cuda()).cpu().numpy()
        with torch.backends.mkldnn.flags(enabled=False):
            cpu_maps = cpu_model(image).numpy()
    same, n, flips, regions, diff = _boxes_outside_flips_agree(
        card_maps, cpu_maps)
    print(f"ocr_parity: DBNetDecoder on the card's maps vs the CPU's "
          f"(trained resnet18_dbnet, 8 images of 128^2) [{card}]: largest "
          f"map difference {diff:.3e}, "
          f"{flips} pixels binarised differently in {regions} "
          f"regions (left out), {n} boxes compared, boxes and scores "
          f"equal: {same}", flush=True)
    if not (same and n > 0):
        raise RuntimeError("DBNetDecoder gives other boxes on the card's "
                           "maps than on the CPU's, or none to compare")


def phase_ocr_parity(card, trained_dbnet):
    """One f32 train step at batch 2 on the card (TF32 off) against the CPU
    for resnet18_dbnet at 256^2 and CTCModel(resnet18, BiLSTMEncoder) at
    32 x 256 (cuDNN's LSTM against the CPU's), and ``DBNetDecoder`` on the
    card's maps of the trained dbnet_learns model against the CPU's.
    Returns the launches (none)."""
    _reset_launches()
    ds = FakeTextDetectionDataset(2, image_hw=256)
    det = TextDetectionCollater(256)([ds[0], ds[1]])
    det = {k: torch.from_numpy(det[k])
           for k in ("image",) + text_det_task.MAP_KEYS}
    # train-mode BatchNorm at batch 2 amplifies rounding: L2 and cosine
    # bounds, as FCOS's (an H100 read 2.6e-3 and 0.99999)
    _parity(card, "resnet18_dbnet 256^2, batch 2",
            lambda: init_params(MODELS.create("resnet18_dbnet",
                                              dtype=torch.float32),
                                torch.Generator().manual_seed(3)),
            text_det_task.make_loss_fn(LOSSES.create("DBNetLoss")), det,
            loss_rel=1e-3, grad_rel=5e-2, grad_cos=0.99, path="ocr_parity")
    converter = CTCTextLabelConverter(list("0123456789"), str_max_length=10)
    rec_ds = FakeTextRecognitionDataset(2)
    rec = KeepRatioResizeTextRecognitionCollater(converter, 32, 256)(
        [rec_ds[0], rec_ds[1]])
    rec = {k: torch.from_numpy(rec[k])
           for k in ("image", "targets", "target_lengths")}
    # cuDNN's LSTM against the CPU's: an H100 read a loss 2e-7 apart and
    # gradients 1.1e-5 apart in L2, each parameter's at a cosine of 1.0
    _parity(card, "CTCModel resnet18 + BiLSTMEncoder 32 x 256, batch 2",
            lambda: init_params(CTCModel(
                backbone_type="resnet18", encoder_type="BiLSTMEncoder",
                predictor_hidden_planes=64,
                num_classes=converter.num_classes, dtype=torch.float32),
                torch.Generator().manual_seed(4)),
            text_rec_task.make_loss_fn(LOSSES.create("CTCLoss")), rec,
            loss_rel=1e-5, grad_rel=1e-4, grad_cos=0.9999, path="ocr_parity")
    _decoded_boxes_agree(card, trained_dbnet)
    return _no_launch_at_all("ocr_parity")


def phase_ocr_cli(card):
    """fake_synthetic/resnet18_dbnet and resnet18_ctc through the OCR train
    and test CLIs in this process (key metrics: the polygon F1 and the
    string accuracy, x 100)."""
    launches = {}
    for rel, train_cli, test_cli, metric in (
            ("8.ocr_text_detection_training/fake_synthetic/resnet18_dbnet",
             text_det_train_cli, text_det_test_cli, "polygon F1"),
            ("9.ocr_text_recognition_training/fake_synthetic/resnet18_ctc",
             text_rec_train_cli, text_rec_test_cli, "string accuracy")):
        print(f"ocr_cli: {rel}: its key metric is the {metric} x 100",
              flush=True)
        launches.update(_experiment_cli(card, "ocr_cli", rel, train_cli,
                                        test_cli))
    _wide_kernels_only("the ocr_cli path")
    return launches


def _slice_18(card):
    """The phases of slice 18: {path: launches}; none launches a hand
    kernel."""
    t0 = time.perf_counter()
    paths = {}
    paths["dbnet_train"], _ = phase_dbnet_train(card)
    paths["ctc_train"], _ = phase_ctc_train(card)
    paths["dbnet_learns"], trained = phase_dbnet_learns(card)
    paths["ocr_parity"] = phase_ocr_parity(card, trained)
    paths["ocr_cli"] = phase_ocr_cli(card)
    print(f"slice 18: five phases in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    return paths


# ---- slice 24: offline dataset preparation ----------------------------------

# the mask folder's images (h, w), in turn: the salient-object and matting
# sets' mixed sizes, among them a 902 x 2276 panorama and 1280 x 720 frames
PREPARED_SIZES = ((902, 2276), (720, 1280), (1280, 720), (480, 640),
                  (1024, 768), (600, 800))
PREPARED_PAIRS = {"train": 16, "test": 8}
# the OCR trees: images of 540 x 720 converted at --max-side 1024, so that
# they fit the DBNet recipe's 1024^2 canvas (TextDetectionCollater pads and
# does not resize; the tool's default of 1920 would not fit)
PREPARED_OCR_IMAGES, PREPARED_OCR_SIDE = 6, 1024

PREPARED_SAM_CLI_CONFIG = '''"""SAM-B as
experiments/13.interactive_segmentation_training/sa_1b/sam_b/train_config.py
states it (sam_b at 1024^2 with gradient checkpointing, SAMMultiLevelLoss,
prompt kinds 0.5 / 0.25 / 0.25, 2 decoder point iterations, AdamW 1e-4 /
1e-4, CosineLR with a 1-epoch warm-up, batch 8, SamResize(1024)) over the
SA-1B tree that the dataset tool's sam-masks subcommand converted from a
folder of image/mask pairs (the combined recipe's salient-object and matting
sets), cut to: 16 train and 8 test pairs written for the run; 1 epoch (not
100); 8 loader workers (not 16)."""

from {pkg}.core.registry import LOSSES, MODELS
from {pkg}.data.datasets import SAMSegmentationDataset
from {pkg}.data.interactive_segmentation import SAMBatchCollater, SamResize


class config:
    network = "sam_b"
    input_image_size = 1024

    model = MODELS.create(network, image_size=input_image_size,
                          use_gradient_checkpoint=True)
    train_criterion = LOSSES.create("SAMMultiLevelLoss")

    train_dataset = SAMSegmentationDataset(
        {root!r}, set_name_list=["masks"], set_type="train",
        transform=SamResize(input_image_size))
    test_dataset = {{"masks": SAMSegmentationDataset(
        {root!r}, set_name_list=["masks"], set_type="test",
        transform=SamResize(input_image_size))}}
    train_collater = SAMBatchCollater(resize=input_image_size)
    test_collater = SAMBatchCollater(resize=input_image_size,
                                     use_noise_bbox=False)

    prompt_probs = {{"point": 0.5, "box": 0.25, "mask": 0.25}}
    decoder_point_iters = 2

    seed = 0
    batch_size = 8
    num_workers = 8
    accumulation_steps = 1
    optimizer = ("AdamW", {{"lr": 1e-4, "global_weight_decay": False,
                           "weight_decay": 1e-4,
                           "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 1}})
    epochs = 1
    print_interval = 2
    use_ema_model = False
'''


def _smooth_noise(rng, h, w):
    """uint8 [h, w, 3] noise, low-passed by a 4x nearest upsample."""
    small = rng.randint(0, 120, ((h + 3) // 4, (w + 3) // 4, 3))
    return np.repeat(np.repeat(small, 4, 0), 4, 1)[:h, :w].astype(np.uint8)


def _write_image(path, image):
    from simpleaicv_tpu_torch.data.image_io import write_image
    write_image(path, image)


def write_mask_folder(root, seed=0):
    """``<root>/{train,test}/m_<i>.jpg`` and same-stem ``.png`` masks: a
    bright ellipse on dark noise in each, its mask 255 inside and a ramp of
    3 pixels at its edge (values about 127 and 128 fall either side of
    sam-masks' threshold), at ``PREPARED_SIZES`` in turn. Returns the
    images written, by split."""
    rng = np.random.RandomState(seed)
    written = {}
    i = 0
    for split, n in PREPARED_PAIRS.items():
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        for _ in range(n):
            h, w = PREPARED_SIZES[i % len(PREPARED_SIZES)]
            ys, xs = np.ogrid[:h, :w]
            cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(
                w // 4, 3 * w // 4)
            ay, ax = rng.randint(h // 8, h // 4), rng.randint(w // 8, w // 4)
            r = np.sqrt(((ys - cy) / ay) ** 2 + ((xs - cx) / ax) ** 2)
            edge = (1.0 - r) * min(ay, ax) / 3.0  # 3 pixels of ramp
            mask = np.clip(np.rint(255 * edge), 0, 255).astype(np.uint8)
            image = _smooth_noise(rng, h, w)
            image[mask > 0] = rng.randint(140, 256, 3).astype(np.uint8)
            _write_image(os.path.join(d, f"m_{i:03d}.jpg"), image)
            _write_image(os.path.join(d, f"m_{i:03d}.png"), mask)
            i += 1
        written[split] = n
    return written


def _text_quads(rng, h, w, n):
    """``n`` axis-aligned text quads on a grid of rows, [[x, y], ...]."""
    quads = []
    for k in range(n):
        y = 30 + k * (h - 60) // n
        x = rng.randint(20, w // 3)
        qw, qh = rng.randint(w // 4, w // 2), rng.randint(24, 40)
        quads.append([[x, y], [x + qw, y], [x + qw, y + qh], [x, y + qh]])
    return quads


def _text(rng):
    return "".join(rng.choice(list("0123456789ABCDEFGHabcdefgh文字识别"),
                              rng.randint(2, 9)))


def write_ocr_raw(root, seed=0):
    """An RCTW-style tree (``train_images``, ``train_gts`` of quoted
    utf-8-sig lines) and an ART-style one (``train_images``,
    ``train_labels.json``) of ``PREPARED_OCR_IMAGES`` 540 x 720 images
    each: 3 quads with text, one "###" quad and, in the ART tree, a
    curved 6-point line under them. Returns the text regions written."""
    rng = np.random.RandomState(seed)
    h, w = 540, 720
    regions = 0
    rctw = os.path.join(root, "rctw")
    art = os.path.join(root, "art")
    for d in (os.path.join(rctw, "train_images"),
              os.path.join(rctw, "train_gts"),
              os.path.join(art, "train_images")):
        os.makedirs(d, exist_ok=True)
    labels = {}
    for i in range(PREPARED_OCR_IMAGES):
        for tree in (rctw, art):
            image = _smooth_noise(rng, h, w) + 100
            quads = _text_quads(rng, h - 100, w, 4)
            for q in quads:
                (x0, y0), (x1, y1) = q[0], q[2]
                image[y0:y1, x0:x1] = 250
            texts = [_text(rng) for _ in quads[:3]] + ["###"]
            name = f"image_{i}" if tree == rctw else f"gt_{i}"
            _write_image(os.path.join(tree, "train_images", name + ".jpg"),
                         image)
            if tree == rctw:
                rows = [",".join(str(v) for p in q for v in p)
                        + f',0,"{t}"' for q, t in zip(quads, texts)]
                with open(os.path.join(rctw, "train_gts", name + ".txt"),
                          "w", encoding="utf-8-sig") as f:
                    f.write("\n".join(rows) + "\n")
            else:
                top = [[60 + 90 * k, 470 - 12 * (k % 2)] for k in range(4)]
                curve = top + [[x, y + 36] for x, y in reversed(top)]
                labels[name] = [{"points": q, "transcription": t}
                                for q, t in zip(quads, texts)] + [
                    {"points": curve, "transcription": _text(rng)}]
            regions += len(quads) + (tree == art)
    with open(os.path.join(art, "train_labels.json"), "w",
              encoding="utf-8") as f:
        json.dump(labels, f, ensure_ascii=False)
    return regions


def write_parsing_raw(root, seed=0):
    """A LIP-style tree (2 train and 2 val pairs, one mask at half the
    image's size) and a CelebAMask-HQ-style one (3 faces, 3 part masks
    each at half size, the HQ-to-CelebA mapping putting one in each
    split). Returns the pairs written."""
    rng = np.random.RandomState(seed)
    lip = os.path.join(root, "lip")
    for st in ("train", "val"):
        img_dir = os.path.join(lip, "TrainVal_images", f"{st}_images")
        seg_dir = os.path.join(lip, "TrainVal_parsing_annotations",
                               f"{st}_segmentations")
        os.makedirs(img_dir)
        os.makedirs(seg_dir)
        for i in range(2):
            h, w = 256, 192
            mask = np.zeros((h // (i + 1), w // (i + 1)), np.uint8)
            mask[10:60, 20:90] = rng.randint(1, 20)
            _write_image(os.path.join(img_dir, f"p{i}.jpg"),
                         _smooth_noise(rng, h, w))
            _write_image(os.path.join(seg_dir, f"p{i}.png"), mask)
    cm = os.path.join(root, "celebamask")
    os.makedirs(os.path.join(cm, "CelebA-HQ-img"))
    os.makedirs(os.path.join(cm, "CelebAMask-HQ-mask-anno", "0"))
    for idx in range(3):
        _write_image(os.path.join(cm, "CelebA-HQ-img", f"{idx}.jpg"),
                     _smooth_noise(rng, 256, 256))
        for k, part in enumerate(("skin", "hair", "neck")):
            part_mask = np.zeros((128, 128), np.uint8)
            part_mask[10 + 30 * k:40 + 30 * k, 20:100] = 255
            _write_image(os.path.join(cm, "CelebAMask-HQ-mask-anno", "0",
                                      f"{idx:05d}_{part}.png"), part_mask)
    with open(os.path.join(cm, "CelebA-HQ-to-CelebA-mapping.txt"), "w") as f:
        f.write("idx orig_idx orig_file\n0 5 a.jpg\n1 170000 b.jpg\n"
                "2 190000 c.jpg\n")
    return 7


def _prepare(label, argv, images):
    """One ``prepare_dataset`` subcommand, its seconds and ms an image on
    this machine's host printed."""
    from simpleaicv_tpu_torch.tools import prepare_dataset
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        rc = prepare_dataset.main(argv)
        took = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"prepare_dataset {label} returned {rc}")
    print(f"prepared_data: {label}: {took:.2f} s for {images} images, "
          f"{1e3 * took / max(images, 1):.1f} ms an image on the host",
          flush=True)
    return took


def _prepared_sa1b(root):
    """The mask folder written under ``<root>/raw`` and converted by
    ``sam-masks`` into ``<root>/masks/{train,test}``; fails unless
    ``SAMSegmentationDataset`` finds every pair with its json."""
    from simpleaicv_tpu_torch.data.datasets import SAMSegmentationDataset
    raw = os.path.join(root, "raw")
    written = write_mask_folder(raw)
    for split, n in written.items():
        _prepare(f"sam-masks --set-type {split}",
                 ["sam-masks", "--root", raw, "--out",
                  os.path.join(root, "masks"), "--set-type", split], n)
        found = len(SAMSegmentationDataset(root, ["masks"], split))
        if found != n:
            raise RuntimeError(f"SAMSegmentationDataset found {found} of the "
                               f"{n} converted {split} pairs")
    return written


def _prepared_ocr_and_parsing(root):
    """The OCR and parsing trees converted through ``rctw``, ``art``,
    ``text-lines``, ``char-table``, ``lip`` and ``celebamask-hq``, and
    read back through the port's readers: (the detection samples, the
    line samples, the character table)."""
    from simpleaicv_tpu_torch.data.datasets import (
        FaceParsingDataset, HumanParsingDataset, TextDetection,
        TextRecognition)
    raw, out = os.path.join(root, "raw"), os.path.join(root, "out")
    write_ocr_raw(raw)
    write_parsing_raw(raw)
    det, lines = os.path.join(out, "det"), os.path.join(out, "lines")
    n = PREPARED_OCR_IMAGES
    for tool in ("rctw", "art"):
        _prepare(tool, [tool, "--root", os.path.join(raw, tool), "--out",
                        det, "--max-side", str(PREPARED_OCR_SIDE)], n)
    sets = {"ICDAR2017RCTW_text_detection": "ICDAR2017RCTW_text_recognition",
            "ICDAR2019ART_text_detection": "ICDAR2019ART_text_recognition"}
    labels = []
    for det_set, rec_set in sets.items():
        _prepare(f"text-lines {det_set}",
                 ["text-lines", "--root", det, "--set-name", det_set,
                  "--out", os.path.join(lines, rec_set)], n)
        labels += [os.path.join(lines, rec_set, f"{rec_set}_{t}.json")
                   for t in ("train", "test")]
    table_path = os.path.join(out, "table.json")
    _prepare("char-table", ["char-table", "--labels", *labels, "--out",
                            table_path], 0)
    _prepare("lip", ["lip", "--root", os.path.join(raw, "lip"), "--out",
                     os.path.join(out, "parsing")], 4)
    _prepare("celebamask-hq", ["celebamask-hq", "--root",
                               os.path.join(raw, "celebamask"), "--out",
                               os.path.join(out, "parsing")], 3)
    detection = [s for t in ("train", "test") for s in TextDetection(
        det, list(sets), set_type=t)]
    recognition = [s for t in ("train", "test") for s in TextRecognition(
        lines, list(sets.values()), set_type=t)]
    parsing = [s for cls, names, types in (
        (HumanParsingDataset, ["LIP"], ("train", "val")),
        (FaceParsingDataset, ["CelebAMask-HQ"], ("train", "val", "test")))
        for t in types for s in cls(os.path.join(out, "parsing"), names,
                                    set_type=t)]
    with open(table_path, encoding="utf-8") as f:
        table = json.load(f)
    polys = sum(len(s["annots"]) for s in detection)
    print(f"prepared_data: read back {len(detection)} detection images "
          f"({polys} polygons), {len(recognition)} text lines, "
          f"{len(parsing)} parsing pairs, a table of {len(table)} "
          f"characters", flush=True)
    if len(detection) != 2 * n or len(recognition) < 3 * n or \
            len(parsing) != 7 or not table or any(
                s["mask"].shape != s["image"].shape[:2] for s in parsing):
        raise RuntimeError("prepared_data: the converted OCR or parsing "
                           "sets do not read back whole")
    return detection, recognition, table


def _one_step(card, label, model, loss_fn, opt, sched, epochs, host, keys):
    """One bf16 train step of ``model`` on the host batch ``host`` through
    ``make_train_step``; fails unless the loss is finite and at least half
    the parameter tensors took a gradient (a nonzero first moment of
    AdamW: the recipes' warm-up gives the first step an lr of 0, so the
    weights themselves do not move)."""
    batch = {k: torch.from_numpy(host[k]).cuda() for k in keys}
    state = _recipe_state(model, opt, sched, epochs, OCR_STEPS_PER_EPOCH)
    step = make_train_step(loss_fn, EngineConfig())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, seed=0)
    loss = metrics["loss"].item()
    took = time.perf_counter() - t0
    mu = state.optimizer.moments["mu"]
    taken = sum(bool(m.any()) for m in mu)
    print(f"prepared_data: {label}: one step on the prepared batch "
          f"{tuple(batch['image'].shape)} in {took:.2f} s (its first, with "
          f"the autotuning), loss {loss:.4f}, {taken} of {len(mu)} "
          f"parameter tensors took a gradient [{card}]", flush=True)
    if not np.isfinite(loss) or 2 * taken < len(mu):
        raise RuntimeError(f"prepared_data: {label}'s step failed")


def phase_prepared_data(card, resident_ips=float("nan")):
    """Offline dataset preparation through the port's ``prepare_dataset``
    on the host, then its outputs on the card: a mask folder converted by
    ``sam-masks`` trains SAM-B 1024^2 at batch 8 for an epoch and is
    evaluated through the SAM train and test CLIs (path
    ``prepared_sam_cli``: K4-K6); the RCTW- and ART-style trees converted
    by ``rctw``/``art``, cut into lines by ``text-lines`` with a
    ``char-table``, and the LIP and CelebAMask-HQ trees converted, read
    back through the port's readers; one step of resnet18_dbnet (1024^2)
    and of the resnet18 BiLSTM CTC model (32 x 512, the prepared table)
    on the card from them (path ``prepared_ocr``: no hand kernel)."""
    import tempfile
    sam = _cli_in_process(card, "prepared_sam_cli", sam_train_cli,
                          sam_test_cli, PREPARED_SAM_CLI_CONFIG, resident_ips,
                          SAM_KERNELS, write_set=_prepared_sa1b)
    with tempfile.TemporaryDirectory() as root:
        detection, recognition, table = _prepared_ocr_and_parsing(root)
    from simpleaicv_tpu_torch.data.text_detection import DBNetMapGenerator
    _reset_launches()
    gen = DBNetMapGenerator()
    dbnet = init_params(MODELS.create("resnet18_dbnet"),
                        torch.Generator().manual_seed(0))
    _one_step(card, "resnet18_dbnet 1024^2", dbnet,
              text_det_task.make_loss_fn(LOSSES.create("DBNetLoss")),
              DBNET_RECIPE_OPT, DBNET_RECIPE_SCHED, DBNET_EPOCHS,
              TextDetectionCollater(PREPARED_OCR_SIDE)(
                  [gen(s) for s in detection]),
              ("image",) + text_det_task.MAP_KEYS)
    converter = CTCTextLabelConverter(table, str_max_length=CTC_STR_MAX)
    ctc = init_params(CTCModel(
        backbone_type="resnet18", encoder_type="BiLSTMEncoder",
        predictor_hidden_planes=64, num_classes=converter.num_classes),
        torch.Generator().manual_seed(0))
    _one_step(card, "resnet18 BiLSTM CTC 32 x 512", ctc,
              text_rec_task.make_loss_fn(LOSSES.create("CTCLoss")),
              CTC_RECIPE_OPT, CTC_RECIPE_SCHED, CTC_EPOCHS,
              KeepRatioResizeTextRecognitionCollater(
                  converter, 32, CTC_MAX_W)(recognition),
              ("image", "targets", "target_lengths"))
    ocr = _no_hand_kernel("prepared_ocr")
    del dbnet, ctc
    torch.cuda.empty_cache()
    return {"prepared_sam_cli": sam, "prepared_ocr": ocr}


# ---- slice 19: the ConvFormer, VAN, DarkNet and CIFAR-ResNet backbones,
# their family variants and the packed loader --------------------------------

# ImageNet recipes of experiments/0.classification_training/imagenet/
# {convformer_m36,van_b2}: AdamW 1e-3 / 5e-2 and CosineLR (5 warm-up epochs
# of 300); darknet53 and cifar100/resnet18cifar: SGD 0.1 / 0.9 and
# their schedules. The steps take CELoss on integer labels (the recipes'
# mixup and cutmix run in the host collater).
CLS19_ADAMW = ("AdamW", {"lr": 1e-3, "global_weight_decay": False,
                         "weight_decay": 5e-2,
                         "no_weight_decay_layer_name_list": []})
CLS19_COSINE = ("CosineLR", {"warm_up_epochs": 5, "min_lr": 1e-6})
CLS19_SGD = ("SGD", {"lr": 0.1, "momentum": 0.9, "global_weight_decay": False,
                     "weight_decay": 1e-4,
                     "no_weight_decay_layer_name_list": []})
CLS19_STEPS = ("MultiStepLR", {"warm_up_epochs": 1,
                               "milestones": [60, 120, 160], "gamma": 0.2})
# each new family variant's config size (experiments/**/train_config.py;
# the FCOS, SOLOv2 and YOLACT variants have no config of their own: their
# family's R50 recipe)
VARIANT_SIZES = {"light_sam": 1024, "sam_matting": 1024,
                 "pfan_segmentation": 832, "pfan_matting": 832,
                 "pfan_face_parsing": 512, "pfan_human_parsing": 512,
                 "fcos": 800, "dbnet": 1024, "solov2": 1024, "yolact": 1024,
                 "deeplabv3plus": 512}
_VAN_CONVFORMER = ("vanb0", "vanb1", "vanb2", "vanb3", "convformers18",
                   "convformers36", "convformerm36", "convformerb36")
PACKED_SAMPLES = 2048


def _cls19_train(card, path, network, image, batches, opt, sched,
                 warm_up=2, timed=5, num_classes=1000):
    """A classification backbone through ``make_train_step`` on a resident
    batch of ``image``^2 bf16 inputs, the first of ``batches`` that fits:
    images/s, ms a step, peak memory and a profiled step's idle share.
    Returns (the launches: none, images per second)."""
    t0 = time.perf_counter()

    def make_batch(n):
        g = torch.Generator(device="cuda").manual_seed(0)
        return {"image": torch.randn(n, image, image, 3, device="cuda",
                                     generator=g),
                "label": torch.randint(0, num_classes, (n,), device="cuda",
                                       generator=g)}

    def build():
        model = init_params(BACKBONES.create(network,
                                             num_classes=num_classes),
                            torch.Generator().manual_seed(0))
        state = _recipe_state(model, opt, sched, 300, 1281167 // batches[0])
        criterion = LOSSES.create("CELoss")
        return model, criterion, state, make_train_step(
            make_loss_fn(criterion), EngineConfig())

    n, model, _, state, step, batch, step_ms, losses = \
        _largest_batch_that_fits(path, batches, make_batch, build, warm_up,
                                 timed)
    launches = _no_launch_at_all(path)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ips = n / step_ms * 1e3
    which = (f"the largest of {batches} that fits" if len(batches) > 1
             else "the recipe's")
    print(f"{path}: {network} {image}^2 bf16 training, batch {n} ({which}) "
          f"[{card}]: {ips:.2f} images/s, {step_ms:.2f} ms per step over "
          f"{timed} steps, peak memory {peak_gib:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)} (set-up and the batch "
          f"search {time.perf_counter() - t0:.1f} s)", flush=True)
    _profiled_step(card, network, step, state, batch, step_ms, top=8)
    _no_launch_at_all(path)
    del state, model, step, batch
    torch.cuda.empty_cache()
    return launches, ips


def phase_backbone_parity(card):
    """One f32 train step of each new backbone at batch 2 on the card (TF32
    off) against the CPU from the same weights: ConvFormer-M36, VAN-B2 and
    DarkNet-53 at 64^2, ResNet18-CIFAR at 32^2. Returns the launches
    (none)."""
    _reset_launches()
    loss_fn = make_loss_fn(LOSSES.create("CELoss"))
    # train-mode BatchNorm at batch 2 amplifies rounding through depth, as
    # in the ResNet-50, FCOS and DBNet steps: gradients held in L2 and by
    # cosine
    # biases whose per-channel shift reaches the loss only through
    # train-mode BatchNorms (ConvFormer's stem and its stage-2 and 3
    # downsamplings, VAN's patch embeddings, residual-branch outputs and
    # inner stage norms) have a true gradient of 0: CPU f32 against f64
    # parts them at cosines of -0.07 to 0.08; held in L2 only
    zero = {"convformer_m36": r"downsample_layers\.(0\.(conv|post_norm)|"
                              r"[12]\.conv)\.bias",
            "van_b2": r"(patch_embed\d\.(proj|norm)|block\d\.\d+\.("
                      r"attn\.proj_2|mlp\.fc2)|norm[123])\.bias"}
    # each network's bounds from its own reading (H100 80GB HBM3, 700 W):
    # gradients 1.096e-3, 1.449e-6, 9.399e-3 and 4.41e-6 apart in L2,
    # least cosines 0.999977, 0.999782, 0.999486 and 1.0, losses within
    # 1e-6 relative
    bounds = {"convformer_m36": (5e-3, 0.9995), "van_b2": (1e-4, 0.999),
              "darknet53": (3e-2, 0.995), "resnet18cifar": (1e-4, 0.9999)}
    for network, image, seed in (("convformer_m36", 64, 5), ("van_b2", 64, 6),
                                 ("darknet53", 64, 7),
                                 ("resnet18cifar", 32, 8)):
        grad_rel, grad_cos = bounds[network]
        g = torch.Generator().manual_seed(seed)
        batch = {"image": torch.randn(2, image, image, 3, generator=g),
                 "label": torch.randint(0, 10, (2,), generator=g)}
        _parity(card, f"{network} {image}^2, batch 2",
                lambda network=network, seed=seed: init_params(
                    BACKBONES.create(network, num_classes=10,
                                     dtype=torch.float32),
                    torch.Generator().manual_seed(seed)),
                loss_fn, batch, loss_rel=1e-5, grad_rel=grad_rel,
                grad_cos=grad_cos, path="backbone_parity",
                zero_expected=zero.get(network))
    return _no_launch_at_all("backbone_parity")


def _variant_names():
    """{family variant: its config size} for every family variant built on
    a VAN or ConvFormer backbone but ConvFormer-M36's DeepLabV3+."""
    names = {}
    for b in _VAN_CONVFORMER:
        names[f"{b}_light_sam"] = VARIANT_SIZES["light_sam"]
        for i in (1, 2):
            names[f"{b}_light_sam_matting{i}"] = VARIANT_SIZES["sam_matting"]
        for task in ("segmentation", "matting", "face_parsing",
                     "human_parsing"):
            names[f"{b}_pfan_{task}"] = VARIANT_SIZES[f"pfan_{task}"]
    for name in ("convformer_m36_light_sam", "van_b3_light_sam"):
        names[name] = VARIANT_SIZES["light_sam"]
    for i in (1, 2):
        names[f"convformer_m36_sam_matting{i}"] = VARIANT_SIZES["sam_matting"]
    for name, family in (("convformer_m36_fcos", "fcos"),
                         ("van_b2_fcos", "fcos"),
                         ("vanb2_dbnet", "dbnet"),
                         ("convformerm36_dbnet", "dbnet"),
                         ("vanb2_solov2", "solov2"),
                         ("convformerm36_solov2", "solov2"),
                         ("vanb2_yolact", "yolact"),
                         ("convformerm36_yolact", "yolact"),
                         ("vanb2_deeplabv3plus", "deeplabv3plus")):
        names[name] = VARIANT_SIZES[family]
    return names


def _fill_on_card(model, seed, device="cuda"):
    """Seeded random weights drawn on the card (a quick stand-in for
    ``init_params`` on a model built there), as the init sets them but for
    the kernels' distribution: kernels normal at 1 / sqrt(fan in), VAN's
    layer scales 1e-5, norms' scales 1, the other vectors 0, the buffers
    but BatchNorm's running statistics standard normal. VAN's layer scales
    stay at the init's value: at 0.1 such weights overflow VAN-B3's stream
    in eval mode in both packages, in f32 and bf16
    (``tests/test_torch_van_layer_scale.py``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
            elif "layer_scale" in name:
                p.fill_(1e-5)
            else:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
        for name, b in model.named_buffers():
            if "running_" not in name:  # SAM's random positional matrix
                b.normal_(0.0, 1.0, generator=g)
    return model


def _all_finite(out):
    if isinstance(out, torch.Tensor):
        return bool(torch.isfinite(out.float()).all())
    if isinstance(out, dict):
        out = list(out.values())
    return all(_all_finite(o) for o in out)


def phase_variant_train(card, warm_up=2, timed=5):
    """convformerm36_deeplabv3plus at its recipe's 512^2 (ADE20K, 150
    classes) on a resident batch, the largest of 16 and 8 that fits; then
    one bf16 forward of every other new family variant at batch 1 and its
    config's size, built on the card, checked finite. Returns (the
    launches: none, images per second)."""
    t0 = time.perf_counter()

    def build():
        model = init_params(MODELS.create("convformerm36_deeplabv3plus",
                                          num_classes=SEG_CLASSES),
                            torch.Generator().manual_seed(0))
        state = _recipe_state(model, SEG_RECIPE_OPT, SEG_RECIPE_SCHED,
                              SEG_EPOCHS, SEG_STEPS_PER_EPOCH)
        criterion = LOSSES.create("SegCELoss", ignore_index=SEG_IGNORE)
        return model, criterion, state, make_train_step(
            seg_task.make_loss_fn(criterion), EngineConfig())

    n, model, _, state, step, batch, step_ms, losses = \
        _largest_batch_that_fits("variant_train", [16, 8], _seg_batch,
                                 build, warm_up, timed)
    launches = _no_launch_at_all("variant_train")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    ips = n / step_ms * 1e3
    print(f"variant_train: convformerm36_deeplabv3plus {SEG_IMAGE}^2 bf16 "
          f"training, batch {n} (the largest of [16, 8] that fits) "
          f"[{card}]: {ips:.2f} images/s, {step_ms:.2f} ms per step over "
          f"{timed} steps, peak memory {peak_gib:.2f} GiB; losses "
          f"{' '.join(f'{v:.4f}' for v in losses)} (set-up and the batch "
          f"search {time.perf_counter() - t0:.1f} s)", flush=True)
    _profiled_step(card, "convformerm36_deeplabv3plus", step, state, batch,
                   step_ms, top=8)
    del state, model, step, batch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    names = _variant_names()
    prompts = {"prompt_point": torch.tensor([[[100.0, 120.0, 1.0]]],
                                            device="cuda"),
               "prompt_box": torch.tensor([[60.0, 80.0, 400.0, 500.0]],
                                          device="cuda"),
               "prompt_mask": None}
    for i, (name, size) in enumerate(names.items()):
        with torch.device("cuda"):
            kw = {"image_size": size} if "sam" in name else {}
            model = _fill_on_card(MODELS.create(name, **kw), i).eval()
        x = torch.rand(1, size, size, 3, device="cuda")
        with torch.no_grad():
            out = model(x, prompts) if "sam" in name else model(x)
        if not _all_finite(out):
            raise RuntimeError(f"variant_train: {name} gave non-finite "
                               f"outputs at {size}^2")
        del model, out
    ctc = _fill_on_card(CTCModel(backbone_type="convformer_m36",
                                 encoder_type="TransformerEncoder",
                                 num_classes=12112).cuda(), 99).eval()
    with torch.no_grad():
        out = ctc(torch.rand(1, 32, 512, 3, device="cuda"))
    if not _all_finite(out):
        raise RuntimeError("variant_train: the ConvFormer CTC model gave "
                           "non-finite outputs")
    del ctc, out
    torch.cuda.empty_cache()
    print(f"variant_train: {len(names) + 1} other family variants (every "
          f"VAN and ConvFormer LightSAM, SAM matting, PFAN, FCOS, DBNet, "
          f"SOLOv2, YOLACT and DeepLabV3+ variant, and the ConvFormer-M36 "
          f"CTC model at 32 x 512) built on the card and run at batch 1 and "
          f"their configs' sizes, every output finite, in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    _no_launch_at_all("variant_train")
    return launches, ips


PACKED_CLI_CONFIG = '''"""ResNet-50 on ImageNet as
experiments/0.classification_training/imagenet/resnet50/train_config.py
states it (resnet50, 1000 classes, 224^2, CELoss, SGD 0.1 / 0.9 / 1e-4,
CosineLR with 5 warm-up epochs), cut to: batch 128; 2 epochs of a pack of
{n} synthetic 224^2 images (no ImageNet here) read {how}; 128 test images
in a pack of their own."""

from simpleaicv_tpu.core.registry import BACKBONES, LOSSES
from simpleaicv_tpu.data.collater import ClassificationCollater
from simpleaicv_tpu.data.packed import PackedDataset
from simpleaicv_tpu.data.transforms import Compose


class config:
    network = "resnet50"
    num_classes = 1000
    input_image_size = 224
    model = BACKBONES.create(network, num_classes=num_classes)
    train_criterion = LOSSES.create("CELoss")
    test_criterion = LOSSES.create("CELoss")
    train_dataset = PackedDataset({path!r}{transform})
    test_dataset = PackedDataset({test_path!r})
    train_collater = ClassificationCollater()
    test_collater = ClassificationCollater()
    seed = 0
    batch_size = 128
    num_workers = 8
    optimizer = ("SGD", {{"lr": 0.1, "momentum": 0.9,
                         "global_weight_decay": False, "weight_decay": 1e-4,
                         "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 5}})
    epochs = 2
    print_interval = 4
    use_ema_model = False
'''


def phase_packed_cli(card, resident_ips):
    """A 224^2 pack of ``PACKED_SAMPLES`` synthetic images written by
    ``pack_dataset``, then the ResNet-50 train CLI for two epochs of it in
    this process, three times in turns (D, P, D; a second P run cut to
    make room for the HTTP phase): through the
    ``DataLoader`` (D: a ``PackedDataset`` with a per-sample transform,
    read a sample at a time) and through the ``PackedLoader`` (P: no
    transform, one native gather a batch). Each run's logged rate over its
    second epoch, whose start the first epoch has warmed, beside
    ``resnet50_train``'s resident rate; the medians of each loader's runs.
    Returns the launches (none)."""
    import os
    import tempfile
    from simpleaicv_tpu_torch.core.config import load_config
    from simpleaicv_tpu_torch.core.trainer import train_loader
    from simpleaicv_tpu_torch.data import packed
    how = {"DataLoader": ("sample by sample through the DataLoader",
                          ", transform=Compose([])"),
           "PackedLoader": ("by the PackedLoader's gather", "")}
    rates = {"DataLoader": [], "PackedLoader": []}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "train_224.pack")
        packed.pack_dataset(FakeClassificationDataset(
            PACKED_SAMPLES, 224, num_classes=1000), path)
        test_path = os.path.join(tmp, "test_224.pack")
        packed.pack_dataset(FakeClassificationDataset(128, 224, 1000),
                            test_path)
        print(f"packed_cli: {PACKED_SAMPLES} synthetic 224^2 samples packed "
              f"({os.path.getsize(path) / 2**20:.1f} MiB) in "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
        for turn, loader in enumerate(("DataLoader", "PackedLoader",
                                       "DataLoader")):
            work = os.path.join(tmp, f"{turn}_{loader}")
            os.makedirs(work)
            with open(os.path.join(work, "train_config.py"), "w") as f:
                f.write(PACKED_CLI_CONFIG.format(
                    n=PACKED_SAMPLES, how=how[loader][0], path=path,
                    transform=how[loader][1], test_path=test_path))
            routed = type(train_loader(load_config(work), 128, 8, 0))
            if routed.__name__ != loader:
                raise RuntimeError(f"packed_cli: the Trainer sends the "
                                   f"{loader} config to {routed.__name__}")
            _reset_launches()
            t0 = time.perf_counter()
            cls_train_cli.main(["--work-dir", work])
            secs = time.perf_counter() - t0
            with open(os.path.join(work, "log", "train.log")) as f:
                log = f.read()
            found = {e: [float(m.group(1)) for m in re.finditer(
                rf"epoch {e} iter \d+/\d+ .* imgs/s ([0-9.]+)", log)]
                for e in (1, 2)}
            if not found[2]:
                raise RuntimeError(f"packed_cli: the {loader} run logged "
                                   f"no rate in epoch 2")
            rates[loader].append(found[2][-1])
            print(f"packed_cli: train CLI, {how[loader][0]} [{card}]: "
                  f"logged images/s (cumulative over each epoch) epoch 1 "
                  f"{found[1]}, epoch 2 {found[2]}; the CLI {secs:.1f} s "
                  f"with its evaluations", flush=True)
    med = {k: statistics.median(v) for k, v in rates.items()}
    print(f"packed_cli: epoch-2 rate {med['DataLoader']:.1f} images/s "
          f"through the DataLoader ({rates['DataLoader']}), "
          f"{med['PackedLoader']:.1f} through the PackedLoader "
          f"({rates['PackedLoader']}), beside resnet50_train's resident "
          f"{resident_ips:.1f} [{card}]", flush=True)
    return _no_launch_at_all("packed_cli")


def _slice_19(card, resident_ips):
    """The phases of slice 19: {path: launches}; none launches a hand
    kernel. The ImageNet-21K CLIs' phase is not run: the card's machine
    has no libjpeg (ROADMAP.md, "Standing facts")."""
    t0 = time.perf_counter()
    paths = {}
    paths["convformer_train"], _ = _cls19_train(
        card, "convformer_train", "convformer_m36", 224, [256, 128],
        CLS19_ADAMW, CLS19_COSINE)
    paths["van_train"], _ = _cls19_train(
        card, "van_train", "van_b2", 224, [256, 128], CLS19_ADAMW,
        CLS19_COSINE)
    dark, _ = _cls19_train(card, "darknet_cifar_train", "darknet53", 256,
                           [128], CLS19_SGD, CLS19_COSINE, timed=3)
    cifar, _ = _cls19_train(card, "darknet_cifar_train", "resnet18cifar", 32,
                            [128], CLS19_SGD, CLS19_STEPS, timed=5,
                            num_classes=100)
    paths["darknet_cifar_train"] = {**dark, **cifar}
    paths["backbone_parity"] = phase_backbone_parity(card)
    paths["variant_train"], _ = phase_variant_train(card)
    paths["packed_cli"] = phase_packed_cli(card, resident_ips)
    print(f"slice 19: six phases in {time.perf_counter() - t0:.1f} s "
          f"[{card}]; the ImageNet-21K CLIs' JPEG phase is left out: this "
          f"machine has no libjpeg to build the decode library against",
          flush=True)
    return paths


# ---------------------------------------------------------------- parallel

PAR_BATCH, PAR_STEPS, PAR_MICRO = 128, 3, 4
PAR_RING = (2, 12, 4096, 64)
PAR_OPT = OptimizerConfig(
    name="AdamW", lr=1e-3, weight_decay=0.05,
    no_weight_decay_layer_name_list=("position_encoding", "cls_token"),
    lr_layer_decay=0.75, lr_layer_decay_block_nums=12, block_name="blocks")
PAR_SCHED = SchedulerConfig("CosineLR", lr=1e-3, epochs=100,
                            warm_up_epochs=5, min_lr=1e-6)


def _par_vit_steps(rows):
    """``PAR_STEPS`` engine steps of ViT-B/16 (flash, the training phase's
    recipe) on rows ``rows`` of a seeded global batch of ``PAR_BATCH``:
    (model, losses, K1-K3 launches, ms a step after the first)."""
    model = _vit_b16(use_flash_attention=True, seed=3)
    opt, _ = build_optimizer(PAR_OPT, PAR_SCHED, 4, model)
    state = create_train_state(model, opt, EngineConfig())
    step = make_train_step(make_loss_fn(LOSSES.create("OneHotLabelCELoss")),
                           EngineConfig())
    g = torch.Generator(device="cuda").manual_seed(4)
    image = torch.randn(PAR_BATCH, 224, 224, 3, generator=g, device="cuda")
    labels = torch.randint(0, 1000, (PAR_BATCH,), generator=g, device="cuda")
    rows = torch.as_tensor(rows, device="cuda")
    batch = {"image": image[rows],
             "label": torch.nn.functional.one_hot(labels[rows], 1000).float()}
    _reset_launches()
    losses = []
    for i in range(PAR_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, batch, seed=0)
        losses.append(metrics["loss"].item())
    step_ms = (time.perf_counter() - t0) * 1e3 / (PAR_STEPS - 1)
    return (model, losses, {k: fa.KERNEL_LAUNCHES[k] for k in TRAIN_KERNELS},
            step_ms)


PAR_TRAINER_CONFIG = '''"""ViT-B/16 as
experiments/0.classification_training/imagenet/vit_base_patch16/train_config.py
states it (global pool, drop-path 0.1, bf16, AdamW 1e-3 with layer-wise
decay 0.75 over 12 blocks and no decay on the embeddings, CosineLR with 5
warm-up epochs), with flash attention, cut to: batch {batch}; one epoch of
{n} synthetic 224^2 images of 1000 classes (fake_synthetic's
FakeClassificationDataset: no ImageNet here); CE on integer labels (no
mixup collater); {batch} test images; no EMA. The mesh is the config's
default: every rank on ``data``."""

from simpleaicv_tpu.core.registry import BACKBONES, LOSSES
from simpleaicv_tpu.data.collater import ClassificationCollater
from simpleaicv_tpu.data.datasets import FakeClassificationDataset


class config:
    network = "vit_base_patch16"
    num_classes = 1000
    input_image_size = 224
    model = BACKBONES.create(network, image_size=input_image_size,
                             num_classes=num_classes, global_pool=True,
                             drop_path_prob=0.1, use_flash_attention=True)
    train_criterion = LOSSES.create("CELoss")
    test_criterion = LOSSES.create("CELoss")
    train_dataset = FakeClassificationDataset(
        num_samples={n}, image_hw=224, num_classes=num_classes)
    test_dataset = FakeClassificationDataset(
        num_samples={batch}, image_hw=224, num_classes=num_classes)
    train_collater = ClassificationCollater()
    test_collater = ClassificationCollater()
    seed = 0
    batch_size = {batch}
    num_workers = 8
    optimizer = ("AdamW", {{"lr": 1e-3, "global_weight_decay": False,
                           "weight_decay": 0.05, "beta1": 0.9,
                           "beta2": 0.999,
                           "no_weight_decay_layer_name_list": [
                               "position_encoding", "cls_token"],
                           "lr_layer_decay": 0.75,
                           "lr_layer_decay_block_nums": 12,
                           "block_name": "blocks"}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 5, "min_lr": 1e-6}})
    epochs = 1
    print_interval = 1
    use_ema_model = False
'''


def _par_trainer(work_dir):
    """The classification train CLI (``Trainer``: ``initialize_multihost``,
    the mesh, each rank's rows, the engine, the evaluation summed over the
    ranks, the best epoch taken from rank 0, whole-tensor checkpoints) on
    ``PAR_TRAINER_CONFIG`` at ViT-B/16's full width, in this rank's process
    group. Returns (seconds, K1-K3 launches, the logged losses, the best
    metric)."""
    import os
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "train_config.py"), "w") as f:
        f.write(PAR_TRAINER_CONFIG.format(batch=PAR_BATCH,
                                          n=PAR_BATCH * PAR_STEPS))
    t0 = time.perf_counter()
    _reset_launches()
    best = cls_train_cli.main(["--work-dir", work_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fa.KERNEL_LAUNCHES[k] for k in TRAIN_KERNELS}
    _wide_kernels_only("the Trainer's ViT-B/16 epoch")
    with open(os.path.join(work_dir, "log", "train.log")) as f:
        log = f.read()
    losses = [float(v) for v in re.findall(r" loss (\S+) lr ", log)]
    for name in ("checkpoints/best", "checkpoints/latest/1.pt"):
        if not os.path.exists(os.path.join(work_dir, name)):
            raise RuntimeError(f"the Trainer wrote no {name}")
    return seconds, launches, losses, best


def _par_resnet(rank, world, sharded):
    """One engine step of the multichip check's first leg (ResNet-18, f32,
    64^2, global batch 16, SGD, accumulation 2, EMA) on this rank's rows,
    the model under FSDP2's ``fully_shard`` when ``sharded``: every
    parameter sharded on its first dim over the world, through the two
    arguments the Trainer's ``fsdp_shard`` passes (``shard_placement_fn``,
    ``ignored_params``). ``fsdp_shard`` itself is not called: on a mesh
    whose ``fsdp`` dim is 1 (one card) its rule shards no parameter, and
    FSDP2 would then hold every parameter as an ignored, plain tensor.
    Returns (loss, whole parameters)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    from simpleaicv_tpu_torch.parallel import mesh as pmesh
    model = init_params(BACKBONES.create("resnet18", num_classes=10,
                                         dtype=torch.float32),
                        torch.Generator().manual_seed(5)).cuda()
    if sharded:
        fully_shard(model, mesh=pmesh.make_mesh(
            pmesh.MeshConfig(data=1, fsdp=world)), ignored_params=set(),
            shard_placement_fn=lambda p: Shard(0))
    cfg = EngineConfig(accumulation_steps=2, use_ema=True, ema_decay=0.9)
    opt, _ = build_optimizer(OptimizerConfig(name="SGD", lr=0.01,
                                             momentum=0.9,
                                             weight_decay=1e-4),
                             SchedulerConfig("CosineLR", lr=0.01, epochs=10),
                             10, model)
    state = create_train_state(model, opt, cfg)
    g = torch.Generator(device="cuda").manual_seed(6)
    image = torch.randn(16, 64, 64, 3, generator=g, device="cuda")
    label = torch.randint(0, 10, (16,), generator=g, device="cuda")
    rows = torch.as_tensor(pmesh.rows_of(np.arange(16), rank, world, 2),
                           device="cuda")
    state, metrics = make_train_step(make_loss_fn(LOSSES.create("CELoss")),
                                     cfg)(state, {"image": image[rows],
                                                  "label": label[rows]})
    return metrics["loss"].item(), {
        n: pmesh.full_tensor(p).detach().clone()
        for n, p in model.named_parameters()}


def _parallel_rank(ref, ref_resnet, work_dir):
    """The parallel phase on this rank of the world (a process group is
    up): ViT-B/16 steps through the distributed engine against ``ref``
    (the same steps without a process group), the Trainer's epoch through
    the train CLI (in ``work_dir``), ``pipeline_vit`` against the plain
    forward, ring attention against full attention, and one FSDP2 step of
    ResNet-18 against ``ref_resnet`` (the plain step). Returns numbers and
    launch counts."""
    from simpleaicv_tpu_torch.parallel import mesh as pmesh
    from simpleaicv_tpu_torch.parallel.pipeline import make_pipeline_mesh
    from simpleaicv_tpu_torch.parallel.pipeline_vit import (
        make_vit_pipeline_apply, vit_stage_params)
    from simpleaicv_tpu_torch.parallel.ring_attention import (
        ring_attention_local)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = pmesh.rank(), pmesh.world_size()
    out = {"rank": rank, "world": world,
           "device": str(torch.device("cuda", torch.cuda.current_device()))}

    # ViT-B/16: each rank its rows of the global batch, one step each time
    t0 = time.perf_counter()
    model, losses, launches, out["step_ms"] = _par_vit_steps(
        pmesh.rows_of(np.arange(PAR_BATCH), rank, world))
    _wide_kernels_only("the distributed ViT train step")
    out["vit_s"] = time.perf_counter() - t0
    out["vit_launches"] = launches
    out["losses"] = losses
    params = dict(model.named_parameters())
    if world == 1:
        out["bit_equal"] = losses == ref["losses"] and all(
            torch.equal(params[n], t) for n, t in ref["params"].items())
    diffs = [((params[n].double() - t.to(params[n].device).double()).norm()
              / t.double().norm().clamp(min=1e-30)).item()
             for n, t in ref["params"].items()]
    out["vit_param_rel"] = max(diffs)
    del model, params
    torch.cuda.empty_cache()

    # the Trainer through the train CLI, at full width
    (out["trainer_s"], out["trainer_launches"], out["trainer_losses"],
     out["trainer_best"]) = _par_trainer(work_dir)
    torch.cuda.empty_cache()
    model = _vit_b16(use_flash_attention=True, seed=3).cuda()

    # the pipelined ViT (eval) over the world's stages against the forward
    mesh = make_pipeline_mesh(world)
    stage = vit_stage_params(model, world, mesh)
    apply = make_vit_pipeline_apply(model, mesh, n_micro=PAR_MICRO)
    g = torch.Generator(device="cuda").manual_seed(7)
    image = torch.randn(PAR_BATCH, 224, 224, 3, generator=g, device="cuda")
    with torch.no_grad():
        model.eval()
        want = model(image).float()
        _reset_launches()
        got = apply(stage, image).float()
        out["pipe_launches"] = {k: fa.KERNEL_LAUNCHES[k]
                                for k in TRAIN_KERNELS}
        # a second, warm call for its time (and the same bits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = apply(stage, image).float()
        torch.cuda.synchronize()
        out["pipe_ms"] = (time.perf_counter() - t0) * 1e3
        out["pipe_repeat"] = bool(torch.equal(again, got))
    _wide_kernels_only("the pipelined ViT")
    out["pipe_rel"] = ((got - want).abs().max()
                       / want.abs().max()).item()
    del model, stage, apply
    torch.cuda.empty_cache()

    # ring attention over the world against full attention, with gradients
    g = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, dout = (torch.randn(PAR_RING, generator=g, device="cuda")
                     for _ in range(4))
    n_local = PAR_RING[2] // world
    part = slice(rank * n_local, (rank + 1) * n_local)
    for _ in range(2):  # the second, warm, is timed and kept
        ins = [t[:, :, part].clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = ring_attention_local(*ins)
        o.backward(dout[:, :, part])
        torch.cuda.synchronize()
        out["ring_ms"] = (time.perf_counter() - t0) * 1e3
    full = [t.clone().requires_grad_() for t in (q, k, v)]
    scores = torch.einsum("bhnd,bhmd->bhnm", full[0],
                          full[1]) * PAR_RING[3]**-0.5
    want = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(scores, -1),
                        full[2])
    want.backward(dout)
    del scores
    out["ring_rel"] = max(
        ((a - b[:, :, part]).abs().max() / b.abs().max()).item()
        for a, b in [(o.detach(), want.detach())]
        + [(t.grad, f.grad) for t, f in zip(ins, full)])
    del q, k, v, dout, ins, full, o, want
    torch.cuda.empty_cache()

    # one FSDP2 step of ResNet-18 against the plain step
    loss, tensors = _par_resnet(rank, world, sharded=True)
    out["fsdp_loss"] = loss
    ref_loss, ref_tensors, start = ref_resnet
    out["fsdp_loss_rel"] = abs(loss - ref_loss) / abs(ref_loss)
    out["fsdp_update_rel"] = max(
        ((tensors[n] - ref_tensors[n]).double().norm()
         / (ref_tensors[n] - start[n]).double().norm().clamp(min=1e-30))
        .item() for n in tensors)
    return out


def phase_parallel(card):
    """The parallel layer on the card: a world of one process a card (at
    most 4) under NCCL through the port's launcher (a world of one runs in
    this process through a ``FileStore``). Returns {path: launches}."""
    import os
    import tempfile
    from simpleaicv_tpu_torch.parallel import multihost
    world = min(torch.cuda.device_count(), 4)
    print(f"parallel: world {world}, backend nccl, card {card}", flush=True)
    # the same steps without a process group, twice: the reference, and
    # the control that shows two such runs give the same bits
    model, ref_losses, _, ref_ms = _par_vit_steps(np.arange(PAR_BATCH))
    ref = {"losses": ref_losses,
           "params": {n: p.detach().clone()
                      for n, p in model.named_parameters()}}
    del model
    model, losses, _, _ = _par_vit_steps(np.arange(PAR_BATCH))
    if losses != ref_losses or not all(
            torch.equal(p, ref["params"][n])
            for n, p in model.named_parameters()):
        raise RuntimeError("two runs of the same steps differ")
    del model
    start = {n: p.detach().clone().cuda() for n, p in init_params(
        BACKBONES.create("resnet18", num_classes=10, dtype=torch.float32),
        torch.Generator().manual_seed(5)).named_parameters()}
    ref_loss, ref_tensors = _par_resnet(0, 1, sharded=False)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        if world == 1:
            results = [multihost.run_here(
                _parallel_rank, work, ref, (ref_loss, ref_tensors, start),
                os.path.join(work, "trainer"), backend="nccl",
                timeout=120)]
        else:
            cpu = lambda d: {n: t.cpu() for n, t in d.items()}  # noqa: E731
            results = multihost.run_world(
                "chip_smoke:_parallel_rank", world, work,
                ({"losses": ref_losses, "params": cpu(ref["params"])},
                 (ref_loss, cpu(ref_tensors), cpu(start)),
                 os.path.join(work, "trainer")),
                backend="nccl", timeout=300)
    for r in results:
        print(f"parallel rank {r['rank']} of {r['world']} on {r['device']}: "
              f"ViT-B/16 b{PAR_BATCH} flash, {PAR_STEPS} distributed engine "
              f"steps in {r['vit_s']:.2f} s with the model's build, "
              f"{r['step_ms']:.2f} ms a step after the first ({ref_ms:.2f} "
              f"without a process group), losses "
              f"{' '.join(f'{v:.5f}' for v in r['losses'])} (without a "
              f"process group {' '.join(f'{v:.5f}' for v in ref_losses)}), "
              f"largest parameter relative difference "
              f"{r['vit_param_rel']:.3g}"
              + (f", bit for bit equal: {r['bit_equal']}"
                 if "bit_equal" in r else "")
              + f"; K1-K3 launches {r['vit_launches']}", flush=True)
        print(f"parallel rank {r['rank']}: the train CLI's Trainer, "
              f"ViT-B/16 b{PAR_BATCH} flash, one epoch of {PAR_STEPS} steps "
              f"and a {PAR_BATCH}-image evaluation in {r['trainer_s']:.2f} s "
              f"with the model's build and both checkpoints, logged losses "
              f"{' '.join(f'{v:.4f}' for v in r['trainer_losses'])}, best "
              f"acc1 {r['trainer_best']:.4f}; K1-K3 launches "
              f"{r['trainer_launches']}", flush=True)
        print(f"parallel rank {r['rank']}: pipeline_vit ViT-B/16 eval b"
              f"{PAR_BATCH}, {PAR_MICRO} microbatches over {world} stages in "
              f"{r['pipe_ms']:.1f} ms (warm; the same bits twice: "
              f"{r['pipe_repeat']}), logits within {r['pipe_rel']:.3g} of "
              f"the largest plain logit; launches {r['pipe_launches']}; ring "
              f"attention {list(PAR_RING)} f32 forward and backward over "
              f"{world} ranks in {r['ring_ms']:.1f} ms (warm), within "
              f"{r['ring_rel']:.3g} of full attention (output and dq, dk, "
              f"dv); FSDP2 ResNet-18 step loss {r['fsdp_loss']:.6f}, "
              f"{r['fsdp_loss_rel']:.3g} from the plain step's, updates "
              f"within {r['fsdp_update_rel']:.3g}", flush=True)
        # world of one: every path equals the run without a process group
        # bit for bit; more ranks sum in other orders (bf16 steps of a
        # seeded ViT-B/16: 1% of a parameter's norm at most)
        if world == 1 and not r["bit_equal"]:
            raise RuntimeError("the world of one differs from the steps "
                               "without a process group")
        if not r["vit_param_rel"] <= (0.0 if world == 1 else 1e-2):
            raise RuntimeError("the distributed ViT steps part from the "
                               "steps without a process group")
        if any(r["vit_launches"][k] != 12 * PAR_STEPS for k in TRAIN_KERNELS):
            raise RuntimeError(f"the distributed ViT step did not launch "
                               f"each flash kernel 12 times a step: "
                               f"{r['vit_launches']}")
        # K1-K3 12 times a train step, K1 12 more for the one test batch
        if (r["trainer_launches"] != {
                "flash_attention_fwd": 12 * (PAR_STEPS + 1),
                "flash_attention_dq": 12 * PAR_STEPS,
                "flash_attention_dkv": 12 * PAR_STEPS}
                or len(r["trainer_losses"]) != PAR_STEPS
                or not np.isfinite(r["trainer_losses"]).all()
                or not np.isfinite(r["trainer_best"])):
            raise RuntimeError(f"the Trainer's epoch: launches "
                               f"{r['trainer_launches']}, losses "
                               f"{r['trainer_losses']}, best "
                               f"{r['trainer_best']}")
        want_k1 = 12 // world * PAR_MICRO
        if r["pipe_launches"] != {"flash_attention_fwd": want_k1,
                                  "flash_attention_dq": 0,
                                  "flash_attention_dkv": 0}:
            raise RuntimeError(f"pipeline_vit launched "
                               f"{r['pipe_launches']}, want K1 {want_k1}")
        # bf16 through 12 blocks on microbatches of 32 against batches of
        # 128 (other GEMM tilings): 2% of the largest logit
        if not (r["pipe_rel"] <= 2e-2 and r["pipe_repeat"]):
            raise RuntimeError("pipeline_vit disagrees with the forward")
        if not r["ring_rel"] <= 1e-4:
            raise RuntimeError("ring attention disagrees with full "
                               "attention")
        if not (r["fsdp_loss_rel"] <= 1e-5 and r["fsdp_update_rel"] <= 1e-3):
            raise RuntimeError("the FSDP2 step disagrees with the plain step")
    sums = lambda key: {k: sum(r[key][k] for r in results)  # noqa: E731
                        for k in TRAIN_KERNELS}
    return {"parallel_vit_train": sums("vit_launches"),
            "parallel_trainer": sums("trainer_launches"),
            "parallel_pipeline_vit": sums("pipe_launches")}


# ------------------------------- export -------------------------------

EXPORT_VIT_BATCH = 8
# the exported programs' outputs against the eager model's: bf16 models,
# the same kernels and the same ATen operators, so the largest difference
# stays within a bf16 step (2^-8) of the output's largest value
EXPORT_TOL = 1e-2


def _op_cases_on_card():
    """(name, operator, arguments) of the seven kernels' operators at small
    shapes on the card, bf16 where the kernel takes it; the forwards'
    inputs require gradients, so that opcheck runs their autograd."""
    g = torch.Generator(device="cuda").manual_seed(90)

    def t(*shape, grad=False, dt=torch.bfloat16):
        return torch.randn(shape, device="cuda", generator=g).to(
            dt).requires_grad_(grad)

    q, k, v = (t(1, 2, 200, 64, grad=True) for _ in range(3))
    o, lse = fa._FLASH_FWD(q.detach(), k.detach(), v.detach())
    rq, rk, rv = (t(2, 256, 64, grad=True) for _ in range(3))
    rh, rw = (t(2, 256, 16, grad=True, dt=torch.float32) for _ in range(2))
    ro, rlse = fa._RELPOS_FWD(*(x.detach() for x in (rq, rk, rv, rh, rw)))
    do = t(2, 256, 64)
    relpos_bwd = (*(x.detach() for x in (rq, rk, rv, rh, rw)), do, rlse,
                  (do.float() * ro.float()).sum(-1))
    shapes = [16, 16, 8, 8]
    value = t(2, 320, 8, 32, grad=True, dt=torch.float32)
    loc = torch.rand((2, 50, 8, 2, 4, 2), device="cuda",
                     generator=g).requires_grad_()
    wts = torch.rand((2, 50, 8, 2, 4), device="cuda",
                     generator=g).requires_grad_()
    return [("K1", fa._FLASH_FWD, (q, k, v)),
            ("K2+K3", fa._FLASH_BWD, (q.detach(), k.detach(), v.detach(), o,
                                      lse, t(1, 2, 200, 64))),
            ("K4", fa._RELPOS_FWD, (rq, rk, rv, rh, rw)),
            ("K5", fa._RELPOS_DQ, relpos_bwd),
            ("K6", fa._RELPOS_DKV, relpos_bwd),
            ("K7", msda._MSDA_FWD, (value, loc, wts, shapes)),
            ("K7b", msda._MSDA_BWD, (value.detach(), loc.detach(),
                                     wts.detach(),
                                     t(2, 50, 256, dt=torch.float32),
                                     shapes))]


def _launched():
    return {k: v for counts in (fa.KERNEL_LAUNCHES, msda.KERNEL_LAUNCHES)
            for k, v in counts.items() if v}


def _max_rel(got, want):
    if isinstance(want, dict):
        return max(_max_rel(got[k], v) for k, v in want.items()
                   if torch.is_tensor(v) and v.is_floating_point())
    return _rel_err(got, want)


def _export_case(card, label, model, image, batch, expected, work_dir):
    """Exports ``model``'s evaluation forward through the export tool's
    functions, saves and loads the program, runs it on a seeded image
    batch with the launches counted, and holds it to the eager model.
    Returns (the launches, the loaded program, its input)."""
    t0 = time.perf_counter()
    program = export_tool.export_model(model, image, batch, "cuda")
    export_s = time.perf_counter() - t0
    nodes = export_tool.simpleaicv_nodes(program)
    path = f"{work_dir}/{label}.pt2"
    torch.export.save(program, path)
    loaded = export_tool.load_program(path)
    x = torch.randn((batch, image, image, 3), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(91))
    run = loaded.module()
    with torch.no_grad():
        _reset_launches()
        out = run(x)
        torch.cuda.synchronize()
        launches = _launched()
        _wide_kernels_only(f"the exported {label}")
        want = model(x)
        timer, eager_timer = tracing.StepTimer(), tracing.StepTimer()
        for _ in range(4):
            timer.start()
            timer.stop(run(x) if label != "dino" else run(x)["pred_boxes"])
            eager_timer.start()
            eager_timer.stop(model(x) if label != "dino"
                             else model(x)["pred_boxes"])
    err = _max_rel(out, want)
    equal = (torch.equal(out, want) if torch.is_tensor(want) else all(
        torch.equal(out[k], v) for k, v in want.items() if torch.is_tensor(v)))
    print(f"export {label} [{card}]: exported in {export_s:.1f} s, "
          f"{len(program.graph.nodes)} nodes, {len(nodes)} calls of "
          f"{sorted(set(nodes))}; saved ({os.path.getsize(path)} bytes) and "
          f"loaded; launches {launches}; max |exported - eager| "
          f"{err:.3e} of the largest value (tolerance {EXPORT_TOL}; "
          f"bit-equal: {equal}); a forward {timer.summary()['p50_s'] * 1e3:.2f}"
          f" ms exported, {eager_timer.summary()['p50_s'] * 1e3:.2f} ms "
          f"eager (host clock, medians of 3 after one)", flush=True)
    if launches != expected:
        raise RuntimeError(f"the exported {label} launched {launches}, "
                           f"expected {expected}")
    if len(nodes) != sum(expected.values()):
        raise RuntimeError(f"the exported {label} graph holds {nodes}")
    if err > EXPORT_TOL:
        raise RuntimeError(f"the exported {label} disagrees with the eager "
                           f"model")
    return launches, run, x


def phase_export(card):
    """The hand kernels as ``torch.library`` operators: opcheck on each of
    the seven at a small shape on the card; ViT-B/16 with flash attention
    at 224^2 (batch 8; K1 12 launches), SAM-B's image encoder at 1024^2
    (K4 on its 4 global layers) and DINO-DETR R50 at 1024^2, batch 1 (K7,
    12 launches) exported with ``tools/convert_to_export.py``'s functions,
    saved, loaded, run with their launches counted and held to the eager
    models; one exported ViT run under ``core/tracing.py::trace``, whose
    Chrome trace must name K1's kernel symbol."""
    import tempfile
    for label, op, args in _op_cases_on_card():
        t0 = time.perf_counter()
        results = torch.library.opcheck(op, args)
        if any(r != "SUCCESS" for r in results.values()):
            raise RuntimeError(f"opcheck {op} failed: {results}")
        print(f"opcheck {op} ({label}) on the card: {results} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    paths = {}
    with tempfile.TemporaryDirectory() as work_dir:
        vit = _vit_b16(use_flash_attention=True).cuda().eval()
        paths["export_vit"], run, x = _export_case(
            card, "vit", vit, 224, EXPORT_VIT_BATCH,
            {"flash_attention_fwd": 12}, work_dir)
        with tracing.trace(f"{work_dir}/trace"), torch.no_grad():
            run(x)
            torch.cuda.synchronize()
        with open(f"{work_dir}/trace/trace.json") as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        k1 = sorted(n for n in names if "flash_fwd_tma" in n)
        op_calls = sum("simpleaicv::flash_attention_fwd" in n for n in names)
        print(f"trace of the exported ViT-B/16 run: {len(names)} event "
              f"names; K1's kernel {k1[:1]}; the operator's host calls "
              f"named: {op_calls > 0}", flush=True)
        if not k1:
            raise RuntimeError("the trace names no K1 kernel (flash_fwd_tma)")
        del vit, run, x
        sam = _sam_b(use_flash_attention=True).cuda().eval()
        paths["export_sam"], _, _ = _export_case(
            card, "sam_encoder", sam.image_encoder, 1024, 1,
            {"flash_attention_relpos_fwd": 4}, work_dir)
        del sam
        dino = _dino_model().cuda().eval()
        paths["export_dino"], _, _ = _export_case(
            card, "dino", dino, DINO_IMAGE, 1, {"msda_fwd": 12}, work_dir)
        del dino
    torch.cuda.empty_cache()
    return paths


def _timed(name, fn, *args):
    """``fn(*args)``, printing the seconds it took under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


_PHASE_RUNNER = """
import sys
import chip_smoke as cs
card = cs.phase_device()
for name in sys.argv[1:]:
    cs._timed(name, getattr(cs, "phase_" + name), card)
"""


def run_phases(argv):
    """``--phases a,b [--tree DIR]``: phases ``a`` and ``b`` of ``DIR``'s
    script in a process of their own; returns its exit code."""
    import argparse
    import os
    parser = argparse.ArgumentParser(prog="chip_smoke.py")
    parser.add_argument("--phases", required=True)
    parser.add_argument("--tree",
                        default=os.path.dirname(os.path.abspath(__file__)))
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    env = dict(os.environ, PYTHONPATH=tree)
    return subprocess.run([sys.executable, "-c", _PHASE_RUNNER,
                           *args.phases.split(",")], cwd=tree,
                          env=env).returncode


def main():
    if len(sys.argv) > 1:
        return run_phases(sys.argv[1:])
    t_start = time.perf_counter()
    card = phase_device()
    kernels = _timed("kernels", phase_kernels, card)
    serving = _timed("serving", phase_serving, card)
    http_serving = _timed("http_serving", phase_http_serving, card)
    vit = _timed("training", phase_training, card)
    sam, sam_ips = _timed("sam_training", phase_sam_training, card)
    msda_kernels, dcn = _timed("msda_kernels", phase_msda_kernels, card)
    kernels += msda_kernels
    dino, dino_ips, dino_auction = _timed("dino_training",
                                          phase_dino_training, card)
    exported = _timed("export", phase_export, card)
    probes, probe_launches = _timed("probes", phase_probes, card)
    kernels += probes
    resnet, resident_ips = _timed(
        "resnet50_training", phase_resnet50_training, card,
        next(k["ms"] for k in probes if k["name"] == "probe_mm_stats"))
    _timed("cli", phase_cli, card, resident_ips)
    sam_cli = _timed("sam_cli", phase_sam_cli, card, sam_ips)
    dino_cli = _timed("dino_cli", phase_dino_cli, card, dino_ips)
    seg, seg_ips = _timed("seg_train", phase_seg_train, card)
    seg_cli = _timed("seg_cli", phase_seg_cli, card, seg_ips)
    pfan, pfan_cli = _timed("pfan_cli", phase_pfan_cli, card)
    seg_learns = _timed("seg_learns", phase_seg_learns, card)
    fcos, _ = _timed("fcos_train", phase_fcos_train, card)
    retina, _ = _timed("retina_train", phase_retina_train, card)
    sapiens, sapiens_ips = _timed("sapiens_train", phase_sapiens_train, card)
    parity = _timed("dense_parity", phase_dense_parity, card)
    dense_cli = _timed("dense_cli", phase_dense_cli, card, sapiens_ips)
    fcos_learns = _timed("fcos_learns", phase_fcos_learns, card)
    slice_15 = _timed("slice_15", _slice_15, card)
    slice_16 = _timed("slice_16", _slice_16, card)
    slice_17 = _timed("slice_17", _slice_17, card)
    slice_18 = _timed("slice_18", _slice_18, card)
    slice_19 = _timed("slice_19", _slice_19, card, resident_ips)
    prepared = _timed("prepared_data", phase_prepared_data, card, sam_ips)
    parallel = _timed("parallel", phase_parallel, card)
    # one count per kernel and path; the forward rel-pos kernel lies on two
    # paths (4 launches per served request, 8 per SAM train step and 4 per
    # refinement prediction), so its ``launches`` is their sum. The ResNet-50
    # step launches no hand kernel (cuDNN convolutions, plain-PyTorch
    # BatchNorm); its counts are read all the same, and the classification
    # CLIs, which run the same model in their own processes, are checked by
    # their output. The SAM and DINO-DETR CLIs run in this process: their
    # counts are their own paths'. The DeepLabV3+, PFAN, dense-detection and
    # Sapiens paths launch no hand kernel, which their phases check; nor do
    # the MAE, distillation, device-augmentation and slice-15 CLI paths.
    # ViT-MoE's step launches K1-K3 12 times each (``moe_train``). The SAM
    # distillation and matting paths launch K4-K6 (slice 16; the CLIs'
    # counts are the SAM-B matting run's), PFAN matting none; nor do the
    # instance-segmentation and diffusion paths (slice 17) and the OCR
    # paths (slice 18), nor the slice-19 backbones, family variants and
    # packed loader. The HTTP server launches K4 4 times a SAM request and
    # no hand kernel on its eleven other endpoints. DCNv2 launches one K7
    # and one K7b a layer, the auction-matcher DINO-DETR steps 12 + 12 a
    # step, and the three exported programs K1 12, K4 4 and K7 12 a
    # forward. SAM-B trained from the sam-masks conversion launches K4-K6
    # through the CLIs in this process (``prepared_sam_cli``); the OCR
    # steps on the prepared sets launch none (``prepared_ocr``).
    paths = {"sam_serving": serving, "http_serving": http_serving,
             "vit_train": vit, "sam_train": sam,
             "dino_train": dino, "dino_auction_train": dino_auction,
             "dcnv2": dcn, **exported, "roofline_probes": probe_launches,
             "resnet50_train": resnet, "sam_cli": sam_cli,
             "dino_cli": dino_cli, "seg_train": seg, "seg_cli": seg_cli,
             "pfan_train": pfan, "pfan_cli": pfan_cli,
             "seg_learns": seg_learns, "fcos_train": fcos,
             "retina_train": retina, "sapiens_train": sapiens,
             "dense_parity": parity, "dense_cli": dense_cli,
             "fcos_learns": fcos_learns, **slice_15, **slice_16,
             **slice_17, **slice_18, **slice_19, **prepared, **parallel}
    for kernel in kernels:
        by_path = {path: counts[kernel["name"]]
                   for path, counts in paths.items()
                   if counts.get(kernel["name"], 0) > 0}
        kernel["launches"] = sum(by_path.values())
        kernel["launches_by_path"] = by_path
        if kernel["launches"] < 1:
            raise RuntimeError(f"{kernel['name']} was not launched on a "
                               f"main path")
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
