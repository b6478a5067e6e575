#!/usr/bin/env python3
"""Drives the PyTorch port (``simpleaicv_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:
  1. device: requires a CUDA card and prints its name and power limit;
  2. kernels: builds every hand kernel from the sources in the checkout (one
     nvcc per source, started together) and holds each against its plain
     PyTorch version on the card, at the shapes the main paths give it and
     at edge shapes, and times it beside its plain version, a PyTorch
     library call and its bound;
  3. serving: serves SAM-B 1024x1024 interactive-segmentation requests
     through ``SAMPredictor`` on the card, counts the kernel launches of
     that run, and compares the masks with the same requests on the plain
     path;
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
     gradients with the einsum attention path.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

from simpleaicv_tpu_torch.core.engine import (EngineConfig,
                                              create_train_state,
                                              make_train_step)
from simpleaicv_tpu_torch.core.optim import OptimizerConfig, build_optimizer
from simpleaicv_tpu_torch.core.registry import BACKBONES, LOSSES, MODELS
from simpleaicv_tpu_torch.core.schedule import SchedulerConfig
from simpleaicv_tpu_torch.data.interactive_segmentation import (
    FakeSAMSegmentationDataset, SAMBatchCollater)
from simpleaicv_tpu_torch.demo.predictors import SAMPredictor, bounding_rect
from simpleaicv_tpu_torch.models.common import init_params
from simpleaicv_tpu_torch.ops import _build
from simpleaicv_tpu_torch.ops import flash_attention as fa
from simpleaicv_tpu_torch.tasks import interactive_segmentation as sam_task
from simpleaicv_tpu_torch.tasks.classification import make_loss_fn

# H100 SXM dense peaks (NVIDIA data sheet) at the full 700 W power limit.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12


def _cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    heads in one launch: kernel, plain version, library call, bound."""
    k_h = k_w = d = 64
    n, dtype = k_h * k_w, torch.bfloat16
    args = _relpos_bwd_inputs(bh, k_h, k_w, d, dtype, seed=49)
    q, k, v, rel_h, rel_w, do = args[:6]
    # the library call: SDPA with the materialised bf16 bias and its autograd
    # backward, which gives dq, dk, dv and the bias gradient in one call
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql, kl, vl = (t.reshape(bh // 12, 12, n, d).detach().requires_grad_()
                  for t in (q, k, v))
    bias = _sdpa_bias(rel_h, rel_w, bh, n).requires_grad_()
    o_lib = sdpa(ql, kl, vl, attn_mask=bias)
    lib_bwd = _cuda_ms(lambda: torch.autograd.grad(
        o_lib, (ql, kl, vl, bias), do.reshape(ql.shape), retain_graph=True),
        10)
    del o_lib, bias, ql, kl, vl
    tensor = bh * n * d * 2                       # one bf16 [BH, N, d]
    tables = bh * n * (k_h + k_w) * 4             # rel_h and rel_w, f32
    rows = bh * n * 4                             # one f32 [BH, N]
    pairs = 2.0 * n * n * d * bh                  # one product's operations
    cases = [
        ("flash_attention_relpos_dq", 276, fa._flash_relpos_dq_cuda,
         fa.flash_attention_relpos_dq_reference,
         3 * pairs, 5 * tensor + 2 * tables + 2 * rows,
         max(errs[key] for key in ("dq", "drh", "drw"))),
        ("flash_attention_relpos_dkv", 312, fa._flash_relpos_dkv_cuda,
         fa.flash_attention_relpos_dkv_reference,
         4 * pairs, 6 * tensor + tables + 2 * rows,
         max(errs["dk"], errs["dv"])),
    ]
    kernels = []
    for name, line, kernel_fn, plain_fn, flops, nbytes, err in cases:
        ms = _cuda_ms(lambda: kernel_fn(*args), 20)
        plain_ms = _cuda_ms(lambda: _by_head_chunks(plain_fn, args), 5)
        bound_ms, bound_by = _bound(flops, nbytes, dtype)
        print(f"{name} SAM-B bf16 BH={bh} [{card}]: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa+bias backward {lib_bwd:.4f} "
              f"ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "simpleaicv_tpu_torch/ops/csrc/flash_relpos_bwd.cu",
            "replaces": f"simpleaicv_tpu/ops/flash_attention.py:{line}",
            "launches": None, "shape": f"BH={bh} N={n} d={d} bf16",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_bwd})
    return kernels


def phase_relpos_bwd_kernels(card):
    """K5 and K6 (rel-pos dq with drh and drw, and dk/dv) against their plain
    versions at the four rel-pos shapes and at the training path's (SAM-B's
    global layer for a batch of 8, bf16), then their times at the training
    path's shape and, beside them, for one image."""
    names = ("dq", "drh", "drw", "dk", "dv")
    shape_errs, failed = {}, []
    cases = [(*shape, dtype, 40 + i)
             for i, shape in enumerate(RELPOS_SHAPES)
             for dtype in (torch.float32, torch.bfloat16)]
    cases.append(("sam_b_train", SAM_TRAIN_BH, 64, 64, 64, torch.bfloat16,
                  48))
    for name, bh, k_h, k_w, d, dtype, seed in cases:
        args = _relpos_bwd_inputs(bh, k_h, k_w, d, dtype, seed)
        got = (*fa._flash_relpos_dq_cuda(*args),
               *fa._flash_relpos_dkv_cuda(*args))
        want = (*_by_head_chunks(fa.flash_attention_relpos_dq_reference,
                                 args),
                *_by_head_chunks(fa.flash_attention_relpos_dkv_reference,
                                 args))
        torch.cuda.synchronize()
        errs = {key: (a.float() - w.float()).abs().max().item()
                for key, a, w in zip(names, got, want)}
        # drh and drw are f32 whatever the inputs: 1e-4; dq, dk, dv as
        # the plain flash kernels' gradients
        tols = {key: _flash_atol(key, w, w.dtype)
                for key, w in zip(names, want)}
        print(f"kernel check relpos bwd {name} BH={bh} grid={k_h}x{k_w} "
              f"d={d} {str(dtype)[6:]}: " + " ".join(
                  f"max|{key}-ref|={e:.3e} (atol {tols[key]:.3e})"
                  for key, e in errs.items()), flush=True)
        failed += [f"{name} {dtype} {key}" for key, e in errs.items()
                   if not e <= tols[key]]
        if dtype == torch.bfloat16:
            shape_errs[name] = errs
        del args, got, want
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
        "library_ms")}


def _bound(flops, nbytes, dtype):
    """(bound_ms, bound_by): the larger of the operations over the card's
    peak rate for their type and the bytes over its memory rate."""
    op_ms = flops / PEAK_FLOPS[dtype] * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


def _flash_inputs(b, h, n, d, dtype, seed):
    """q, k, v as ViT hands them over ([B, H, N, d] views of one fused
    [B, N, 3, H, d] projection) and dO as autograd hands it back (a
    [B, H, N, d] view of [B, N, H, d] storage)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g, device="cuda").to(dtype)
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


def phase_flash_kernels(card):
    """K1-K3 (flash forward, dq, dk/dv) against their plain versions, then
    their times at the ViT-B/16 batch-128 training shape."""
    # (name, B, H, N, d): ViT-B/16 at batch 128, ViT-H/14 (d 80, N 257), a
    # multiple of the tiles, and a tail (N = 5, d = 40 padded in the kernel)
    shapes = [("vit_b_b128", 128, 12, 197, 64), ("vit_h", 8, 16, 257, 80),
              ("n256", 2, 4, 256, 64), ("tail_n5", 2, 3, 5, 40)]
    names = ("o", "lse", "dq", "dk", "dv")
    main_errs, failed = None, []
    for i, (name, b, h, n, d) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            args = _flash_inputs(b, h, n, d, dtype, seed=20 + i)
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

    # times at the training shape: ViT-B/16, batch 128, bf16
    _, b, h, n, d = shapes[0]
    bh, dtype = b * h, torch.bfloat16
    q, k, v, do = _flash_inputs(b, h, n, d, dtype, seed=29)
    o, lse = fa._flash_fwd_cuda(q, k, v)
    delta = (do.float() * o.float()).sum(dim=-1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = sdpa(ql, kl, vl)
    lib_fwd = _cuda_ms(lambda: sdpa(q, k, v), 20)
    lib_bwd = _cuda_ms(lambda: torch.autograd.grad(
        o_lib, (ql, kl, vl), do, retain_graph=True), 20)
    tensor, rows = bh * n * d * 2, bh * n * 4  # one bf16 tensor, one f32 row
    pairs = 2.0 * n * n * d * bh               # one product's operations
    cases = [
        ("flash_attention_fwd", "flash_fwd.cu", 34,
         lambda: fa._flash_fwd_cuda(q, k, v),
         lambda: fa.flash_attention_reference(q, k, v),
         2 * pairs, 4 * tensor + rows, lib_fwd,
         max(main_errs["o"], main_errs["lse"])),
        ("flash_attention_dq", "flash_bwd.cu", 64,
         lambda: fa._flash_dq_cuda(q, k, v, do, lse, delta),
         lambda: fa.flash_attention_dq_reference(q, k, v, do, lse, delta),
         3 * pairs, 5 * tensor + 2 * rows, lib_bwd, main_errs["dq"]),
        ("flash_attention_dkv", "flash_bwd.cu", 88,
         lambda: fa._flash_dkv_cuda(q, k, v, do, lse, delta),
         lambda: fa.flash_attention_dkv_reference(q, k, v, do, lse, delta),
         4 * pairs, 6 * tensor + 2 * rows, lib_bwd,
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
    for name, source, line, kernel_fn, plain_fn, flops, nbytes, lib, err in \
            cases:
        ms = _cuda_ms(kernel_fn, 20)
        plain_ms = _cuda_ms(plain_fn, 5)
        bound_ms, bound_by = _bound(flops, nbytes, dtype)
        print(f"{name} ViT-B/16 b128 bf16 [{card}]: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library {lib:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} "
              f"({nbytes / ms / 1e9:.3f} TB/s, {flops / ms / 1e9:.1f} "
              f"TFLOP/s)", flush=True)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"simpleaicv_tpu_torch/ops/csrc/{source}",
            "replaces": f"simpleaicv_tpu/ops/flash_attention.py:{line}",
            "launches": None, "shape": f"BH={bh} N={n} d={d} bf16",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib})
    return kernels


def phase_kernels(card):
    t0 = time.perf_counter()
    logs = _build.build(["flash_relpos_fwd", "flash_relpos_bwd", "flash_fwd",
                         "flash_bwd"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
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

    # the forward rel-pos kernel lies on two paths: its entry reads the
    # served shape (one image) and carries the training path's beside it
    relpos = _relpos_fwd_times(card, 12, shape_errs["sam_b"])
    relpos["other_shapes"] = [_reading(_relpos_fwd_times(
        card, SAM_TRAIN_BH, shape_errs["sam_b_train"]))]
    return (phase_flash_kernels(card) + [relpos]
            + phase_relpos_bwd_kernels(card))


def _relpos_fwd_times(card, bh, err):
    """K4 at SAM-B's global layer (bf16, N 4096, d 64) with ``bh`` heads in
    one launch: kernel, plain version, library call, bound."""
    k_h = k_w = d = 64
    n = k_h * k_w
    args = _relpos_inputs(bh, k_h, k_w, d, torch.bfloat16, 9)
    q, k, v, rel_h, rel_w = args
    ms = _cuda_ms(lambda: fa.flash_attention_relpos(*args), 20)
    plain_ms = _cuda_ms(lambda: _by_head_chunks(
        fa.flash_attention_relpos_reference, args), 5)
    bias = _sdpa_bias(rel_h, rel_w, bh, n)
    ql, kl, vl = (t.reshape(bh // 12, 12, n, d) for t in (q, k, v))
    library_ms = _cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=bias), 10)
    del bias
    flops = 4.0 * n * n * d * bh
    nbytes = 4 * bh * n * d * 2 + bh * n * (k_h + k_w + 1) * 4
    bound_ms, bound_by = _bound(flops, nbytes, torch.bfloat16)
    print(f"flash_attention_relpos_fwd SAM-B bf16 BH={bh} [{card}]: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa+bias {library_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)",
          flush=True)
    return {"name": "flash_attention_relpos_fwd", "route": "cuda",
            "source": "simpleaicv_tpu_torch/ops/csrc/flash_relpos_fwd.cu",
            "replaces": "simpleaicv_tpu/ops/flash_attention.py:247",
            "launches": None, "shape": f"BH={bh} N={n} d={d} bf16",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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
    for name in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[name] = 0


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
    kinds = []
    for _ in range(count):
        r = rng.random()
        kinds.append("point" if r < PROMPT_PROBS["point"] else
                     "box" if r < PROMPT_PROBS["point"] + PROMPT_PROBS["box"]
                     else "mask")
    return kinds


def _keep_prompt(batch, kind):
    return {k: (v if not k.startswith("prompt_") or k == f"prompt_{kind}"
                else None) for k, v in batch.items()}


def _launch_delta(before):
    return {k: fa.KERNEL_LAUNCHES[k] - before[k] for k in SAM_KERNELS}


def _sam_train_batch(state, step, predict, batch, kind, click_generator,
                     records):
    """The trainer's loop body for one batch: one optimizer step, or
    ``DECODER_POINT_ITERS`` of them on a point batch with a no-grad
    best-mask prediction and one new click at an error pixel between two
    steps. Appends (kind, what, ms, loss or None) to ``records`` and fails
    on a launch count other than the expected one."""
    batch = _keep_prompt(batch, kind)
    iters = DECODER_POINT_ITERS if kind == "point" else 1
    for it in range(iters):
        before = dict(fa.KERNEL_LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, seed=0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if _launch_delta(before) != SAM_STEP_LAUNCHES:
            raise RuntimeError(f"a {kind} step launched "
                               f"{_launch_delta(before)}, expected "
                               f"{SAM_STEP_LAUNCHES}")
        loss = metrics["loss"].item()
        if not np.isfinite(loss) or float(metrics["skipped"]) != 0.0:
            raise RuntimeError(f"{kind} step: loss {loss}, skipped "
                               f"{float(metrics['skipped'])}")
        records.append((kind, "step", ms, loss))
        if it + 1 < iters:
            before = dict(fa.KERNEL_LAUNCHES)
            t0 = time.perf_counter()
            masks = predict(state.model, batch["image"],
                            batch["prompt_point"])
            points = sam_task.sample_error_region_points(
                masks, batch["mask"], batch["prompt_point"],
                generator=click_generator)
            torch.cuda.synchronize()
            records.append((kind, "refine",
                            (time.perf_counter() - t0) * 1e3, None))
            if _launch_delta(before) != SAM_PREDICT_LAUNCHES:
                raise RuntimeError(f"the prediction launched "
                                   f"{_launch_delta(before)}")
            if not (points != batch["prompt_point"]).any():
                raise RuntimeError("the refinement added no click")
            batch = dict(batch, prompt_point=points)
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
    print(f"SAM-B 1024^2 training, batch {SAM_BATCH} [{card}]: "
          f"{SAM_BATCH * len(timed_steps) / window_ms * 1e3:.2f} images/s "
          f"over the window of {len(timed_steps)} steps and their "
          f"refinements ({window_ms:.1f} ms), {step_ms:.2f} ms per step, "
          f"peak memory {peak_gib:.2f} GiB", flush=True)

    # one more box step under the profiler
    box = _keep_prompt(batches[0], "box")
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
    point = _keep_prompt(batches[1], "point")
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
    return launches


def main():
    card = phase_device()
    kernels = phase_kernels(card)
    serving = phase_serving(card)
    vit = phase_training(card)
    sam = phase_sam_training(card)
    # one count per kernel and path; the forward rel-pos kernel lies on two
    # paths (4 launches per served request, 8 per SAM train step and 4 per
    # refinement prediction), so its ``launches`` is their sum
    paths = {"sam_serving": serving, "vit_train": vit, "sam_train": sam}
    for kernel in kernels:
        by_path = {path: counts[kernel["name"]]
                   for path, counts in paths.items()
                   if counts.get(kernel["name"], 0) > 0}
        kernel["launches"] = sum(by_path.values())
        kernel["launches_by_path"] = by_path
        if kernel["launches"] < 1:
            raise RuntimeError(f"{kernel['name']} was not launched on a "
                               f"main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
