#!/usr/bin/env python3
"""Drives the PyTorch port (``simpleaicv_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:
  1. device: requires a CUDA card and prints its name and power limit;
  2. kernels: builds every hand kernel from the sources in the checkout and
     holds it against its plain PyTorch version on the card, at the shapes
     the served path gives it and at edge shapes, and times it beside its
     plain version, a PyTorch library call and its bound;
  3. slice: serves SAM-B 1024x1024 interactive-segmentation requests through
     ``SAMPredictor`` on the card, counts the kernel launches of that run,
     and compares the masks with the same requests on the plain path.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from simpleaicv_tpu_torch.demo.predictors import SAMPredictor, bounding_rect
from simpleaicv_tpu_torch.ops import _build
from simpleaicv_tpu_torch.ops import flash_attention as fa

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


def phase_kernels(card):
    t0 = time.perf_counter()
    logs = _build.build(["flash_relpos_fwd"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # (name, BH, k_h, k_w, d): SAM-B and SAM-H global layers at 1024^2, a
    # non-square grid, and a tail (N = 100 is no multiple of the 64-query
    # tile; k_w = 10 and d = 40 are padded inside the kernel).
    shapes = [("sam_b", 12, 64, 64, 64), ("sam_h", 16, 64, 64, 80),
              ("grid_8x16", 4, 8, 16, 32), ("tail_10x10", 3, 10, 10, 40)]
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    main_err = None
    for i, (name, bh, k_h, k_w, d) in enumerate(shapes):
        for dtype, atol in tols.items():
            args = _relpos_inputs(bh, k_h, k_w, d, dtype, seed=i)
            o, lse = fa.flash_attention_relpos(*args)
            o_ref, lse_ref = fa.flash_attention_relpos_reference(*args)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            print(f"kernel check {name} BH={bh} grid={k_h}x{k_w} d={d} "
                  f"{str(dtype)[6:]}: max|o-ref|={err_o:.3e} "
                  f"max|lse-ref|={err_lse:.3e} (atol {atol:g})", flush=True)
            if not (err_o <= atol and err_lse <= atol):
                raise RuntimeError(f"flash_attention_relpos_fwd disagrees "
                                   f"with its plain version at {name} {dtype}")
            if name == "sam_b" and dtype == torch.bfloat16:
                main_err = err_o

    # Times at the served shape: SAM-B global attention, bf16, one image.
    bh, k_h, k_w, d = 12, 64, 64, 64
    n = k_h * k_w
    q, k, v, rel_h, rel_w = _relpos_inputs(bh, k_h, k_w, d, torch.bfloat16, 9)
    ms = _cuda_ms(lambda: fa.flash_attention_relpos(q, k, v, rel_h, rel_w), 20)
    plain_ms = _cuda_ms(
        lambda: fa.flash_attention_relpos_reference(q, k, v, rel_h, rel_w), 5)
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        1, bh, n, n).to(torch.bfloat16)
    library_ms = _cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=bias), 10)
    del bias
    flops = 4.0 * n * n * d * bh
    nbytes = 4 * bh * n * d * 2 + bh * n * (k_h + k_w + 1) * 4
    op_ms = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"flash_attention_relpos_fwd SAM-B bf16 [{card}]: kernel {ms:.4f} ms"
          f", plain {plain_ms:.4f} ms, sdpa+bias {library_ms:.4f} ms, bound "
          f"{max(op_ms, byte_ms):.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)",
          flush=True)
    return {"name": "flash_attention_relpos_fwd", "route": "cuda",
            "source": "simpleaicv_tpu_torch/ops/csrc/flash_relpos_fwd.cu",
            "replaces": "simpleaicv_tpu/ops/flash_attention.py:247",
            "launches": None, "max_abs_err": main_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes",
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


def phase_slice(card, rounds=3):
    t0 = time.perf_counter()
    pred = SAMPredictor("sam_b", image_size=1024, device="cuda",
                        dtype=torch.bfloat16, seed=0)
    print(f"sam_b 1024^2 bf16 built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    requests = _requests()

    # the served path: every request through the predictor's entry points
    for name in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[name] = 0
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
    from torch.profiler import ProfilerActivity, profile
    kind, image, prompt = requests[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _serve(pred, kind, image, prompt)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms > 0:
        median = float(np.median(latencies))
        print(f"profiled {kind} request [{card}]: device busy {busy_ms:.2f} "
              f"ms of a {median:.2f} ms median request, idle share "
              f"{1 - busy_ms / median:.3f}", flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            ms = e.self_device_time_total / 1e3
            print(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count} "
                  f"{e.key[:90]}")
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


def main():
    card = phase_device()
    kernel = phase_kernels(card)
    launches = phase_slice(card)
    kernel["launches"] = launches[kernel["name"]]
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
