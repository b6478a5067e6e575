"""Dataset preparation: raw public downloads -> the layouts the port's
readers consume (the twelve conversion subcommands), and dataset packing
(the four ``pack-*`` subcommands), with the JAX tool's
(``tools/prepare_dataset.py``) subcommands, flags and defaults.

    python -m simpleaicv_tpu_torch.tools.prepare_dataset rctw \
        --root <RCTW> --out <dir>          # also art, lsvt, mlt, rects
    python -m simpleaicv_tpu_torch.tools.prepare_dataset text-lines \
        --root <processed-det-root> \
        --set-name ICDAR2017RCTW_text_detection --out <dir>
    python -m simpleaicv_tpu_torch.tools.prepare_dataset char-table \
        --labels a.json b.json --out t.json
    python -m simpleaicv_tpu_torch.tools.prepare_dataset face-synthetics \
        --root <FS> --out <dir>            # also celebamask-hq, lip, cihp
    python -m simpleaicv_tpu_torch.tools.prepare_dataset sam-masks \
        --root <pairs> --out <dir> --set-type train
    python -m simpleaicv_tpu_torch.tools.prepare_dataset pack-imagefolder \
        --root <ImageFolder> --out train_224.pack --size 224
    python -m simpleaicv_tpu_torch.tools.prepare_dataset pack-cifar \
        --root <CIFAR> --out c.pack --dataset cifar100 --split train
    python -m simpleaicv_tpu_torch.tools.prepare_dataset pack-coco \
        --root <COCO2017> --out train_1024.pack --set-name train2017 \
        --size 1024
    python -m simpleaicv_tpu_torch.tools.prepare_dataset pack-sam \
        --root <SA-1B> --out sa0_1024.pack --set-names sa_000000 \
        --set-type train

The conversions run ``data/processing`` on the host, without OpenCV, and
open no device: RCTW, ART, LSVT, MLT and ReCTS become text-detection sets,
``text-lines`` cuts a set into recognition lines and ``char-table`` builds
a character table over their labels, FaceSynthetics, CelebAMask-HQ, LIP
and CIHP become parsing pairs, and ``sam-masks`` turns a folder of
image/mask pairs into the SA-1B layout. Their trees equal the JAX tool's
(``tests/test_torch_processing.py``); the train CLIs then read them on the
card.

Packing writes every sample as a fixed-stride uint8 record at the
training resolution (``data/packed.py``, ``data/packed_tasks.py``), so
that an epoch reads bytes through one gather a batch instead of decoding.
``pack-imagefolder`` decodes with the port's libjpeg binding
(``data/native_io.py``, built by ``g++`` with ``-ljpeg`` at first use);
``pack-cifar`` decodes nothing; ``pack-coco`` (the images with an object)
and ``pack-sam`` read through the COCO and SA-1B readers, which decode
with ``data/image_io.py``. ``pack-sam`` picks each image's mask with a
``random.Random(0)`` where the JAX tool draws from the global ``random``.
A pack written here reads in the JAX package and the other way round.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    def std(name):
        p = sub.add_parser(name)
        p.add_argument("--root", required=True)
        p.add_argument("--out", required=True)
        return p

    for name in ("rctw", "art", "lsvt", "mlt", "rects"):
        p = std(name)
        p.add_argument("--train-ratio", type=float, default=0.9)
        p.add_argument("--max-side", type=int, default=1920)
        p.add_argument("--seed", type=int, default=0)

    p = std("text-lines")
    p.add_argument("--set-name", required=True)
    p.add_argument("--out-set-name", default=None)

    p = sub.add_parser("char-table")
    p.add_argument("--labels", nargs="+", required=True)
    p.add_argument("--out", required=True)

    for name in ("face-synthetics", "celebamask-hq", "lip", "cihp"):
        std(name)

    p = std("sam-masks")
    p.add_argument("--set-type", default="train")

    p = std("pack-imagefolder")
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--letterbox", action="store_true")
    p.add_argument("--threads", type=int, default=0)

    p = std("pack-cifar")
    p.add_argument("--dataset", choices=("cifar10", "cifar100"),
                   default="cifar100")
    p.add_argument("--split", choices=("train", "test"), default="train")

    p = std("pack-coco")
    p.add_argument("--set-name", default="train2017")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--max-annots", type=int, default=100)

    p = std("pack-sam")
    p.add_argument("--set-names", nargs="+", default=["sa_000000"])
    p.add_argument("--set-type", default="train")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--point-candidates", type=int, default=32)

    args = parser.parse_args(argv)
    if not args.cmd.startswith("pack-"):
        return _convert(args)
    if args.cmd == "pack-coco":
        from ..data.datasets.coco import CocoDetection
        from ..data.packed_tasks import pack_detection_dataset
        ds = CocoDetection(args.root, set_name=args.set_name,
                           filter_no_object_image=True)
        pack_detection_dataset(ds, args.out, image_hw=args.size,
                               max_annots=args.max_annots,
                               meta={"set_name": args.set_name},
                               progress_every=5000)
        print(f"packed {len(ds)} samples -> {args.out}")
    elif args.cmd == "pack-sam":
        from ..data.datasets.sam_segmentation import SAMSegmentationDataset
        from ..data.packed_tasks import pack_sam_dataset
        ds = SAMSegmentationDataset(args.root, set_name_list=args.set_names,
                                    set_type=args.set_type)
        pack_sam_dataset(ds, args.out, image_hw=args.size,
                         max_point_candidates=args.point_candidates,
                         meta={"set_names": args.set_names},
                         progress_every=5000)
        print(f"packed {len(ds)} samples -> {args.out}")
    elif args.cmd == "pack-imagefolder":
        from ..data.packed import pack_image_folder
        pack_image_folder(args.root, args.out, image_hw=args.size,
                          letterbox=args.letterbox, n_threads=args.threads)
        print(f"packed -> {args.out}")
    else:
        from ..data.datasets.cifar import CIFAR10Dataset, CIFAR100Dataset
        from ..data.packed import pack_dataset
        cls = CIFAR100Dataset if args.dataset == "cifar100" else \
            CIFAR10Dataset
        ds = cls(args.root, set_name=args.split)
        pack_dataset(ds, args.out, progress_every=10000)
        print(f"packed {len(ds)} samples -> {args.out}")
    return 0


def _convert(args):
    """Runs one of the twelve conversion subcommands."""
    from ..data import processing as P
    if args.cmd in ("rctw", "art", "lsvt", "mlt", "rects"):
        fn = {"rctw": P.process_rctw, "art": P.process_art,
              "lsvt": P.process_lsvt, "mlt": P.process_mlt,
              "rects": P.process_rects}[args.cmd]
        fn(args.root, args.out, train_ratio=args.train_ratio,
           max_side=args.max_side, seed=args.seed)
    elif args.cmd == "text-lines":
        P.extract_text_lines(args.root, args.set_name, args.out,
                             out_set_name=args.out_set_name)
    elif args.cmd == "char-table":
        table = P.build_char_table(args.labels, args.out)
        print(f"char table: {len(table)} chars -> {args.out}")
    elif args.cmd == "sam-masks":
        P.convert_mask_folder_to_sa1b(args.root, args.out,
                                      set_type=args.set_type)
    else:
        {"face-synthetics": P.process_face_synthetics,
         "celebamask-hq": P.process_celebamask_hq,
         "lip": P.process_lip,
         "cihp": P.process_cihp}[args.cmd](args.root, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
