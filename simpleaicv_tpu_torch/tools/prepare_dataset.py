"""Dataset packing (the ``pack-imagefolder``, ``pack-cifar``,
``pack-coco`` and ``pack-sam`` subcommands of
``tools/prepare_dataset.py``): writes every sample as a fixed-stride
uint8 record at the training resolution (``data/packed.py``,
``data/packed_tasks.py``), so that an epoch reads bytes through one
gather a batch instead of decoding.

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


if __name__ == "__main__":
    sys.exit(main())
