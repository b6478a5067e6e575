"""Dataset packing (the ``pack-imagefolder`` and ``pack-cifar`` subcommands
of ``tools/prepare_dataset.py``): writes every sample as a fixed-stride
uint8 record at the training resolution (``data/packed.py``), so that an
epoch reads bytes through one gather a batch instead of decoding.

    python -m simpleaicv_tpu_torch.tools.prepare_dataset pack-imagefolder \
        --root <ImageFolder> --out train_224.pack --size 224
    python -m simpleaicv_tpu_torch.tools.prepare_dataset pack-cifar \
        --root <CIFAR> --out c.pack --dataset cifar100 --split train

``pack-imagefolder`` decodes with the port's libjpeg binding
(``data/native_io.py``, built by ``g++`` with ``-ljpeg`` at first use);
``pack-cifar`` decodes nothing. A pack written here reads in the JAX
package and the other way round.
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

    args = parser.parse_args(argv)
    if args.cmd == "pack-imagefolder":
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
