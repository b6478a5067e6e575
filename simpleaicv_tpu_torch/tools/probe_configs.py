"""Loads every ``experiments/**/train_config.py`` through the port's
``core/config.py::load_config`` and tallies how each load ends:

    SIMPLEAICV_PLATFORM=cpu python -m simpleaicv_tpu_torch.tools.probe_configs

The models are built on PyTorch's meta device, so no weight is allocated
and a full-size recipe (SAM-H, ViT-L) loads in a moment. One line per
config that does not load, with its error; the last line counts the
configs that loaded, those that stopped at a ``MissingCounterpartError``
(a name the port lacks) and those that stopped otherwise. The datasets'
readers read nothing until their first sample, so a missing data path
does not stop a load. The exit code is 1 when any config stopped at a
``MissingCounterpartError``.
"""

from __future__ import annotations

import glob
import os
import sys

import torch

from ..core.config import MissingCounterpartError, load_config

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def probe(experiments: str = os.path.join(REPO, "experiments")) -> dict:
    """{"loaded": [dirs], "missing": [(dir, error)], "other": [(dir,
    error)]} over the train configs under ``experiments``."""
    out = {"loaded": [], "missing": [], "other": []}
    paths = sorted(glob.glob(os.path.join(experiments, "**",
                                          "train_config.py"), recursive=True))
    for path in paths:
        work_dir = os.path.dirname(path)
        try:
            with torch.device("meta"):
                load_config(work_dir)
        except MissingCounterpartError as e:
            out["missing"].append((work_dir, str(e)))
        except Exception as e:  # noqa: BLE001 (tallied, not hidden)
            out["other"].append((work_dir, f"{type(e).__name__}: {e}"))
        else:
            out["loaded"].append(work_dir)
    return out


def main(argv=None):
    result = probe(*(argv if argv is not None else sys.argv[1:]))
    for kind in ("missing", "other"):
        for work_dir, err in result[kind]:
            print(f"{kind.upper()} {os.path.relpath(work_dir, REPO)}: "
                  f"{err.splitlines()[0][:200]}")
    total = sum(len(v) for v in result.values())
    print(f"{len(result['loaded'])} of {total} loaded, "
          f"{len(result['missing'])} stopped at a MissingCounterpartError, "
          f"{len(result['other'])} stopped otherwise")
    return 1 if result["missing"] else 0


if __name__ == "__main__":
    sys.exit(main())
