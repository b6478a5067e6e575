"""Runs every ``fake_synthetic`` experiment through the port's train CLI and
then its test CLI on the trained ``best``, on the CPU (counterpart of
``tools/run_synthetic_smokes.py``):

    python -m simpleaicv_tpu_torch.tools.run_synthetic_smokes [name-filter ...]

Each experiment runs in a scratch copy of its directory (``tempfile``), as
``python -m simpleaicv_tpu_torch.tools.<cli>`` under
``SIMPLEAICV_PLATFORM=cpu``. One line per experiment: PASS when it trained
and tested (or trained, for a family without a test CLI), MISSING with the
counterpart it lacks when a CLI stopped at a ``MissingCounterpartError`` or
the port has no such CLI yet, FAIL otherwise. The last line counts them;
the exit code is 1 when any experiment failed.
"""

from __future__ import annotations

import importlib.util
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOOLS = "simpleaicv_tpu_torch.tools"

# experiment prefix -> train CLI, the longest prefix first (the map of the
# JAX package's tools/run_synthetic_smokes.py)
CLI = {
    "0.classification_training": "train_classification",
    "1.distillation_training": "train_distill_classification",
    "2.masked_image_modeling_training": "train_mae_self_supervised",
    "3.detection_training/fake_synthetic/resnet18_fcos": "train_detection",
    "3.detection_training/fake_synthetic/resnet18_detr":
        "train_detr_detection",
    "3.detection_training/fake_synthetic/resnet18_dino":
        "train_detr_detection",
    "4.semantic_segmentation_training": "train_semantic_segmentation",
    "5.instance_segmentation_training": "train_instance_segmentation",
    "6.salient_object_detection_training": "train_salient_object_detection",
    "7.human_matting_training": "train_human_matting",
    "8.ocr_text_detection_training": "train_text_detection",
    "9.ocr_text_recognition_training": "train_text_recognition",
    "10.face_detection_training": "train_face_detection",
    "11.face_parsing_training": "train_face_parsing",
    "12.human_parsing_training": "train_human_parsing",
    "13.interactive_segmentation_training/fake_synthetic/tiny_sam_distill":
        "train_interactive_segmentation_distill_sam",
    "13.interactive_segmentation_training/fake_synthetic/"
    "tiny_sam_encoder_distill": "train_interactive_segmentation_distill",
    "13.interactive_segmentation_training/fake_synthetic/tiny_sam_matting":
        "train_interactive_matting",
    "13.interactive_segmentation_training":
        "train_interactive_segmentation",
    "20.diffusion_model_training": "train_diffusion_model",
}

# experiment prefix -> test CLI run on the train CLI's best checkpoint;
# None: the family has no test CLI (loss-only training, distillation)
TEST_CLI = {
    "0.classification_training": "test_classification",
    "1.distillation_training": None,
    "2.masked_image_modeling_training": None,
    "3.detection_training": "test_detection",
    "4.semantic_segmentation_training": "test_semantic_segmentation",
    "5.instance_segmentation_training": "test_instance_segmentation",
    "6.salient_object_detection_training": "test_salient_object_detection",
    "7.human_matting_training": "test_human_matting",
    "8.ocr_text_detection_training": "test_text_detection",
    "9.ocr_text_recognition_training": "test_text_recognition",
    "10.face_detection_training": "test_face_detection",
    "11.face_parsing_training": "test_face_parsing",
    "12.human_parsing_training": "test_human_parsing",
    "13.interactive_segmentation_training/fake_synthetic/tiny_sam_matting":
        "test_interactive_matting",
    "13.interactive_segmentation_training/fake_synthetic/tiny_sam_distill":
        None,
    "13.interactive_segmentation_training/fake_synthetic/"
    "tiny_sam_encoder_distill": None,
    "13.interactive_segmentation_training/fake_synthetic/tiny_sam":
        "test_interactive_segmentation",
    "20.diffusion_model_training": "test_diffusion_model",
}

_MISSING = re.compile(r"MissingCounterpartError: (.*)")


def _lookup(table, rel):
    for prefix in sorted(table, key=len, reverse=True):
        if rel.startswith(prefix):
            return table[prefix]
    return None


def _has_cli(name) -> bool:
    return importlib.util.find_spec(f"{TOOLS}.{name}") is not None


_LOAD_ONLY = ("import sys\n"
              "from simpleaicv_tpu_torch.core.config import load_config\n"
              "load_config(sys.argv[1])\n")


def _run(cli, work, env):
    """(ok, the missing counterpart or None, the output's last lines). For
    a CLI the port lacks, the train config is loaded alone, to name what
    else it lacks first."""
    has_cli = _has_cli(cli)
    cmd = (["-m", f"{TOOLS}.{cli}", "--work-dir", work] if has_cli
           else ["-c", _LOAD_ONLY, work])
    proc = subprocess.run([sys.executable] + cmd, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=1500)
    out = (proc.stdout + proc.stderr).strip()
    missing = _MISSING.findall(out)
    tail = "\n".join(out.splitlines()[-12:])
    if missing:
        return False, missing[-1], tail
    if not has_cli:
        return False, f"the CLI {TOOLS}.{cli}", tail
    return proc.returncode == 0, None, tail


def _point_test_config_at_best(work):
    path = os.path.join(work, "test_config.py")
    best = os.path.join(work, "checkpoints", "best")
    if os.path.exists(path) and os.path.exists(best):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        with open(path, "w", encoding="utf-8") as f:
            f.write(text.replace('trained_model_path = ""',
                                 f'trained_model_path = {best!r}'))


def main(argv=None):
    filters = sys.argv[1:] if argv is None else list(argv)
    exp_root = os.path.join(REPO, "experiments")
    smokes = sorted(
        os.path.relpath(d, exp_root) for d, _, files in os.walk(exp_root)
        if "fake_synthetic" in d and "train_config.py" in files)
    if filters:
        smokes = [s for s in smokes if any(f in s for f in filters)]
    env = dict(os.environ, SIMPLEAICV_PLATFORM="cpu",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    passed, missing, failed = [], [], []
    for rel in smokes:
        work = tempfile.mkdtemp(prefix="smoke_")
        try:
            for f in os.listdir(os.path.join(exp_root, rel)):
                if f.endswith(".py"):
                    shutil.copy(os.path.join(exp_root, rel, f), work)
            clis = [_lookup(CLI, rel)]
            test_cli = _lookup(TEST_CLI, rel)
            if test_cli and os.path.exists(
                    os.path.join(work, "test_config.py")):
                clis.append(test_cli)
            verdict, note = "PASS", ""
            for i, cli in enumerate(clis):
                if i:
                    _point_test_config_at_best(work)
                ok, lacks, tail = _run(cli, work, env)
                if lacks is not None:
                    verdict, note = "MISSING", \
                        f"{cli}: {lacks.split('. known:')[0]}"
                    break
                if not ok or (i == 0 and not os.path.isdir(
                        os.path.join(work, "checkpoints"))):
                    verdict, note = "FAIL", f"{cli}\n      " + \
                        tail.replace("\n", "\n      ")
                    break
            else:
                note = " + ".join(clis)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        {"PASS": passed, "MISSING": missing, "FAIL": failed}[verdict].append(
            rel)
        print(f"{verdict:8s}{rel}  [{note}]", flush=True)
    print(f"\n{len(passed)} of {len(smokes)} configs trained and tested "
          f"through the port's CLIs; {len(missing)} stop at a missing "
          f"counterpart; {len(failed)} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
