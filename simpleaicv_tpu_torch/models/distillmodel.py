"""Knowledge-distillation wrapper (counterpart of
``simpleaicv_tpu/models/distillmodel.py``): a teacher and a student
backbone on the same images, the teacher optionally frozen.

A frozen teacher runs as the JAX model runs it, with ``train=False``: in
eval mode whatever mode the wrapper is put in (``KDModel.train`` keeps it
there), so its BatchNorm uses its running statistics and leaves them
alone, and under ``no_grad``, so no gradient reaches it. Its parameters
stay in the trained model, as they stay in the JAX package's trained tree:
the optimizer's weight decay and momentum act on them with a zero gradient
unless ``frozen_layer_name_list`` names them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.registry import BACKBONES, MODELS

__all__ = ["KDModel", "KDTeacherStudent"]


class KDModel(nn.Module):
    """[B, H, W, 3] images -> (teacher logits, student logits)."""

    def __init__(self, teacher: nn.Module, student: nn.Module,
                 freeze_teacher: bool = True):
        super().__init__()
        self.teacher = teacher
        self.student = student
        self.freeze_teacher = freeze_teacher

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_teacher:
            self.teacher.eval()
        return self

    def forward(self, x, generator=None):
        if self.freeze_teacher:
            with torch.no_grad():
                tea = self.teacher(x)
        else:
            tea = self.teacher(x, generator=generator)
        return tea, self.student(x, generator=generator)


@MODELS.register()
def KDTeacherStudent(teacher_type: str, student_type: str, num_classes: int,
                     freeze_teacher: bool = True, **kwargs):
    """Both backbones from the registry; ``kwargs`` (the port's ``dtype``,
    for one) go to both, where the JAX function takes and ignores them."""
    teacher = BACKBONES.create(teacher_type, num_classes=num_classes,
                               **kwargs)
    student = BACKBONES.create(student_type, num_classes=num_classes,
                               **kwargs)
    return KDModel(teacher=teacher, student=student,
                   freeze_teacher=freeze_teacher)
