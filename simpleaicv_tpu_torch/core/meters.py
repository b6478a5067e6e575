"""Host-side meters (a copy of ``simpleaicv_tpu/core/meters.py``)."""

from __future__ import annotations


class AverageMeter:
    """Tracks current value, running average, sum, count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class AccMeter:
    """Top-1 / top-5 accuracy accumulator."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.acc1_correct_num = 0.0
        self.acc5_correct_num = 0.0
        self.sample_num = 0.0

    def update(self, acc1_correct, acc5_correct, n):
        self.acc1_correct_num += float(acc1_correct)
        self.acc5_correct_num += float(acc5_correct)
        self.sample_num += float(n)

    def compute(self):
        n = max(self.sample_num, 1.0)
        return (self.acc1_correct_num / n * 100.0,
                self.acc5_correct_num / n * 100.0)
