"""Experiment logging: a JSONL mirror, and TensorBoard where importable.

The port's copy of ``nerf_fl_tpu/training/logging.py``: scalars (lr, the
train loss terms, train and val psnr) and the GT | pred | depth triptych
at validation.  ``metrics.jsonl`` is always written; TensorBoard is used
only where ``torch.utils.tensorboard`` imports.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class ExperimentLogger:
    def __init__(self, log_dir: str, exp_name: str, enable_tb: bool = True):
        self.dir = os.path.join(log_dir, exp_name)
        os.makedirs(self.dir, exist_ok=True)
        self._tb = None
        if enable_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(self.dir)
            except Exception as e:  # TB optional: JSONL is the fallback
                print(f"[logging] TensorBoard unavailable ({e}); JSONL only")
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")

    def scalars(self, values: Dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in values.items():
            v = float(v)
            rec[k] = v
            if self._tb is not None:
                self._tb.add_scalar(k, v, step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def images(self, tag: str, stack: np.ndarray, step: int) -> None:
        """stack: (N, 3, H, W) float in [0,1]."""
        if self._tb is not None:
            import torch
            self._tb.add_images(tag, torch.from_numpy(
                np.asarray(stack, np.float32)), step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


class NullLogger(ExperimentLogger):
    def __init__(self):
        self._tb = None
        self._jsonl = None

    def scalars(self, values, step):
        pass

    def images(self, tag, stack, step):
        pass

    def close(self):
        pass
