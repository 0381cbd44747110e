"""Host-side schedules: loss-weight annealing, lr decay, and the PSNR-plateau
auto-scheduler.

Copy of nope_nerf_tpu/training/scheduler.py (pure Python; the port keeps its own).

Capability parity with the reference's scheduling machinery:
- linear weight annealing start->end over `annealing_epochs` after `scheduling_start`
  (`Trainer.anneal`, model/training.py:204-212);
- auto-scheduler: smoothed-PSNR plateau detection arms `scheduling_start`, after which
  lr decays exponentially — gamma^((epoch-start)/10) for the NeRF, /100 for
  pose/focal/distortion (`train.py:303-346`);
- the explicit (non-auto) mode reproduces MultiStepLR: NeRF decays every 10 epochs,
  the small parameter groups every 100 (`train.py:78-151`).

These are scalars computed on the host between steps: the reference's control
flow here is stateful and data-dependent (plateau detection).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


def anneal_weight(start_weight: float, end_weight: float, anneal_start_epoch: int,
                  anneal_epochs: int, current: int) -> float:
    if current <= anneal_start_epoch:
        return start_weight
    if current >= anneal_start_epoch + anneal_epochs:
        return end_weight
    return start_weight + (end_weight - start_weight) * (
        current - anneal_start_epoch) / anneal_epochs


WEIGHT_NAMES = ["rgb_weight", "depth_weight", "pc_weight", "rgb_s_weight",
                "depth_consistency_weight", "weight_dist_2nd_loss",
                "weight_dist_1st_loss", "t_cycle_weight"]


def annealed_weights(cfg_training: dict, scheduling_start: int, epoch: int) -> Dict[str, float]:
    """All 8 loss weights at `epoch` (training.py:226-232)."""
    ae = cfg_training["annealing_epochs"]
    return {name: anneal_weight(cfg_training[name][0], cfg_training[name][1],
                                scheduling_start, ae, epoch)
            for name in WEIGHT_NAMES}


def rgb_loss_type_at(cfg_training: dict, scheduling_start: int, epoch: int) -> str:
    """l1 before annealing completes, l2 after (training.py:228)."""
    return "l1" if epoch < cfg_training["annealing_epochs"] + scheduling_start else "l2"


def lr_at_epoch(base_lr: float, gamma: float, scheduling_start: int, epoch: int,
                decay_interval: int) -> float:
    """Manual exponential decay used by the auto-scheduler after arming
    (train.py:332-346): base * gamma^((epoch - start) // interval)."""
    if epoch < scheduling_start:
        return base_lr
    return base_lr * (gamma ** int((epoch - scheduling_start) / decay_interval))


def multistep_lr(base_lr: float, gamma: float, milestones: List[int], epoch: int) -> float:
    """torch MultiStepLR equivalent (train.py:78-83)."""
    n = sum(1 for m in milestones if m <= epoch)
    return base_lr * (gamma ** n)


@dataclasses.dataclass
class AutoScheduler:
    """Smoothed-PSNR plateau detector (train.py:316-325).

    Keeps a `length_smooth`-long PSNR window; when the window mean stops improving
    `patient` times, training enters the decay phase by setting scheduling_start to
    the current epoch. State round-trips through checkpoints.
    """
    length_smooth: int = 1000
    patient: int = 30
    metric_val_best: float = float("-inf")
    patient_count: int = 0
    window: Optional[List[float]] = None

    def __post_init__(self):
        if self.window is None:
            self.window = []

    def update(self, psnr: float, epoch: int, scheduling_start: int) -> int:
        """Feed one epoch's PSNR; returns the (possibly newly armed) scheduling_start."""
        self.window.append(psnr)
        if len(self.window) >= self.length_smooth:
            self.window = self.window[-self.length_smooth:]
            metric_val = sum(self.window) / len(self.window)
            if metric_val - self.metric_val_best >= 0:
                self.metric_val_best = metric_val
            else:
                self.patient_count += 1
                if self.patient_count == self.patient:
                    scheduling_start = epoch
        return scheduling_start

    def state_dict(self) -> dict:
        # The PSNR window is persisted too (the reference loses it across
        # resume, train.py:65-76 round-trips only the two scalars, so a resumed
        # run re-fills a length_smooth window and shifts the decay point —
        # deliberate improvement over the reference).
        import numpy as np
        return {"metric_val_best": self.metric_val_best,
                "patient_count": self.patient_count,
                "psnr_window": np.asarray(self.window, np.float64)}

    def load_state_dict(self, d: dict) -> None:
        import numpy as np
        self.metric_val_best = d.get("metric_val_best", float("-inf"))
        self.patient_count = d.get("patient_count", 0)
        w = d.get("psnr_window")
        if w is not None:
            self.window = [float(x) for x in np.asarray(w).ravel()]
