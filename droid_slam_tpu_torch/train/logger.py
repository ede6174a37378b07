"""Training logger: running means printed every SUM_FREQ steps, and written
to TensorBoard when its writer imports.

Counterpart of ``droid_slam_tpu/train/logger.py``.
"""

from __future__ import annotations

SUM_FREQ = 100


class Logger:
    def __init__(self, name, total_steps=0, logdir="runs"):
        self.name = name
        self.total_steps = total_steps
        self.running_loss = {}
        self.writer = None
        self.logdir = logdir

    def _try_writer(self):
        if self.writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(
                    log_dir=f"{self.logdir}/{self.name}")
            except Exception:
                self.writer = False

    def _print(self):
        metrics = [self.running_loss[k] / SUM_FREQ
                   for k in sorted(self.running_loss)]
        out = "[{:>6d}] ".format(self.total_steps + 1)
        out += ("{:10.4f}" * len(metrics)).format(*metrics)
        print(out, flush=True)

    def push(self, metrics):
        for key, val in metrics.items():
            self.running_loss[key] = (self.running_loss.get(key, 0.0)
                                      + float(val))
        if self.total_steps % SUM_FREQ == SUM_FREQ - 1:
            self._print()
            self._try_writer()
            if self.writer:
                for k in self.running_loss:
                    self.writer.add_scalar(
                        k, self.running_loss[k] / SUM_FREQ, self.total_steps)
            self.running_loss = {}
        self.total_steps += 1
