"""Metrics monitor (``deepspeed_tpu/monitor/monitor.py``).

:class:`MonitorMaster` fans ``(tag, value, step)`` events out to the CSV,
TensorBoard (``torch.utils.tensorboard``), W&B and Comet writers the
config turns on, in the process of rank 0 only.  A writer whose package is
missing warns once and writes nothing; CSV always works.
"""

from __future__ import annotations

import csv
import os
from typing import List, Tuple

from ..utils.logging import logger

Event = Tuple[str, float, int]


def process_rank() -> int:
    """This process's global rank: ``torch.distributed``'s when a group is
    up, else the launcher's (0 for a process started alone)."""
    import torch.distributed as dist

    from ..launcher.multinode_runner import rank_env

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(rank_env()["RANK"])


class Monitor:
    def write_events(self, events: List[Event]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Release the writer's resources (file handles, threads)."""


class CSVMonitor(Monitor):
    """One CSV file per tag (``step,<tag>`` header, then ``step,value``
    rows), its handle kept open; each ``write_events`` batch ends with a
    flush of the handles it touched, so a reader sees whole rows."""

    def __init__(self, output_path: str, job_name: str):
        self.dir = os.path.join(output_path or "./csv_monitor", job_name)
        os.makedirs(self.dir, exist_ok=True)
        self._files = {}
        self._writers = {}

    def _writer(self, tag: str):
        w = self._writers.get(tag)
        if w is None:
            safe = tag.replace("/", "_").replace("=", "-")
            fname = os.path.join(self.dir, safe + ".csv")
            # the header once: only into a file created empty
            new = not os.path.exists(fname) or os.path.getsize(fname) == 0
            f = open(fname, "a", newline="")
            self._files[tag] = f
            w = self._writers[tag] = csv.writer(f)
            if new:
                w.writerow(["step", tag])
        return w

    def write_events(self, events: List[Event]) -> None:
        touched = set()
        for tag, value, step in events:
            self._writer(tag).writerow([step, value])
            touched.add(tag)
        for tag in touched:
            self._files[tag].flush()

    def close(self) -> None:
        for f in self._files.values():
            try:
                f.close()
            except OSError as e:  # one broken handle must not keep the rest open
                logger.warning(f"csv monitor: close failed: {e}")
        self._files.clear()
        self._writers.clear()


class TensorBoardMonitor(Monitor):
    def __init__(self, output_path: str, job_name: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=os.path.join(output_path or "./runs", job_name))

    def write_events(self, events: List[Event]) -> None:
        for tag, value, step in events:
            self.writer.add_scalar(tag, value, step)
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()


class WandbMonitor(Monitor):
    def __init__(self, project: str, group, team):
        import wandb

        wandb.init(project=project, group=group, entity=team)
        self._wandb = wandb

    def write_events(self, events: List[Event]) -> None:
        for tag, value, step in events:
            self._wandb.log({tag: value}, step=step)

    def close(self) -> None:
        self._wandb.finish()


class CometMonitor(Monitor):
    """comet_ml writer: ``comet_ml.start`` where the package has it (online,
    mode and the experiment key ride there), ``Experiment`` for older
    installs; an event is logged on every ``samples_log_interval``-th step."""

    def __init__(self, cfg):
        import comet_ml

        self._interval = max(1, int(getattr(cfg, "samples_log_interval", 1) or 1))
        base = {k: v for k, v in (("api_key", cfg.api_key), ("workspace", cfg.workspace)) if v}
        if hasattr(comet_ml, "start"):
            kw = dict(base, project=cfg.project)
            for name in ("online", "mode", "experiment_key"):
                v = getattr(cfg, name, None)
                if v is not None:
                    kw[name] = v
            self._exp = comet_ml.start(**{k: v for k, v in kw.items() if v is not None})
        else:
            kw = dict(base)
            if cfg.project:
                kw["project_name"] = cfg.project
            self._exp = comet_ml.Experiment(**kw)
        if getattr(cfg, "experiment_name", None):
            self._exp.set_name(cfg.experiment_name)

    def write_events(self, events: List[Event]) -> None:
        for tag, value, step in events:
            if step % self._interval == 0:
                self._exp.log_metric(tag, value, step=step)


class MonitorMaster(Monitor):
    """Every writer the config enables, on rank 0 (other ranks hold none)."""

    def __init__(self, config):
        self.monitors: List[Monitor] = []
        if process_rank() != 0:
            return
        if config.csv_monitor.enabled:
            self.monitors.append(CSVMonitor(config.csv_monitor.output_path,
                                            config.csv_monitor.job_name))
        optional = (
            ("tensorboard", lambda: TensorBoardMonitor(config.tensorboard.output_path,
                                                       config.tensorboard.job_name)),
            ("wandb", lambda: WandbMonitor(config.wandb.project, config.wandb.group,
                                           config.wandb.team)),
            ("comet", lambda: CometMonitor(config.comet)))
        for name, make in optional:
            block = getattr(config, name, None)
            if block is None or not block.enabled:
                continue
            try:
                self.monitors.append(make())
            except Exception as e:  # the writer's package is missing or fails to start
                logger.warning(f"{name} monitor unavailable: {e}")

    @property
    def enabled(self) -> bool:
        return bool(self.monitors)

    def write_events(self, events: List[Event]) -> None:
        for m in self.monitors:
            m.write_events(events)

    def write_registry(self, registry, step: int) -> None:
        """A telemetry registry's snapshot through every writer: counters
        and gauges as scalar tags, histograms as p50/p95/p99/count/sum
        sub-tags (``MetricsRegistry.snapshot_events``)."""
        if not self.monitors:
            return
        events = registry.snapshot_events(step)
        if events:
            self.write_events(events)

    def close(self) -> None:
        """Close every writer; safe to call twice, and a writer that fails
        to close does not keep the rest open."""
        for m in self.monitors:
            try:
                m.close()
            except Exception as e:
                logger.warning(f"monitor close failed: {e}")
