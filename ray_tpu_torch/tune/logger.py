"""Per-iteration trial loggers (reference `python/ray/tune/logger/`:
csv.py, json.py, tensorboardx.py) as Callback implementations.

Each trial gets a directory `<experiment_dir>/<trial_id>/` holding:
  params.json     the trial's config (JsonLoggerCallback)
  result.json     one JSON line per reported result (JsonLoggerCallback)
  progress.csv    flat CSV, header from the first result (CSVLoggerCallback)
  events.out.tfevents.*   TensorBoard scalars (TensorBoardLoggerCallback)

The TensorBoard writer is dependency-free: it emits the TFRecord framing
(masked crc32c) and hand-encoded Event/Summary protos directly — scalars
only, which is what Tune logs. tensorboardX is not in this image and the
format is stable, so 60 lines beat an optional dependency.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import struct
import time
from typing import Any, Dict, IO, Optional

from ray_tpu_torch.tune.callback import Callback

logger = logging.getLogger(__name__)

_EXCLUDE = {"__checkpoint__", "config"}


def _scrub(result: Dict[str, Any]) -> Dict[str, Any]:
    """JSON/CSV-safe view of a result dict."""
    out = {}
    for k, v in result.items():
        if k in _EXCLUDE:
            continue
        if hasattr(v, "item"):  # numpy scalar, 0-dim torch tensor
            try:
                v = v.item()
            except Exception:
                v = str(v)
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)
    return out


class _PerTrialLogger(Callback):
    """Shared trial-directory plumbing."""

    def __init__(self):
        self._dir: Optional[str] = None

    def setup(self, experiment_dir: Optional[str]) -> None:
        self._dir = experiment_dir
        if experiment_dir is None:
            logger.warning("%s inactive: no RunConfig experiment dir",
                           type(self).__name__)

    def trial_dir(self, trial) -> Optional[str]:
        if self._dir is None:
            return None
        path = os.path.join(self._dir, trial.trial_id)
        os.makedirs(path, exist_ok=True)
        return path


class JsonLoggerCallback(_PerTrialLogger):
    """params.json once per trial + result.json with one line per result."""

    def __init__(self):
        super().__init__()
        self._files: Dict[str, IO] = {}

    def on_trial_start(self, trial) -> None:
        d = self.trial_dir(trial)
        if d is None:
            return
        with open(os.path.join(d, "params.json"), "w") as f:
            json.dump(_scrub(dict(trial.config)), f, default=str)
        if trial.trial_id not in self._files:
            self._files[trial.trial_id] = open(
                os.path.join(d, "result.json"), "a")

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        f = self._files.get(trial.trial_id)
        if f is None:
            return
        json.dump(_scrub(result), f)
        f.write("\n")
        f.flush()

    def _close(self, trial) -> None:
        f = self._files.pop(trial.trial_id, None)
        if f is not None:
            f.close()

    on_trial_complete = _close
    on_trial_error = _close

    def on_experiment_end(self, trials) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


class CSVLoggerCallback(_PerTrialLogger):
    """progress.csv per trial; columns fixed by the first reported result
    (reference csv logger behavior — late-appearing keys are dropped)."""

    def __init__(self):
        super().__init__()
        self._writers: Dict[str, Any] = {}
        self._files: Dict[str, IO] = {}

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        d = self.trial_dir(trial)
        if d is None:
            return
        flat = _scrub(result)
        w = self._writers.get(trial.trial_id)
        if w is None:
            f = open(os.path.join(d, "progress.csv"), "a")
            w = csv.DictWriter(f, fieldnames=list(flat), extrasaction="ignore")
            if f.tell() == 0:
                w.writeheader()
            self._files[trial.trial_id] = f
            self._writers[trial.trial_id] = w
        w.writerow(flat)
        self._files[trial.trial_id].flush()

    def _close(self, trial) -> None:
        f = self._files.pop(trial.trial_id, None)
        self._writers.pop(trial.trial_id, None)
        if f is not None:
            f.close()

    on_trial_complete = _close
    on_trial_error = _close

    def on_experiment_end(self, trials) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
        self._writers.clear()


# --------------------------------------------------------------- tensorboard


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord framing requires (zlib.crc32 is the
    wrong polynomial)."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 * (crc & 1))
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _tf_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


def _pb_bytes(field: int, data: bytes) -> bytes:
    return bytes([field << 3 | 2]) + _pb_varint(len(data)) + data


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _event_proto(wall_time: float, step: int,
                 scalars: Optional[Dict[str, float]] = None,
                 file_version: Optional[str] = None) -> bytes:
    # Event: 1=wall_time(double) 2=step(int64) 3=file_version 5=summary
    ev = struct.pack("<Bd", 0x09, wall_time)
    ev += bytes([0x10]) + _pb_varint(step)
    if file_version is not None:
        ev += _pb_bytes(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, value in scalars.items():
            # Summary.Value: 1=tag 2=simple_value(float)
            val = _pb_bytes(1, tag.encode()) + struct.pack("<Bf", 0x15, value)
            summary += _pb_bytes(1, val)
        ev += _pb_bytes(5, summary)
    return ev


class TensorBoardLoggerCallback(_PerTrialLogger):
    """Scalar TensorBoard events per trial, no tensorboardX dependency."""

    def __init__(self):
        super().__init__()
        self._files: Dict[str, IO] = {}

    def _file(self, trial) -> Optional[IO]:
        f = self._files.get(trial.trial_id)
        if f is None:
            d = self.trial_dir(trial)
            if d is None:
                return None
            path = os.path.join(
                d, f"events.out.tfevents.{int(time.time())}.raytputorch")
            f = open(path, "ab")
            f.write(_tf_record(_event_proto(time.time(), 0,
                                            file_version="brain.Event:2")))
            self._files[trial.trial_id] = f
        return f

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        f = self._file(trial)
        if f is None:
            return
        step = int(result.get("training_iteration", 0))
        scalars = {k: float(v) for k, v in _scrub(result).items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)}
        if scalars:
            f.write(_tf_record(_event_proto(time.time(), step, scalars)))
            f.flush()

    def _close(self, trial) -> None:
        f = self._files.pop(trial.trial_id, None)
        if f is not None:
            f.close()

    on_trial_complete = _close
    on_trial_error = _close

    def on_experiment_end(self, trials) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


DEFAULT_LOGGERS = (JsonLoggerCallback, CSVLoggerCallback,
                   TensorBoardLoggerCallback)
