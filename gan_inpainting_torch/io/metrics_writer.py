"""A training run's record: scalars to ``<workdir>/metrics.jsonl`` (one JSON
object per event, ``{"step", "time", ...}``) and, where the ``tensorboard``
package imports, scalars and sample grids to a TensorBoard event file under
``<workdir>/tb``. Without TensorBoard the run keeps the jsonl only: the
record never stops training."""

from __future__ import annotations

import io
import json
import os
import pathlib
import socket
import time
from typing import Mapping

import numpy as np


class _EventFile:
    """A TensorBoard event file: ``Event`` protos framed by TensorBoard's
    ``RecordWriter``. ``torch.utils.tensorboard`` (and TensorBoard's own
    writer) load TensorFlow where one is installed, already at import:
    seconds, gigabytes, and whatever TensorFlow imports (keras, JAX) in
    this process. These protos need none of it."""

    def __init__(self, logdir: pathlib.Path):
        from tensorboard.compat.proto import event_pb2, summary_pb2
        from tensorboard.summary.writer.record_writer import RecordWriter

        self._event, self._summary = event_pb2.Event, summary_pb2.Summary
        logdir.mkdir(parents=True, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}."
                f"{socket.gethostname()}.{os.getpid()}")
        self._file = open(logdir / name, "wb")
        self._records = RecordWriter(self._file)
        self._write(self._event(wall_time=time.time(),
                                file_version="brain.Event:2"))

    def _write(self, event) -> None:
        self._records.write(event.SerializeToString())
        self._file.flush()

    def _add(self, step: int, values: list) -> None:
        self._write(self._event(wall_time=time.time(), step=step,
                                summary=self._summary(value=values)))

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        self._add(step, [self._summary.Value(tag=k, simple_value=float(v))
                         for k, v in values.items()])

    def image(self, step: int, tag: str, rgb_u8: np.ndarray) -> None:
        from PIL import Image

        png = io.BytesIO()
        Image.fromarray(rgb_u8).save(png, format="PNG")
        h, w, _ = rgb_u8.shape
        image = self._summary.Image(height=h, width=w, colorspace=3,
                                    encoded_image_string=png.getvalue())
        self._add(step, [self._summary.Value(tag=tag, image=image)])

    def close(self) -> None:
        self._records.close()


class MetricsWriter:
    def __init__(self, workdir: str, use_tensorboard: bool = True):
        self.dir = pathlib.Path(workdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                self._tb = _EventFile(self.dir / "tb")
            except ImportError:               # TensorBoard is optional
                self._tb = None

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        if self._tb is not None:
            self._tb.scalars(int(step), values)

    def images(self, step: int, name: str, images_u8: np.ndarray) -> None:
        """images_u8: (N, H, W, 3) uint8 sample grid, written as one image
        of the N rows stacked."""
        if self._tb is not None:
            grid = np.asarray(images_u8, np.uint8)
            self._tb.image(int(step), name,
                           grid.reshape(-1, *grid.shape[2:]))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
