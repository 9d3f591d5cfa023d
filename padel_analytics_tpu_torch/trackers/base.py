"""Tracker abstraction: prediction accumulation + JSON prediction cache.

Counterpart of ``padel_analytics_tpu/trackers/base.py``: `TrackingResults`,
`Tracker`, the predict_sample / predict_frames dispatch, and the JSON cache
(save_predictions / load_predictions) whose files are interchangeable with
the JAX package's and the reference's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Iterator, Optional, Type

import numpy as np

from .objects import TrackedObject


class NoPredictSample(Exception):
    """Raised by trackers that only support whole-video prediction."""


class NoPredictFrames(Exception):
    """Raised by trackers that only support batched sample prediction."""


class TrackingResults:
    """Accumulated per-frame tracking results."""

    def __init__(self):
        self.predictions: list[TrackedObject] = []
        self.sample_predictions: list[TrackedObject] = []
        self.counter: int = 0

    def load(self, predictions: list[TrackedObject]) -> None:
        self.predictions = predictions
        self.sample_predictions = []
        self.counter = 0

    def update(self, predictions: list[TrackedObject]) -> None:
        self.predictions += predictions
        self.sample_predictions = predictions
        self.counter += 1

    def restart(self) -> None:
        self.predictions = []
        self.sample_predictions = []
        self.counter = 0

    def __len__(self) -> int:
        return len(self.predictions)

    def __getitem__(self, i: int) -> TrackedObject:
        return self.predictions[i]

    def __iter__(self) -> Iterator[TrackedObject]:
        return iter(self.predictions)


class Tracker:
    """Base tracker: result accumulation + JSON cache + dispatch."""

    batch_size: int = 8

    def __init__(
        self,
        load_path: Optional[str | Path] = None,
        save_path: Optional[str | Path] = None,
    ):
        self.results = TrackingResults()
        self.load_path = load_path
        self.save_path = save_path
        self.load_predictions()

    def video_info_post_init(self, video_info) -> "Tracker":
        """Declare attributes that depend on the source video."""
        return self

    def object(self) -> Type[TrackedObject]:
        raise NotImplementedError

    def draw_kwargs(self) -> dict:
        return {}

    def restart(self) -> None:
        self.results.restart()

    def __str__(self) -> str:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.results)

    def save_predictions(self) -> None:
        if self.save_path:
            parsable = [obj.serialize() for obj in self.results.predictions]
            with open(self.save_path, "w") as f:
                json.dump(parsable, f)
            print(f"{self}: {len(self)} predictions saved.")

    def load_predictions(self) -> None:
        if self.load_path and Path(self.load_path).exists():
            with open(self.load_path, "r") as f:
                parsable = json.load(f)
            self.results.load([self.object().from_json(x) for x in parsable])
            print(f"{self}: {len(self)} predictions loaded.")

    def predict_sample(self, sample: np.ndarray, **kwargs) -> list[TrackedObject]:
        raise NoPredictSample()

    def predict_frames(self, frame_generator: Iterable[np.ndarray], **kwargs) -> list[TrackedObject]:
        raise NoPredictFrames()

    def predict_and_update(self, frame_generator: Iterable[np.ndarray], **kwargs) -> TrackingResults:
        """Run whole-video prediction, updating `self.results`. Batched
        trackers get stacked chunks of `self.batch_size` frames (the last
        may be short)."""

        def sampler(generator, sequence_length):
            w = []
            for x in generator:
                w.append(x)
                if len(w) == sequence_length:
                    yield np.stack(w)
                    w = []
            if w:
                yield np.stack(w)

        try:
            predictions = self.predict_frames(frame_generator, **kwargs)
            self.results.predictions = predictions
        except NoPredictFrames:
            for sample in sampler(frame_generator, self.batch_size):
                self.results.update(self.predict_sample(sample, **kwargs))

        print(f"{self}: {len(self.results)} predictions.")
        return self.results
