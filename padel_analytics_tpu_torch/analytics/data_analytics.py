"""Per-frame player-position collection and kinematic features, without pandas.

Counterpart of ``padel_analytics_tpu/analytics/data_analytics.py``:
`PlayerPosition`, `DataPoint` and `DataAnalytics` with the same validation
(frame required, only ids 1-4 kept, a duplicate id raises) and `into_dict`.
The JAX package builds the feature table with pandas (`into_dataframe`) and
the CLI writes it with `DataFrame.to_csv`. The port computes the same
float64 columns, in the same order and with each operation in the same
order, in numpy (`into_columns`), and `write_csv` writes the bytes that
`to_csv` writes for that table (tests/test_torch_analytics.py holds it
against pandas). The port needs pandas only for `into_dataframe`, which
wraps those columns in a DataFrame.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

FRAME_INTERVALS = (1, 2, 3, 4)
PLAYER_IDS = (1, 2, 3, 4)


def _feature_columns() -> tuple[str, ...]:
    """The table's column names in the reference's order: the into_dict
    columns, time, then per interval its delta time, each player's per-axis
    delta, velocity, delta velocity and acceleration, distance (placed at
    interval 1) and the norms."""
    names = ["frame", *(f"player{p}_{a}" for p in PLAYER_IDS for a in "xy"), "time"]
    for fi in FRAME_INTERVALS:
        names.append(f"delta_time{fi}")
        for pid in PLAYER_IDS:
            for pos in "xy":
                names += [f"player{pid}_delta{pos}{fi}", f"player{pid}_V{pos}{fi}",
                          f"player{pid}_deltaV{pos}{fi}", f"player{pid}_A{pos}{fi}"]
            if fi == 1:
                names.append(f"player{pid}_distance")
            names += [f"player{pid}_Vnorm{fi}", f"player{pid}_Anorm{fi}"]
    return tuple(names)


#: The data.csv columns after its unnamed index, in order.
COLUMNS = _feature_columns()


class InvalidDataPoint(Exception):
    pass


@dataclass
class PlayerPosition:
    """Player position in meters at one frame."""

    id: int
    position: tuple[float, float]

    def __post_init__(self):
        if not (isinstance(self.position[0], float) and isinstance(self.position[1], float)):
            raise TypeError(f"position must be two floats, got {self.position!r}")

    @property
    def key(self) -> str:
        return f"player{self.id}"


@dataclass
class DataPoint:
    """All collected data at one frame."""

    frame: int = None
    players_position: Optional[list[PlayerPosition]] = None

    def validate(self) -> None:
        if self.frame is None:
            raise InvalidDataPoint("Unknown frame")
        if self.players_position is None:
            return
        kept = [p for p in self.players_position if p.id in PLAYER_IDS]
        ids = [p.id for p in kept]
        if len(ids) != len(set(ids)):
            raise InvalidDataPoint("N-plicate player id")
        self.players_position = kept

    def add_player_position(self, player_position: PlayerPosition) -> None:
        if self.players_position is None:
            self.players_position = [player_position]
        else:
            self.players_position.append(player_position)

    def sort_players_position(self) -> Optional[list[PlayerPosition]]:
        if self.players_position:
            return sorted(self.players_position, key=lambda p: p.id)
        return None


def _diff(a: np.ndarray, k: int) -> np.ndarray:
    """Series.diff(k) of a float64 column: a[i] - a[i - k], the first k NaN."""
    out = np.full_like(a, np.nan)
    out[k:] = a[k:] - a[:-k]
    return out


def _float_field(v) -> str:
    """One float as to_csv writes it: NaN empty, else the shortest repr."""
    return "" if v != v else repr(v)


class DataAnalytics:
    """Whole-clip player-position collector."""

    def __init__(self):
        self.frames = [0]
        self.current_datapoint = DataPoint(frame=self.frames[-1])
        self.datapoints: list[DataPoint] = []

    def restart(self) -> None:
        self.__init__()

    @classmethod
    def from_dict(cls, data: dict) -> "DataAnalytics":
        frames = data["frame"]
        instance = cls()
        instance.frames = frames
        datapoints = []
        for i in range(len(frames)):
            players = []
            for pid in PLAYER_IDS:
                x = data[f"player{pid}_x"][i]
                y = data[f"player{pid}_y"][i]
                if x is None or y is None:
                    continue
                players.append(PlayerPosition(id=pid, position=(x, y)))
            datapoints.append(DataPoint(frame=frames[i], players_position=players or None))
        instance.datapoints = datapoints
        instance.current_datapoint = None
        return instance

    def __len__(self) -> int:
        return len(self.frames)

    def update(self) -> None:
        self.current_datapoint.validate()
        self.datapoints.append(self.current_datapoint)
        self.current_datapoint = DataPoint(frame=self.frames[-1])

    def step(self, x: int = 1) -> None:
        new_frame = self.frames[-1] + 1
        if new_frame in self.frames:
            raise InvalidDataPoint(f"frame {new_frame} already collected")
        self.frames.append(new_frame)
        self.update()

    def add_player_position(self, id: int, position: tuple[float, float]) -> None:
        self.current_datapoint.add_player_position(PlayerPosition(id=id, position=position))

    def into_dict(self) -> dict[str, list]:
        data: dict[str, list] = {"frame": []}
        data.update({f"player{p}_{a}": [] for p in PLAYER_IDS for a in "xy"})
        for datapoint in self.datapoints:
            data["frame"].append(datapoint.frame)
            n = len(data["frame"])
            players = datapoint.sort_players_position()
            if players:
                for p in players:
                    data[f"{p.key}_x"].append(p.position[0])
                    data[f"{p.key}_y"].append(p.position[1])
            for k, v in data.items():
                if len(v) < n:
                    data[k].append(None)
        return data

    def into_columns(self, fps: float) -> dict[str, np.ndarray]:
        """The feature table as ordered columns (`COLUMNS`): `frame` int64,
        every other column float64, None as NaN. The same values, bit for
        bit, as the JAX package's `into_dataframe(fps)`."""
        data = self.into_dict()
        cols: dict[str, np.ndarray] = {"frame": np.asarray(data["frame"], dtype=np.int64)}
        for name, values in data.items():
            if name != "frame":
                cols[name] = np.array([np.nan if v is None else v for v in values],
                                      dtype=np.float64)
        cols["time"] = cols["frame"] * (1 / fps)
        for fi in FRAME_INTERVALS:
            dt = cols[f"delta_time{fi}"] = _diff(cols["time"], fi)
            for pid in PLAYER_IDS:
                p = f"player{pid}"
                for pos in "xy":
                    delta = cols[f"{p}_delta{pos}{fi}"] = _diff(cols[f"{p}_{pos}"], fi)
                    v = cols[f"{p}_V{pos}{fi}"] = delta / dt
                    dv = cols[f"{p}_deltaV{pos}{fi}"] = _diff(v, fi)
                    cols[f"{p}_A{pos}{fi}"] = dv / dt
                # Rewritten at every interval from the interval-1 deltas, as
                # the reference does; the column keeps its first place.
                cols[f"{p}_distance"] = np.sqrt(cols[f"{p}_deltax1"] ** 2
                                                + cols[f"{p}_deltay1"] ** 2)
                cols[f"{p}_Vnorm{fi}"] = np.sqrt(cols[f"{p}_Vx{fi}"] ** 2
                                                 + cols[f"{p}_Vy{fi}"] ** 2)
                cols[f"{p}_Anorm{fi}"] = np.sqrt(cols[f"{p}_Ax{fi}"] ** 2
                                                 + cols[f"{p}_Ay{fi}"] ** 2)
        return cols

    def into_dataframe(self, fps: float):
        """The feature table as a pandas DataFrame (`into_columns`); pandas
        is imported here, and only here."""
        import pandas as pd

        return pd.DataFrame(self.into_columns(fps))

    def write_csv(self, path: str | Path, fps: float) -> None:
        """Write the feature table as `into_dataframe(fps).to_csv(path)`
        does: the row index first under an empty header, NaN as an empty
        field, floats in their shortest round-trip form, lines ended by
        '\\n'."""
        cols = self.into_columns(fps)
        n = len(cols["frame"])
        frame = cols["frame"].tolist()
        floats = [cols[name].tolist() for name in COLUMNS[1:]]
        lines = ["," + ",".join(COLUMNS)]
        for i in range(n):
            lines.append(f"{i},{frame[i]}," + ",".join(_float_field(c[i]) for c in floats))
        with open(path, "w", newline="") as f:
            f.write("\n".join(lines) + "\n")
