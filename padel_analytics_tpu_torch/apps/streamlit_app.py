"""Streamlit dashboard (the reference's app.py) over the port's pipeline.

    streamlit run padel_analytics_tpu_torch/apps/streamlit_app.py

Counterpart of ``padel_analytics_tpu/apps/streamlit_app.py``, with the
reference's views:

- upload, an ffmpeg re-encode and a full pipeline run (`apps/cli.py::
  build_pipeline`, on the card);
- the ball's velocity between two chosen frames
  (analytics/velocity_estimator.py), drawn on the frame and on the court;
- each player's distance and mean / maximum speed, and speed against time;
- the players' positions on the 2-D court, filtered by a speed interval and
  by a time span, colored by speed in km/h.

streamlit, plotly and pandas are imported by `main()` and the views, not
when the module is imported; where streamlit or plotly is absent, `main()`
raises ImportError saying so. Imports are absolute, so that `streamlit run`
can run the file by its path. The re-encode runs ffmpeg with an argument
list (no shell); where there is no ffmpeg the upload is used as it is.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

from padel_analytics_tpu_torch.analytics.velocity_estimator import (
    BallVelocityEstimator,
    ImpactType,
)
from padel_analytics_tpu_torch.apps.cli import build_pipeline, load_config_file
from padel_analytics_tpu_torch.config import PipelineConfig
from padel_analytics_tpu_torch.utils.video import VideoInfo, read_video
from padel_analytics_tpu_torch.visualizations.padel_court import padel_court_2d


def _ui():
    """(streamlit, plotly.graph_objects), or ImportError."""
    try:
        import plotly.graph_objects as go
        import streamlit as st
    except ImportError as e:
        raise ImportError(
            "The dashboard needs streamlit + plotly: pip install streamlit plotly"
        ) from e
    return st, go


def velocity_estimator_view(video_info: VideoInfo):
    st, go = _ui()
    # Bounded by the frames decoded (CAP_PROP_FRAME_COUNT can overestimate;
    # the reference's inclusive bound indexed one past the list).
    last = len(st.session_state["video"]) - 1
    frame_index = st.slider("Frames", 0, last, min(1, last))
    st.image(np.array(st.session_state["video"][frame_index]))

    with st.form("choose-frames"):
        frame_index_t0 = st.number_input("First frame: ", min_value=0, max_value=last)
        frame_index_t1 = st.number_input("Second frame: ", min_value=min(1, last),
                                         max_value=last)
        impact_type_ch = st.radio("Impact type: ", options=["Floor", "Player"])
        get_vz = st.radio("Consider difference in ball altitude: ", options=[False, True])
        estimate = st.form_submit_button("Calculate velocity")

    if estimate:
        runner = st.session_state["runner"]
        estimator = BallVelocityEstimator(
            source_video_fps=video_info.fps,
            players_detections=runner.trackers["players_tracker"].results.predictions,
            ball_detections=runner.trackers["ball_tracker"].results.predictions,
            keypoints_detections=runner.trackers["keypoints_tracker"].results.predictions,
        )
        impact_type = ImpactType.FLOOR if impact_type_ch == "Floor" else ImpactType.RACKET
        data, velocity = estimator.estimate_velocity(
            int(frame_index_t0), int(frame_index_t1), impact_type, get_Vz=get_vz
        )
        st.write(velocity)
        st.write("Velocity: ", velocity.norm)
        st.image(data.draw_velocity(st.session_state["video"]))
        court = padel_court_2d()
        court.add_trace(
            go.Scatter(
                x=[data.position_t0_proj[0], data.position_t1_proj[0]],
                y=[data.position_t0_proj[1] * -1, data.position_t1_proj[1] * -1],
                marker=dict(size=10, symbol="arrow-bar-up", angleref="previous"),
            )
        )
        st.plotly_chart(court)


def _scatter_on_court(df, player_choice, velocity_type, vmin, vmax):
    _, go = _ui()
    court = padel_court_2d()
    court.add_trace(
        go.Scatter(
            x=df[f"player{player_choice}_x"],
            y=df[f"player{player_choice}_y"] * -1,
            mode="markers",
            name=f"Player {player_choice}",
            text=df[f"player{player_choice}_V{velocity_type}4"].abs() * 3.6,
            marker=dict(
                color=df[f"player{player_choice}_V{velocity_type}4"].abs() * 3.6,
                size=12,
                showscale=True,
                colorscale="jet",
                cmin=vmin * 3.6,
                cmax=vmax * 3.6,
            ),
        )
    )
    return court


def _reencode(upload_video_path: str) -> None:
    """tmp.mp4: the upload re-encoded to H.264 by ffmpeg, or a link to the
    upload itself where ffmpeg is absent or fails."""
    # Any previous tmp.mp4 (file or link) goes first: the fallback would
    # otherwise keep the previous upload, and a dangling link makes
    # os.symlink raise.
    if os.path.lexists("tmp.mp4"):
        os.remove("tmp.mp4")
    try:
        subprocess.run(["ffmpeg", "-y", "-i", upload_video_path, "-vcodec", "libx264",
                        "tmp.mp4"], check=False)
    except FileNotFoundError:
        pass  # no ffmpeg binary: the link below
    if not os.path.exists("tmp.mp4"):
        os.symlink(os.path.abspath(upload_video_path), "tmp.mp4")


def main():
    st, go = _ui()
    import pandas as pd

    for key in ("video", "df", "runner"):
        st.session_state.setdefault(key, None)

    st.title("Padel Analytics (PyTorch / CUDA)")

    with st.form("run-video"):
        upload_video_path = st.text_input("Upload video: ", "")
        config_path = st.text_input(
            "Config module (reference-style config.py with model weight "
            "paths + FIXED_COURT_KEYPOINTS_LOAD_PATH): ",
            "",
        )
        upload_video = st.form_submit_button("Upload")

    if not (upload_video or st.session_state["video"] is not None):
        return

    if upload_video:
        st.session_state["df"] = None
        st.session_state["video"] = None
        _reencode(upload_video_path)

    if st.session_state["df"] is None:
        with st.spinner("Analysing video ..."):
            cfg = load_config_file(config_path) if config_path else PipelineConfig()
            cfg.input_video_path = "tmp.mp4"
            try:
                runner = build_pipeline(cfg, interactive=False)
            except RuntimeError as e:
                st.error(
                    f"{e}. Point the config field at a reference-style "
                    "config.py, or create the keypoints JSON with "
                    "`python -m padel_analytics_tpu_torch.apps.keypoint_picker`."
                )
                return
            runner.run()
            st.session_state["runner"] = runner
            st.session_state["df"] = pd.DataFrame(
                runner.data_analytics.into_columns(runner.video_info.fps))
            st.success("Done.")

    if st.session_state["video"] is None:
        # Decoded once per upload: every widget interaction reruns main().
        frames, _, _, _ = read_video("tmp.mp4")
        st.session_state["video"] = frames
    st.subheader("Uploaded Video")
    st.video("tmp.mp4")

    if st.checkbox("Calculate Ball Velocity"):
        st.write("Select a frame to calculate ball velocity:")
        st.fragment(velocity_estimator_view)(st.session_state["runner"].video_info)

    df = st.session_state["df"]
    if df is None:
        return

    st.header("Collected data")
    st.write("First 5 rows")
    st.dataframe(df.head())
    st.markdown(f"- Number of rows: {len(df)}")

    velocity_type = {"Horizontal": "x", "Vertical": "y", "Absolute": "norm"}[
        st.radio("Type", ["Horizontal", "Vertical", "Absolute"])
    ]

    fig = go.Figure()
    for pid in (1, 2, 3, 4):
        fig.add_trace(
            go.Scatter(
                x=df["time"],
                y=np.abs(df[f"player{pid}_V{velocity_type}4"].to_numpy()),
                mode="lines",
                name=f"Player {pid}",
            )
        )

    players_data = {
        "player_id": [],
        "total_distance_m": [],
        "mean_velocity_km/h": [],
        "maximum_velocity_km/h": [],
    }
    for pid in (1, 2, 3, 4):
        v = df[f"player{pid}_V{velocity_type}4"].abs()
        players_data["player_id"].append(pid)
        players_data["total_distance_m"].append(df[f"player{pid}_distance"].sum())
        players_data["mean_velocity_km/h"].append(v.mean() * 3.6)
        players_data["maximum_velocity_km/h"].append(v.max() * 3.6)
    st.dataframe(pd.DataFrame(players_data).set_index("player_id"))

    st.subheader("Players velocity as a function of time")
    st.plotly_chart(fig)

    st.subheader("Analyze players position, velocity and acceleration")
    col1, col2 = st.columns((1, 1))
    with col1:
        player_choice = st.radio("Player: ", options=[1, 2, 3, 4])
    with col2:
        v_abs = df[f"player{player_choice}_V{velocity_type}4"].abs()
        vmin, vmax = float(v_abs.min()), float(v_abs.max())
        velocity_interval = st.slider("Velocity Interval", vmin, vmax, (vmin, vmax))

    mask = v_abs.between(velocity_interval[0], velocity_interval[1])
    st.plotly_chart(_scatter_on_court(df[mask], player_choice, velocity_type, vmin, vmax))

    time_span = st.slider("Time Interval", 0.0, float(df["time"].max()))
    st.plotly_chart(
        _scatter_on_court(
            df[df["time"] <= time_span], player_choice, velocity_type, vmin, vmax
        )
    )


if __name__ == "__main__":
    main()
