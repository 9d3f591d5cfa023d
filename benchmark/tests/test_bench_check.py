"""The check that decides `correct`, driven through a whole run at a tiny
size on the CPU (the look for a card skipped): a sound run passes; the
control (the reference in float8 in the program's place) and each fault
planted in the timed path underneath come out not correct: one answer
altered where it is produced (a pose, the ball's position), half of each
batch left out (the ball's, the pose lane's), a lane that emits nothing,
a step that returns its state unchanged (one card: no exchange between
chips to leave out)."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import cell, check, control
from benchmark.manifest import Manifest
from benchmark.tests._tiny import tiny_tree
from padel_analytics_tpu_torch.trackers import BallTracker, PlayerKeypointsTracker, PlayerTracker

CELLS = ("tiny_fixed", "tiny_pan")
SEED = 2**31 + 11
#: The limits at the test size, set as the cells' are, between the port's
#: readings there (pose_kpt_rel ~2e-4, court_kpt_px ~1.2) and the control's
#: (~0.010-0.013, ~12.6). Toy maps put TrackNet's calibrated peaks within
#: 0.7 logits of the threshold, so the ball's margin here is 0.5 logits.
TINY_LIMITS = {"pose_kpt_rel": 0.0015, "court_kpt_px": 4.0, "ball_vis_far": 0, "csv_rows": 0,
               "ball_xy_off": 0, "players_frames_empty": 0, "players_extra": 0, "pose_missed": 0,
               "pose_extra": 0}


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    torch.set_num_threads(4)
    return Manifest(tiny_tree(tmp_path_factory.mktemp("tree"), TINY_LIMITS))


@pytest.fixture(autouse=True)
def toy_margin(monkeypatch):
    monkeypatch.setattr(check, "BALL_MARGIN", 0.5)


def _correct(manifest, workload) -> bool:
    result, _ = cell.run(manifest, workload, SEED, 0.0, False, time.perf_counter(), "cpu")
    json.dumps(result)
    return result["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(manifest, workload):
    assert _correct(manifest, workload)


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(manifest, workload):
    assert not control.readings(manifest, workload, SEED, "cpu")["correct"]


def _alter_one_answer(monkeypatch):
    host_step = PlayerKeypointsTracker.host_step

    def altered(self, *args, **kwargs):
        kpts, scores, valid = host_step(self, *args, **kwargs)
        kpts[0, :, :, :2] += 500.0  # one frame's answer, where it is produced
        return kpts, scores, valid

    monkeypatch.setattr(PlayerKeypointsTracker, "host_step", altered)


def _drop_half_the_batch(monkeypatch):
    step = BallTracker._window_step

    def half(self, frames_u8, median_u8, frame_carry, carry, coef):
        cx, cy, vis, frame_carry, carry = step(self, frames_u8, median_u8, frame_carry, carry,
                                               coef)
        b = len(vis) // 2  # the second half of the batch left out: no ball found there
        return (torch.cat([cx[:b], 0 * cx[b:]]), torch.cat([cy[:b], 0 * cy[b:]]),
                torch.cat([vis[:b], 0 * vis[b:]]), frame_carry, carry)

    monkeypatch.setattr(BallTracker, "_window_step", half)


def _half_the_pose_batch(monkeypatch):
    host_step = PlayerKeypointsTracker.host_step

    def half(self, *args, **kwargs):
        kpts, scores, valid = host_step(self, *args, **kwargs)
        valid[len(valid) // 2:] = False  # the second half of the batch left out
        return kpts, scores, valid

    monkeypatch.setattr(PlayerKeypointsTracker, "host_step", half)


def _players_lane_empty(monkeypatch):
    host_step = PlayerTracker.host_step

    def empty(self, *args, **kwargs):
        boxes, scores, valid = host_step(self, *args, **kwargs)
        return boxes, scores, valid & False

    monkeypatch.setattr(PlayerTracker, "host_step", empty)


def _move_the_ball(monkeypatch):
    step = BallTracker._window_step

    def moved(self, frames_u8, median_u8, frame_carry, carry, coef):
        cx, cy, vis, frame_carry, carry = step(self, frames_u8, median_u8, frame_carry, carry,
                                               coef)
        return torch.where(vis > 0, cx + 20, cx), cy, vis, frame_carry, carry

    monkeypatch.setattr(BallTracker, "_window_step", moved)


def _state_unchanged(monkeypatch):
    step = BallTracker._window_step

    def stale(self, frames_u8, median_u8, frame_carry, carry, coef):
        cx, cy, vis, _, _ = step(self, frames_u8, median_u8, frame_carry, carry, coef)
        return cx, cy, vis, frame_carry, carry

    monkeypatch.setattr(BallTracker, "_window_step", stale)


@pytest.mark.parametrize("fault", [_alter_one_answer, _drop_half_the_batch, _state_unchanged,
                                   _half_the_pose_batch, _players_lane_empty, _move_the_ball])
def test_a_fault_in_the_timed_path_is_not_correct(manifest, monkeypatch, fault):
    fault(monkeypatch)
    assert not _correct(manifest, "tiny_fixed")


def test_check_numbers_read_a_shifted_answer(monkeypatch):
    from benchmark.reference.pipeline import Answers, Candidates

    monkeypatch.setattr(check, "BALL_MARGIN", 2.0)
    cfg = {"pose": {"conf": 0.25, "iou": 0.7, "max_detections": 8},
           "players": {"conf": 0.5, "iou": 0.7, "max_detections": 8,
                       "polygon": [[0, 0], [1, 0], [1, 1], [0, 1]]},
           "ball": {"width": 100, "height": 100}}
    kpts = np.zeros((2, 13, 2))
    heat = torch.zeros(2, 100, 100)
    heat[:, 10, 10] = 0.99  # the reference's ball, at (10, 10) in both frames
    pose = Candidates(kpts, np.array([0.9, 0.2]), np.array([[0, 0, 10, 10], [50, 50, 60, 60.]]),
                      np.array([3, 7]), np.array([3]))
    players = Candidates(np.array([[40, 40, 60, 60.]]), np.array([0.95]),
                         np.array([[40, 40, 60, 60.]]), np.array([5]), np.array([5]))
    ref = Answers(players=[], pose=[np.zeros((1, 13, 2))] * 2, ball=np.array([[10, 10, 1]] * 2),
                  cands={"pose": [(kpts, pose.score, np.full((2, 2), -2.0), pose)] * 2,
                         "players": [players] * 2, "ball_heat": heat,
                         "ball_peak": np.array([0.99] * 2), "ball_pre_vis": np.array([1] * 2)})
    got = Answers(players=[np.array([[40, 40, 60, 60, 0.95]])] * 2,
                  pose=[np.full((1, 13, 2), 3.0)] * 2, ball=np.array([[10, 10, 0], [40, 10, 1]]))
    nums, basis = check.numbers(got, ref, cfg, (100, 100))
    assert nums == pytest.approx({"pose_kpt_rel": 3.0 / 10.0, "pose_missed": 0, "pose_extra": 0,
                                  "players_frames_empty": 0, "players_extra": 0, "ball_vis_far": 1,
                                  "ball_xy_off": 1})  # frame 1's ball lies 30 px off
    assert {k: basis[k] for k in ("players_sure", "pose_sure", "ball_far", "ball_seen")} == {
        "players_sure": 1, "pose_sure": 2, "ball_far": 2, "ball_seen": 1}
    got.players = [np.zeros((0, 5)), np.array([[0, 0, 5, 5, 0.9]])]  # one gone, one made up
    got.pose = [np.zeros((0, 13, 2)), np.full((1, 13, 2), 9.0)]
    nums, _ = check.numbers(got, ref, cfg, (100, 100))
    assert (nums["players_frames_empty"], nums["players_extra"]) == (0, 1)
    got.players = [np.zeros((0, 5))] * 2  # the lane emits nothing
    nums, basis = check.numbers(got, ref, cfg, (100, 100))
    assert (nums["players_frames_empty"], basis["players_sure_unmatched"]) == (1, 1)
    assert (nums["pose_missed"], nums["pose_extra"]) == (2, 1)
    ref.cands["ball_peak"] = np.array([0.6] * 2)  # a flip at the threshold counts nothing
    assert check.numbers(got, ref, cfg, (100, 100))[0]["ball_vis_far"] == 0
    ref.cands["ball_peak"], ref.cands["ball_pre_vis"] = np.array([0.01] * 2), np.array([0] * 2)
    # The reference inpainted those frames.
    assert check.numbers(got, ref, cfg, (100, 100))[0]["ball_vis_far"] == 0
