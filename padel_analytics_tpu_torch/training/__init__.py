"""Training: the TrackNet, InpaintNet, ResNet-50 court and YOLOv8 train
steps (Adam, autograd, alone or data-parallel over the port's Mesh), their
losses, labels, augmentations and data, the evaluation metrics and the
checkpoints the trackers load."""

from .evaluate import detection_map, greedy_match, oks
from .inpaintnet import make_inpaintnet_train_step, masked_coordinate_loss
from .resnet_court import court_regression_loss, make_court_train_step, normalize_court_targets
from .state import TrainState, adam, init_train_state
from .tracknet import gaussian_heatmap_labels, make_tracknet_train_step, weighted_bce_loss
from .yolo import make_yolo_train_step, task_aligned_assign, yolo_detection_loss, yolo_pose_loss

__all__ = [
    "TrainState",
    "adam",
    "court_regression_loss",
    "detection_map",
    "gaussian_heatmap_labels",
    "greedy_match",
    "init_train_state",
    "make_court_train_step",
    "make_inpaintnet_train_step",
    "make_tracknet_train_step",
    "make_yolo_train_step",
    "masked_coordinate_loss",
    "normalize_court_targets",
    "oks",
    "task_aligned_assign",
    "weighted_bce_loss",
    "yolo_detection_loss",
    "yolo_pose_loss",
]
