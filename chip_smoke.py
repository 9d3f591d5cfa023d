"""Drive the PyTorch/CUDA port's ball, players, pose, fused, collect,
model-court, multi-device and training paths, its CLI, its weights formats,
its validation app, the mesh's model axis, the training and quality
harness and the staged fused path on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-ranks N   # only the mesh, one process on each of N cards
    python3 chip_smoke.py --mesh-ranks N --model-axis-only   # only 19 (c) on N cards

Phases (any failure raises, so the exit code is non-zero and no result line
is printed):

1. report the card (nvidia-smi name and power limit) and the toolchain;
2. build kernels K1 (conv3x3_bn_act) and K2 (heatmap_cc) from csrc/, one
   nvcc each, started together;
3. K1 at the 11 distinct conv shapes of TrackNet at 288x512 (relu), at the
   shapes the players and pose paths launch (YOLOv8m detect at the 384x640
   letterbox of 1080p: 14 distinct in 52 convs; YOLOv8m-pose at 1280x1280:
   20 in 58; traced from the models on the meta device; silu), each at the
   per-tracker batch of 8 and at the fused chunk of 16, and at YOLOv8m's 6
   stride-1 3x3 shapes at a 640x640 input (batch 8), against the fp32 plain
   version; each timed beside its plain version, the library call for the
   same function (cuDNN bf16 conv + affine + act) and its bound (the larger
   of bytes over 3.35 TB/s and FLOPs over 989 TFLOP/s). Sums over each
   model's convs in call order are printed at both batches, and over one
   fused chunk's 127 launches (the kernels line's numbers), with the time of
   the C2f split copies K1's wrapper makes;
4. K2 on 288x512 heatmaps at both cluster sizes (8 and 16), at batch 8 and
   at the fused chunk of 16 (the kernels line's numbers): fuzzed blobs
   (empty map and exact ties included), uniform masks (10, 50 and 100% at
   batch 8, 50% at 16) and bars through every band, each bit-equal to the
   plain version and timed; cudaOccupancyMaxActiveClusters of each size and
   the plan's choice printed;
5. the models: TrackNet, TrackNet with subpixel_up (also against the dense
   TrackNet), YOLOv8m detect and YOLOv8m-pose on the card (bf16, K1)
   against their fp32 plain path on the CPU, on a small input;
6. the ball slice: BallTracker at its full configuration (288x512, seq_len 8,
   bg_mode concat, batch 8, bf16, median over the clip's head) with random
   weights from a seed, on a synthetic 1920x1080 rally clip, through
   predict_and_update + save_predictions (the per-tracker body of
   TrackingRunner.run). Every kernel launch counter is zeroed just before
   and read just after; both kernels must have run. A second pass must
   equal the first; a third, under torch.profiler, gives the device busy
   share and each kernel's device time;
7. the players slice: PlayerTracker at its full configuration (YOLOv8m
   detect, letterbox to 640, conf .5, iou .7, person class, polygon gate,
   ByteTrack) with random weights from a seed, its cls head calibrated to
   ~16 candidates a frame, over a synthetic 1920x1080 rally with four
   player figures, through predict_and_update + save_predictions: 52 K1
   launches a chunk, a second pass equal to the first, a third under
   torch.profiler; one chunk's step split into its host and device parts
   (np.stack, upload, preprocess + model, NMS, predict_sample);
8. the pose slice: the same with PlayerKeypointsTracker (YOLOv8m-pose, PIL
   squash to 1280, conf .25): 58 K1 launches a chunk, 13 keypoints a
   detection;
9. the fused pipeline with decisive fake models (a cell detector scoring
   0.9 or 0.1, a bright-pixel TrackNet) on a 45-frame 1920x1080 clip:
   FusedPipeline.run with rgb ingest at chunk 16 and 8 must give the
   per-tracker paths' caches exactly, frame by frame (a race between the
   streams would show here);
10. the main path: TrackingRunner(fused=True) over all four trackers at full
   width (YOLOv8m detect with the polygon gate, YOLOv8m-pose at 1280,
   TrackNet 288x512, a fixed court; cls heads calibrated) on a 128-frame
   1920x1080 rally held in memory, for the i420 then the rgb ingest at
   chunk 16: the launch counters zeroed before and read after the first
   pass (K1 110 a chunk of clip frames + 17 a chunk for TrackNet, K2 one a
   chunk), a second pass equal to the first and timed, measure_device_split
   (device ms a chunk of each sub-step, host pack ms a frame), and a third
   pass under torch.profiler (device busy share over all streams, the top
   device ops, kernel launches a chunk, the longest device idle gaps, host
   synchronisations);
11. the collect pass with the decisive fakes: the fused run's data.csv
   (TrackingRunner(collect_data=True, render=False), the port's pandas-free
   writer) must equal the per-tracker run's byte for byte;
12. the main path with its collect pass: TrackingRunner(fused=True,
   render=False, collect_data=True) over the same 128-frame rally at full
   width and the runner's default ingest, data.csv written: the launch
   counters zeroed before and read after (these are the kernels line's
   launches), the reference's columns and one row a frame, a second run
   writing the same bytes, a per-tracker runner over the saved caches (no
   inference, no launch) writing them too; the collect pass's host ms a
   frame and fused + collect frames/s printed beside the card; then
   render=True: where OpenCV is absent the runner must refuse when it is
   built, naming cv2, before any inference; where it is present, 16 frames
   are drawn, encoded and read back, and the draw pass timed;
13. the CLI's own code: apps.cli.run_pipeline over a 32-frame clip in
   memory with a keypoints JSON and no render, at the reference's default
   configuration, writing data.csv;
14. the fast configuration, the JAX package's headline plan:
   TrackingRunner(fused=True, fused_ingest="derived", fused_wire_long_side
   =960) with YOLOv8m detect @640, YOLOv8m-pose @640 and TrackNet with
   subpixel_up, a fixed court, on the 128-frame 1080p rally at chunk 16,
   once at fused_ball_stride=1 and once at 8: K1 checked and timed at its
   new shapes (pose at 640x640, the subpixel skip convs with an identity
   epilogue) beside cuDNN and the bound; the resize passes' dense or banded
   form printed, and the banded passes of the fused plans against the
   dense form on the card; the host's INTER_AREA bit-equal to cv2 where
   OpenCV imports; the host pack (INTER_AREA and I420 apart, one thread and
   the pool); decisive fakes at 1080p (the derived run's boxes and
   keypoints equal to the rgb run's within 1e-2 px, the nonoverlap caches
   equal to the stride-1 caches); then per stride two passes (the second
   equal to the first), the launches counted over the first,
   measure_device_split, peak device memory and a profiled pass (K1 and K2
   device ms a chunk);
15. the model-based court and InpaintNet: K1 checked and timed at the court
   YOLOv8m-pose's shapes (12 keypoints, 640x640 squash; 58 convs, the same
   shapes as pose @640) and at ResNet-50's 13 stride-1 conv2s at 224x224,
   each at batch 8 and 16, beside cuDNN and the bound (in phase 3's order,
   before K2); in phase 5, the court YOLOv8m-pose and ResNet-50 (bf16, K1 +
   cuDNN, He-normal weights) against their fp32 plain path and InpaintNet
   on the card against the CPU; the decisive check at 1080p (a 12-keypoint
   cell detector and ResNet-50 as the court, an InpaintNet on the ball, a
   6-frame ball gap and 3 blank frames): the fused runner's court and
   inpainted ball caches equal to the per-tracker runner's (the resnet
   court within 1e-2 px at the same batch), the yolo run's data.csv too;
   then the moving-camera main path at full width,
   TrackingRunner([players, pose, ball + InpaintNet, court], fused=True,
   render=False, collect_data=True), with the court from YOLOv8m-pose (12
   keypoints) @640 and then from ResNet-50 @224, heads calibrated: launches
   counted over the first pass (the kernels line's court_yolo and
   court_resnet), a second pass equal to the first (caches and data.csv),
   measure_device_split's court sub-step, the inpaint pass's ms, peak
   memory and the frames without a court;
16. the multi-device path as the card's machine runs it: an NCCL group of
   one rank on the card (127.0.0.1, a free port) and make_mesh(data=1).
   (a) With the decisive fakes on the 45-frame 1080p clip at chunk 16,
   TrackingRunner(fused=True, mesh=...) writes the single-device run()'s
   caches and data.csv byte for byte: with association 'host' against
   run()'s default, and under 'auto' (the scan) against run() with
   'device'. (b) The reference plan at full width through the mesh runner
   (render=False, collect_data=True) on the 128-frame rally: the launch
   counters zeroed before and read after the first pass (the kernels line's
   'mesh'), a second pass equal to the first and timed (frames/s), the ball
   ints' agreement with run() on the same clip, the scan's ms a chunk at
   the drain, its ms a chunk on the card and on the host's torch and its
   device launches a chunk on the same rows, its ID divergence from host
   ByteTrack on the same detections, and a pass under torch.profiler. (c) run() with fused_association='device' at full
   width, its frames/s. (d) BallTracker(mesh=...) against the single-device
   ball: equal with the decisive fake at 1080p, the agreement printed at
   full width with random weights; and one YOLOv8m train step through the
   mesh (17 b);
17. training, fp32 with TF32 off, with seeded LeCun weights: (a) each family
   at full width on one fixed synthetic batch: YOLOv8m detect and
   YOLOv8m-pose (13 keypoints) at 640, batch 8; TrackNet (concat, 27
   channels) at 288x512, seq 8, batch 8; ResNet-50 court at 224, batch 8;
   InpaintNet, seq 16, batch 32. One forward and backward on the card
   against the same on the host CPU (same weights and batch; YOLOv8m and
   TrackNet at batch 2; YOLO's assignment made once and given to both) and
   a float64 CPU step: the loss within 1e-4 of the CPU's, the gradient no
   farther from float64 than twice the CPU's fp32 gradient is (+1e-4,
   relative L2). Then 10
   Adam steps: finite losses that fall, the median step ms after 2
   warm-up steps and the peak device memory. (b) In phase 16's NCCL group
   of one rank, one YOLOv8m step through the mesh path against the no-mesh
   step. (c) Train -> serve: a synthetic 96-frame rally directory (frames
   and csv/<id>_ball.csv) trained on by apps.train_tracknet on the card;
   its .pt served by BallTracker (channel_quirk=False: RGB frames, as in
   training) through K1 and K2 (launches counted, the
   kernels line's 'train_serve'), the mean ball error against the truth
   printed for random and trained weights, the trained one lower; then
   apps.train_yolo (YOLOv8m) on 16 synthetic scenes and apps.evaluate on
   its checkpoint through K1 (the kernels line's 'evaluate'), its JSON line
   printed;
18. weights and validation: (a) full-width seeded weights written in the
   reference's formats by training/checkpoint.py (YOLOv8m detect and
   YOLOv8m-pose with 13 keypoints, cls heads calibrated; TrackNet with its
   param_dict; InpaintNet; ResNet-50 under torchvision names), each
   converted by apps.convert_weights to the JAX package's .msgpack and to
   its orbax checkpoint directory and read back through core/checkpoint.py:
   every tensor bit-equal to the .pt's, the read ms of each format printed;
   (b) the main path, TrackingRunner(fused=True, render=False,
   collect_data=True) at the reference plan with InpaintNet on the ball, on
   a 48-frame 1920x1080 rally, with the trackers loaded from the .pt files,
   from the .msgpack files and from the orbax directories: the caches and
   data.csv byte-equal, the launch counters zeroed before and read after
   each pass (the kernels line's 'validate' and 'validate_orbax'),
   frames/s of each; (c) apps.validate_weights (its
   main, with the clip in memory) on the .pt files against reference caches
   from the per-tracker paths (batch = the fused chunk, on the frames the
   i420 ingest delivers): within_1px_verdict true, max_px_overall printed;
   with --fast-path, the fast plan's max px against the reference plan per
   tracker (random weights); (d) compare_predictions over (b)'s .pt and
   .msgpack runs (0 px), and BallVelocityEstimator and detect_hits over
   (b)'s results: one estimate's m/s, the hit count and their host ms; (e)
   the committed JAX-written orbax directory (tests/data_torch/orbax_jax/,
   OCDBT + zstd) read on the host through the zstd decoder built from
   csrc/zstd_decode.c by the host C compiler: every leaf's sha256 equal to
   tests/data_torch/orbax_jax.sha256.json, the decoder's build seconds and
   MB/s printed;
19. the mesh's model axis (conv-channel tensor parallelism), fp32 with TF32
   off: (a) two processes on the card joined by gloo (the phase's choice:
   NCCL refuses two ranks on one card), a data 1 x model 2 mesh; each family
   at full width (YOLOv8m detect and pose at 640 and TrackNet at 288x512,
   batch cut to 2; ResNet-50 at 224, batch 8; InpaintNet, batch 32) takes
   one sharded step from seeded weights against the one-process card step
   on the same batch (bounds at TP_LOSS_TOL), then two steps timed with the
   port's StageTimer (gloo stages every collective through the host: the
   step ms measure that, not tensor parallelism on the card), the per-rank
   peak memory and parameter + Adam bytes against the unsharded model's;
   (b) apps.train_tracknet --model-parallel 2 on the two ranks for one step
   on a 15-frame 1024x576 rally against --model-parallel 1, its gathered
   .pt served by BallTracker on the card through K1 and K2 (launches
   counted: the kernels line's 'model_axis');
20. the training and quality harness (padel_analytics_tpu_torch/tools),
   trained in fp32 (TF32 off) and served in bf16, its six demos side by
   side in processes of their own (their steps are bound by the host's
   launches): (d) the scenes' sha256
   digests equal to the CPU's (tests/_torch_tools_cases.py), K1 at every
   shape the demos launch (TrackNet 48x80 at batch 1 and 8, YOLOv8n detect
   and pose at the demos' inputs, 78 shapes, the pose keypoint branch's
   39 channels included) within phase 3's bound, K2 at 48x80 bit-equal at
   both cluster sizes on blobs, a dense mask and the trained TrackNet's
   heatmaps; (a) the four convergence demos at the JAX tests' budgets and
   bounds (tests/test_convergence_demo.py; the stride demo at 120 steps),
   the launch counters zeroed before each demo and read after it (training
   launches neither kernel), the same weights served in fp32 on the CPU
   beside the bf16 rows; (b) derived_quality at scale 1 (300 detector and
   300 pose steps) with the five invariants of tests/test_derived_quality.py,
   its parity and fast configs served in fp32 on the CPU beside; (c) at scale 5, half production (source
   960x540, wire 480, pose 640 -> 320, det letterbox 320): the four configs
   printed, the parity config held to localize; (f) the trained TrackNet
   and YOLOv8n kept under padel_analytics_tpu_torch/_build/tools/ (the
   kernels line's 'tools_*' paths);
21. the staged path (FusedPipeline.run_staged: one upload a round of
   superchunk chunks, one CUDA-graph replay a sub-step lane a round):
   (a) phase 9's decisive fakes on its 45-frame 1920x1080 clip at chunk 16
   x superchunk 2 and 8 x 3, for the rgb, i420 and derived ingests,
   ball_stride 8, a yolo court fake and the device association: every
   cache equal to run()'s frame by frame, each lane one graph replay a
   round; (b) the full TrackNet on the ball: a predictor bias raised and a
   BatchNorm scale (folded into K1) zeroed in place between runs each
   change the ball and recapture the ball lane, restored each restore it;
   (c) phase 10's trackers and clip through TrackingRunner(fused=True,
   fused_staged=S) at S = 4 and 16 beside run(): the caches equal run()'s,
   frames/s (median of 3 passes), the wrappers' launch counters over the
   first pass (the warm-up chunk and the capture of each graph, which a
   replay does not pass through), a profiled pass each (busy share, K1 and
   K2 executions counted by the profiler against the design's count: 127
   K1 and one K2 for every chunk of every round, 1033 and 9 for run();
   graph launches, 3 a round), capture s, the loop's host split, pinned
   host bytes, peak device memory; (d) FastTrackNet at 288x512, batch 16,
   bf16: 17 K1 launches a forward, equal to the TrackNet module's K1 stacks
   and the same fp32 predictor, within 2e-2 of the module's output and of
   its plain version, timed. The kernels line's 'staged_*' entries carry
   the S = 16 pass's profiled executions and device ms a chunk, and
   'fast_tracknet' (d)'s numbers.
22. entry points in the JAX package's call forms: (a) the ball path at
   its full configuration on phase 6's rally with phase 15's InpaintNet
   checkpoint and use_inpaintnet=False: no InpaintNet built and none run,
   K1 / K2 launches equal to phase 6's, the cache byte-equal to the tracker's
   with no inpaint path (a tracker with the flag on runs InpaintNet: the
   control); then TrackingRunner(fused=True) with it, the caches equal to
   the path-less tracker's fused run, and FusedPipeline.run streaming every
   frame's ball before the end; (b) a full-width YOLOv8m detector (cls head
   calibrated) written as .msgpack and as an orbax directory, read back by
   core.checkpoint.load_checkpoint(target, path) and served through the
   players path: K1 launches equal to phase 7's, caches byte-equal to the
   one-argument load's. The kernels line's launches_by_path carries
   'ball_no_inpaint' and 'load_target'.

With --mesh-ranks N (N cards) it builds the kernels and runs the mesh over N
processes, one a card, joined by NCCL: the decisive fakes' caches on every
rank equal to a one-card run()'s with the scan; the full-width reference
plan through the mesh runner (cls heads calibrated once, on card 0), every
rank's results equal to rank 0's, its frames/s beside the one-card run()'s
and run_mesh's on card 0, and the ball ints' agreement with run(). Then
(19 c) one YOLOv8m step (batch 8) at data N/2 x model 2 over NCCL against
the one-card step, within phase 19's bounds; --model-axis-only runs this
alone.

The line before the last is the kernels' JSON record (the card's name and
power limit with --mesh-ranks); the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import hashlib
import io
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from padel_analytics_tpu_torch import _build
from padel_analytics_tpu_torch.analytics.data_analytics import COLUMNS
from padel_analytics_tpu_torch.apps import cli, evaluate, train_tracknet, train_yolo
from padel_analytics_tpu_torch.config import (
    BallTrackerConfig,
    CourtKeypointsTrackerConfig,
    PipelineConfig,
    PlayerKeypointsTrackerConfig,
    PlayersTrackerConfig,
)
from padel_analytics_tpu_torch.models.layers import ConvBN, lecun_normal_
from padel_analytics_tpu_torch.models.resnet import ResNet50Regressor, imagenet_normalize
from padel_analytics_tpu_torch.models.tracknet import InpaintNet, make_tracknet
from padel_analytics_tpu_torch.models.yolov8 import C2f, YOLOv8
from padel_analytics_tpu_torch.ops import conv3x3, heatmap, nms, resize
from padel_analytics_tpu_torch.ops.association import ByteTrack
from padel_analytics_tpu_torch.ops.association_scan import associate_chunk, init_state
from padel_analytics_tpu_torch.ops._fp32 import no_tf32
from padel_analytics_tpu_torch.ops.area import resize_area, resize_area_planes
from padel_analytics_tpu_torch.ops.color import i420_to_rgb, planes_to_i420, rgb_to_i420
from padel_analytics_tpu_torch.ops.polygon import PolygonZone
from padel_analytics_tpu_torch.trackers import (
    BallTracker,
    FusedPipeline,
    Keypoint,
    Keypoints,
    KeypointsTracker,
    PlayerKeypointsTracker,
    PlayerTracker,
    TrackingRunner,
)
from padel_analytics_tpu_torch.core.profiling import StageTimer
from padel_analytics_tpu_torch.parallel import (
    gather_params,
    init_distributed,
    make_mesh,
    shard_params_for_tp,
)
from padel_analytics_tpu_torch.parallel.tensor_parallel import tp_axis
from padel_analytics_tpu_torch.training import data as tdata
from padel_analytics_tpu_torch.training import init_train_state
from padel_analytics_tpu_torch.training import inpaintnet as tinp
from padel_analytics_tpu_torch.training import resnet_court as tcourt
from padel_analytics_tpu_torch.training import tracknet as ttn
from padel_analytics_tpu_torch.training import yolo as tyolo
from padel_analytics_tpu_torch.training.checkpoint import load_for_resume, save_tracknet, save_yolov8
from padel_analytics_tpu_torch.trackers import fused as fused_mod
from padel_analytics_tpu_torch.trackers.fused import PACK_THREADS
from padel_analytics_tpu_torch.utils.video import MemoryClip, VideoInfo

# The decisive fakes of the fused check (outputs far from every threshold, so
# only a plumbing fault such as a race between streams or a misaligned chunk
# can change a cache) are the port's tests' own; that module imports no JAX.
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from _torch_fused_cases import BrightTrackNet, CellDetector  # noqa: E402
import _torch_orbax_cases as orbax_cases  # noqa: E402
import _torch_tools_cases as tools_cases  # noqa: E402

# TrackNet at 288x512: (Cin, Cout, H, W) of its 17 stride-1 3x3 ConvBNs, in
# call order; 11 distinct shapes.
TRACKNET_CONVS = [
    (27, 64, 288, 512), (64, 64, 288, 512),
    (64, 128, 144, 256), (128, 128, 144, 256),
    (128, 256, 72, 128), (256, 256, 72, 128), (256, 256, 72, 128),
    (256, 512, 36, 64), (512, 512, 36, 64), (512, 512, 36, 64),
    (768, 256, 72, 128), (256, 256, 72, 128), (256, 256, 72, 128),
    (384, 128, 144, 256), (128, 128, 144, 256),
    (192, 64, 288, 512), (64, 64, 288, 512),
]
# YOLOv8m at a 640 input: (Cin, Cout, H, W) of its distinct stride-1 3x3
# ConvBN shapes (timed, not part of the TrackNet sum).
YOLO_CONVS = [
    (48, 48, 160, 160), (96, 96, 80, 80), (192, 192, 40, 40), (288, 288, 20, 20),
    (192, 64, 80, 80), (576, 192, 20, 20),
]
BATCH = 8
# The fused main path's chunk: det, pose and TrackNet each run at this batch,
# K2 on this many heatmaps. K1 launches of the fused path: detect's 52 and
# pose's 58 on each chunk holding clip frames, TrackNet's 17 on every chunk
# (the ball's tail included).
FUSED_CHUNK = 16
# H100 SXM peaks (NVIDIA's data sheet): dense bf16 tensor-core rate, HBM3 rate.
PEAK_BF16_FLOPS, PEAK_BYTES_S = 989e12, 3.35e12
# K1 bound: kernel and reference round (nearly) the same fp32 sum to bf16,
# so |kernel - ref| <= 2 bf16 ulp (2 * 2^-7 relative) + 1e-3 absolute for
# sums that cancel to ~0.
K1_RTOL, K1_ATOL = 2.0 ** -6, 1e-3
# Whole-model check: the bf16 K1 path against the fp32 plain path, sigmoid
# heatmaps after 18 convs in bf16.
MODEL_ATOL = 5e-2
# TrackNet with subpixel_up, He-normal weights (a live signal: the fp32
# heatmaps' std must pass SUBPIXEL_MIN_STD), bf16 on the card against the
# fp32 plain path of itself and of the dense TrackNet. Measured on the H100
# (80GB HBM3, 700 W): max abs err 0.0065 against both, std 0.326.
SUBPIXEL_ATOL, SUBPIXEL_MIN_STD = 2e-2, 0.1
# YOLOv8m on the card in bf16 against its fp32 plain path, random weights:
# sigmoid scores and keypoint confidences (abs), box and keypoint
# coordinates in input pixels (abs) after ~90 bf16 layers.
# Measured on the H100: <= 2e-4 and <= 0.0074 px, against a spread of the
# fp32 scores of ~0.016 (He-normal weights keep the signal weak but alive).
YOLO_SCORE_ATOL, YOLO_PIXEL_ATOL = 4e-3, 0.5
# Input sizes of the two YOLOv8m paths on 1080p frames (H, W), and of the
# fast configuration's pose at 640.
DETECT_HW, POSE_HW, POSE640_HW = (384, 640), (1280, 1280), (640, 640)
# TrackNet with subpixel_up: its up blocks' first convs leave K1 (the up part
# runs as phase convs at low resolution) and their skip parts enter it, 3x3
# convs Cin = Cout with an identity epilogue; the other 14 convs stay.
SUBPIXEL_SKIP_CONVS = [(256, 256, 72, 128), (128, 128, 144, 256), (64, 64, 288, 512)]
_UP_FIRSTS = {(768, 256, 72, 128), (384, 128, 144, 256), (192, 64, 288, 512)}
TRACKNET_SUBPIXEL_CALLS = (
    [((s, "relu")) for s in TRACKNET_CONVS if s not in _UP_FIRSTS]
    + [(s, "none") for s in SUBPIXEL_SKIP_CONVS])
# The derived ingest's wire: the long side of a 1080p frame cut to 960.
WIRE_LONG_SIDE = 960
# The court models' inputs: the YOLOv8m-pose (12 keypoints) squash and
# ResNet-50's. ResNet-50's stride-1 3x3 convs (its bottlenecks' conv2 but the
# first of layers 2-4): 3, 3, 5 and 2 of these.
COURT_YOLO_HW, RESNET_HW = (640, 640), (224, 224)
RESNET_CONVS = [(64, 64, 56, 56), (128, 128, 28, 28), (256, 256, 14, 14), (512, 512, 7, 7)]
# ResNet-50 bf16 on the card (K1 and cuDNN) against its fp32 plain path on
# the CPU, He-normal weights: logits' max abs error over their largest
# magnitude after 53 bf16 layers (bf16 keeps 8 bits: 2^-8 relative each).
RESNET_REL_ATOL = 5e-2
# InpaintNet (1-D convs, plain torch) on the card against the CPU: fp32
# without TF32, and bf16 as the ball tracker runs it; sigmoid outputs.
INPAINT_FP32_ATOL, INPAINT_BF16_ATOL = 1e-5, 2e-2
# The fused court against the per-tracker court, the ResNet at the same
# batch (keypoints in source pixels; cuDNN may pick other algorithms on
# other streams).
COURT_RESNET_PX = 1e-2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_time_ms(fn, reps: int = 10) -> float:
    """Mean device time per call over `reps` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps: int = 20) -> float:
    """Mean device time per call of `fn`: `reps` calls captured in one CUDA
    graph after a warm-up, the graph replayed between two events. Replaying
    takes the host's launch cost out of the time of small kernels."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def phase_report() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} triton {triton_version} "
          f"nvcc: {nvcc}")
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    names = ("conv3x3_bn_act", "heatmap_cc")
    _build.build(*names)
    for name in names:
        _build.library(name)
        log = _build.build_log[name]
        print(f"build {name}: {log['seconds']:.2f} s")
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")


def _library_bf16(x, w_oihw, scale, bias, act):
    """One PyTorch call per op for the same function, natively in bf16: cuDNN
    conv on the channels-last view, affine, activation. Timed, never used by
    the port."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1)
    y = y * scale[:, None, None] + bias[:, None, None]
    y = conv3x3._act(y, act)
    return y.permute(0, 2, 3, 1)


def k1_bound_ms(cin, cout, h, w, batch=BATCH) -> tuple[float, float]:
    """(operations ms, bytes ms) of one conv on the card: 2 * M * N * K FLOPs
    over the bf16 tensor-core rate; x, w, scale, bias read once and out
    written once (bf16, fp32 affine) over the memory rate. The bound is the
    larger of the two."""
    m = batch * h * w
    nbytes = 2 * m * cin + 2 * 9 * cin * cout + 8 * cout + 2 * m * cout
    flops = 2 * m * cout * 9 * cin
    return flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3


def _k1_shape(dev, g, cin, cout, h, w, act, batch) -> dict:
    x = torch.randn((batch, h, w, cin), generator=g).to(dev, torch.bfloat16)
    wt = (torch.randn((3, 3, cin, cout), generator=g) / math.sqrt(9 * cin)).to(dev)
    scale = (torch.rand(cout, generator=g) + 0.5).to(dev)
    bias = (torch.randn(cout, generator=g) * 0.1).to(dev)
    wk = conv3x3.pack_weight(wt)
    got = conv3x3.conv3x3_bn_act_packed(x, wk, scale, bias, act)
    ref = conv3x3.conv3x3_bn_act_plain(x.float(), wt.to(torch.bfloat16).float(), scale, bias, act)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs()
    ok = bool(torch.all(err <= K1_RTOL * ref.abs() + K1_ATOL))
    max_err = float(err.max())
    del ref, err, got
    check(ok, f"K1 {cin}->{cout} @{h}x{w} {act} beyond its bf16 bound (max err {max_err})")
    w_oihw = wt.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    kernel_ms = graph_time_ms(lambda: conv3x3.conv3x3_bn_act_packed(x, wk, scale, bias, act))
    library_ms = graph_time_ms(lambda: _library_bf16(x, w_oihw, scale, bias, act))
    plain_ms = graph_time_ms(lambda: conv3x3.conv3x3_bn_act_plain(x, wt, scale, bias, act), reps=3)
    ops_ms, bytes_ms = k1_bound_ms(cin, cout, h, w, batch)
    bound_ms, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"))
    tflop = 2 * batch * h * w * cout * 9 * cin / 1e9
    print(f"K1 {cin:>3}->{cout:<3} @{h}x{w} B={batch} {act}: kernel {kernel_ms:.3f} ms "
          f"({tflop / kernel_ms:.1f} TFLOP/s, {100 * bound_ms / kernel_ms:.1f}% of its "
          f"{bound_ms:.4f} ms {bound_by} bound), cuDNN bf16 {library_ms:.3f} ms "
          f"({tflop / library_ms:.1f} TFLOP/s), plain fp32 {plain_ms:.3f} ms, "
          f"max abs err {max_err:.3g}")
    return {"ms": kernel_ms, "library_ms": library_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "ops_ms": ops_ms, "max_err": max_err}


def _trace(model, h: int, w: int, select, record, cin: int = 3) -> list:
    """record(module, input) of every module that `select` picks, in call
    order, over one forward of `model` on a (1, h, w, cin) input: a copy of
    the model runs on the meta device (shapes only, nothing computed)."""
    model = copy.deepcopy(model).to("meta").eval()
    out = []
    for m in model.modules():
        if select(m):
            m.register_forward_pre_hook(lambda mod, args: out.append(record(mod, args[0])))
    with torch.no_grad():
        model(torch.empty((1, h, w, cin), device="meta"))
    return out


def k1_call_shapes(model, h: int, w: int, cin: int = 3) -> list[tuple[int, int, int, int]]:
    """(Cin, Cout, H, W) of every K1 launch of one forward, in call order."""
    return _trace(model, h, w, lambda m: isinstance(m, ConvBN) and m.fused,
                  lambda m, x: (x.shape[-1], m.conv.out_channels, *x.shape[1:3]), cin)


def c2f_split_shapes(model, h: int, w: int) -> list[tuple[int, int, int]]:
    """(H, W, 2c) of the tensor each C2f splits into two c-channel halves;
    the second half reaches K1 as a non-contiguous view, which the wrapper
    copies."""
    return _trace(model, h, w, lambda m: isinstance(m, C2f),
                  lambda m, x: (*x.shape[1:3], 2 * m.c))


_SUM_KEYS = ("ms", "library_ms", "plain_ms", "bound_ms", "ops_ms")


def _k1_sum(name: str, calls: list[dict], batch: int) -> dict:
    """K1 and its yardsticks summed over `calls`, one timing per launch in
    call order."""
    tot = {k: sum(c[k] for c in calls) for k in _SUM_KEYS}
    # The sum is bound by operations where they take most of the bound.
    tot["bound_by"] = "operations" if tot.pop("ops_ms") >= tot["bound_ms"] / 2 else "bytes"
    print(f"K1 over {name}'s {len(calls)} convs at B={batch}: kernel {tot['ms']:.3f} ms "
          f"({100 * tot['bound_ms'] / tot['ms']:.1f}% of the {tot['bound_ms']:.3f} ms "
          f"{tot['bound_by']} bound), cuDNN bf16 {tot['library_ms']:.3f} ms, plain fp32 "
          f"{tot['plain_ms']:.3f} ms")
    return tot


def _split_copies(dev, name: str, splits) -> None:
    """Device time of the copies K1's wrapper makes of the C2f halves in one
    batch-8 forward (CUDA-graph replay), beside their byte bound."""
    ms = nbytes = 0.0
    for h, w, c2 in splits:
        y = torch.randn((BATCH, h, w, c2), device=dev, dtype=torch.bfloat16)
        ms += graph_time_ms(lambda: y[..., c2 // 2:].contiguous())
        nbytes += 2 * y.numel()  # half read, half written, 2 bytes each
    print(f"C2f split copies of YOLOv8m {name} ({len(splits)} a forward) at B={BATCH}: "
          f"{ms:.3f} ms, bound {nbytes / PEAK_BYTES_S * 1e3:.3f} ms (bytes)")


def _k1_calls(dev, timed: dict, convs, batch) -> list[dict]:
    """Each (shape, act) of `convs` checked and timed once at `batch`
    (`timed` holds what earlier calls measured); the timings in call order."""
    g = torch.Generator(device="cpu").manual_seed(len(timed) + 1)
    for s, act in convs:
        if (s, act, batch) not in timed:
            timed[s, act, batch] = _k1_shape(dev, g, *s, act, batch)
    return [timed[s, act, batch] for s, act in convs]


def phase_k1(dev, timed: dict) -> dict:
    """K1 at every call shape of the three models, at the per-tracker
    paths' batch of 8 and at the fused main path's chunk of 16 (TrackNet
    there runs one window a chunk frame). The kernels line carries one fused
    chunk's K1 work: its 127 launches summed at B=16. `timed` collects
    every (shape, act, batch) checked and timed."""
    models = {"detect": (YOLOv8("m", 1), DETECT_HW), "pose": (YOLOv8("m", 1, 13), POSE_HW)}
    detect, pose = (k1_call_shapes(m, *hw) for m, hw in models.values())
    check(len(detect) == 52 and len(pose) == 58, f"K1 call sites {len(detect)}, {len(pose)}")

    def calls(convs, act, batch) -> list[dict]:
        return _k1_calls(dev, timed, [(s, act) for s in convs], batch)

    paths = {"tracknet_288x512": ("TrackNet", TRACKNET_CONVS, "relu"),
             "yolov8m_detect_384x640": ("YOLOv8m detect @384x640", detect, "silu"),
             "yolov8m_pose_1280x1280": ("YOLOv8m-pose @1280x1280", pose, "silu")}
    sums, chunk_calls = {}, []
    for batch in (BATCH, FUSED_CHUNK):
        sums[f"b{batch}"] = {}
        for key, (label, convs, act) in paths.items():
            cs = calls(convs, act, batch)
            sums[f"b{batch}"][key] = _k1_sum(label, cs, batch)
            if batch == FUSED_CHUNK:
                chunk_calls += cs
    yolo640 = calls(YOLO_CONVS, "silu", BATCH)
    print(f"K1 over YOLOv8m's 6 shapes at 640x640 (once each) at B={BATCH}: kernel "
          f"{sum(c['ms'] for c in yolo640):.3f} ms, cuDNN bf16 "
          f"{sum(c['library_ms'] for c in yolo640):.3f} ms")
    chunk = _k1_sum(f"one fused chunk of {FUSED_CHUNK} (TrackNet + detect + pose)",
                    chunk_calls, FUSED_CHUNK)
    for name, (model, hw) in models.items():
        _split_copies(dev, name, c2f_split_shapes(model, *hw))
    return {"name": "conv3x3_bn_act", "route": "cuda",
            "source": "padel_analytics_tpu_torch/csrc/conv3x3_bn_act.cu",
            "replaces": "padel_analytics_tpu/ops/pallas_conv.py:211, "
                        "padel_analytics_tpu/ops/pallas_conv.py:322",
            "max_abs_err": max(v["max_err"] for v in timed.values()),
            "timed_per": f"the {len(chunk_calls)} K1 launches of one fused chunk, B={FUSED_CHUNK}",
            **chunk, "sums": sums}


def _heatmaps(rng, n, h, w) -> np.ndarray:
    ys, xs = np.mgrid[0:h, 0:w]
    hms = []
    for _ in range(n - 2):
        hm = np.zeros((h, w))
        for _ in range(rng.integers(1, 4)):
            cy, cx, s = rng.integers(5, h - 5), rng.integers(5, w - 5), rng.uniform(1.5, 5.0)
            hm += np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
        hms.append(hm)
    hms.append(np.zeros((h, w)))  # empty
    tie = np.zeros((h, w))
    tie[40:45, 100:105] = 1.0
    tie[200:205, 300:305] = 1.0  # equal areas
    hms.append(tie)
    return np.stack(hms).astype(np.float32)


def _bars(rng, n, h, w) -> np.ndarray:
    """Vertical bars through every band (far longer than num_iters), one per
    map at a random column, beside a small blob."""
    hms = np.zeros((n, h, w), np.float32)
    for i in range(n):
        c = rng.integers(2, w - 8)
        hms[i, 1:h - 1, c:c + 3] = 1.0
        hms[i, 100:104, (c + 100) % (w - 4):(c + 100) % (w - 4) + 4] = 1.0
    return hms


def _k2_case(name, hms, plans) -> dict:
    """K2 on `hms` at each cluster size of `plans`: bit-equal to the plain
    version, then timed as device time (CUDA-graph replay) and per call
    (a launch loop, the host's cost included)."""
    want = heatmap.decode_heatmaps_plain(hms)
    ms, loop_ms = {}, {}
    for c, plan in plans.items():
        got = heatmap._decode_cuda(hms, 0.5, 32, plan)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            check(torch.equal(a, b), f"K2 {name} at cluster {c} not bit-equal: {a} vs {b}")
        ms[c] = graph_time_ms(lambda: heatmap._decode_cuda(hms, 0.5, 32, plan))
        loop_ms[c] = cuda_time_ms(lambda: heatmap._decode_cuda(hms, 0.5, 32, plan), reps=20)
    mask = float((hms > 0.5).float().mean())
    print(f"K2 {name} B={hms.shape[0]} {hms.shape[1]}x{hms.shape[2]} (mask {100 * mask:.1f}%): "
          + ", ".join(f"cluster {c} {ms[c]:.4f} ms ({loop_ms[c]:.4f} a call in a launch loop)"
                      for c in plans) + "; bit-equal")
    return ms


def phase_k2(dev) -> dict:
    h, w = 288, 512
    lib = _build.library("heatmap_cc")
    plans = {c: heatmap.cc_plan(h, w, c) for c in heatmap.CLUSTER_SIZES}
    chosen = heatmap.cc_plan(h, w).cluster
    for c, plan in plans.items():
        n = ctypes.c_int(-1)
        _build.check(lib.heatmap_cc_max_active_clusters(c, plan.smem_bytes, ctypes.byref(n)),
                     "heatmap_cc_max_active_clusters")
        print(f"K2 cluster {c}: {plan.rows_per_block} rows a block, {plan.threads} threads, "
              f"{plan.smem_bytes} B dynamic shared memory, {sum(plan.bits[:2]) * 2 + plan.bits[2]} "
              f"bits a pixel; cudaOccupancyMaxActiveClusters {n.value}")
    print(f"K2 plan's cluster size at {h}x{w}: {chosen}")

    rng = np.random.default_rng(2)
    hms = torch.from_numpy(_heatmaps(rng, BATCH, h, w)).to(dev)
    got = heatmap.decode_heatmaps(hms)
    torch.cuda.synchronize()
    check(int(got[2][-2]) == 0, "K2 empty heatmap must be invisible")
    blobs = _k2_case("blobs (empty map and tie included)", hms, plans)
    plain_ms = cuda_time_ms(lambda: heatmap.decode_heatmaps_plain(hms), reps=3)
    dense = {d: _k2_case(f"uniform mask {d:.0%}",
                         torch.from_numpy((rng.random((BATCH, h, w)) < d).astype(np.float32)).to(dev),
                         plans)
             for d in (0.1, 0.5, 1.0)}
    _k2_case("band-crossing bars", torch.from_numpy(_bars(rng, BATCH, h, w)).to(dev), plans)

    def bound_ms(batch: int) -> float:
        # The fp32 heatmaps read once and three int32 results written once;
        # its few integer operations per pixel are far below the byte time.
        return (batch * h * w * 4 + 3 * batch * 4) / PEAK_BYTES_S * 1e3

    print(f"K2 B={BATCH} {h}x{w} at the plan's cluster {chosen}: blobs {blobs[chosen]:.4f} ms, "
          f"dense 50% {dense[0.5][chosen]:.4f} ms; plain (blobs) {plain_ms:.3f} ms")
    per_tracker = {"ms": blobs[chosen], "dense_ms": dense[0.5][chosen], "plain_ms": plain_ms,
                   "bound_ms": bound_ms(BATCH)}
    # The fused main path decodes a chunk's FUSED_CHUNK heatmaps in one launch.
    b = FUSED_CHUNK
    hms = torch.from_numpy(_heatmaps(rng, b, h, w)).to(dev)
    blobs = _k2_case("blobs at the fused chunk (empty map and tie included)", hms, plans)
    plain_ms = cuda_time_ms(lambda: heatmap.decode_heatmaps_plain(hms), reps=3)
    dense = _k2_case("uniform mask 50% at the fused chunk",
                     torch.from_numpy((rng.random((b, h, w)) < 0.5).astype(np.float32)).to(dev),
                     plans)
    _k2_case("band-crossing bars at the fused chunk",
             torch.from_numpy(_bars(rng, b, h, w)).to(dev), plans)
    print(f"K2 B={b} {h}x{w} at the plan's cluster {chosen}: blobs {blobs[chosen]:.4f} ms, "
          f"dense 50% {dense[chosen]:.4f} ms; plain (blobs) {plain_ms:.3f} ms")
    return {"name": "heatmap_cc", "route": "cuda",
            "source": "padel_analytics_tpu_torch/csrc/heatmap_cc.cu",
            "replaces": "padel_analytics_tpu/ops/pallas_cc.py:108",
            "max_abs_err": 0, "timed_per": f"one fused chunk's decode, B={b}",
            "ms": blobs[chosen], "dense_ms": dense[chosen], "cluster": chosen,
            "plain_ms": plain_ms, "bound_ms": bound_ms(b), "bound_by": "bytes",
            "library_ms": None, "b8": per_tracker}


def phase_model(dev) -> None:
    """TrackNet (dense and subpixel), YOLOv8m detect and YOLOv8m-pose on
    the card (bf16, K1) against their fp32 plain path on the CPU."""
    model, in_dim = make_tracknet(8, "concat")
    lecun_normal_(model, torch.Generator().manual_seed(4))
    model.eval()
    x = torch.rand((2, 64, 128, in_dim), generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        ref = model(x)
    model.to(dev)
    with torch.inference_mode():
        got = model(x.to(dev, torch.bfloat16)).cpu()
    check(got.shape == ref.shape == (2, 64, 128, 8), "TrackNet output shape")
    check(bool(torch.isfinite(got).all()), "TrackNet output not finite")
    err = float((got - ref).abs().max())
    check(err <= MODEL_ATOL, f"TrackNet bf16 on the card vs fp32 plain: max err {err}")
    print(f"TrackNet 2x64x128 bf16 (K1) vs fp32 plain: max abs err {err:.4f} "
          f"(bound {MODEL_ATOL})")
    _subpixel_model_check(dev)
    for nk in (0, 13, 12):
        _yolo_model_check(dev, nk)
    _resnet_model_check(dev)
    _inpaintnet_check(dev)


def he_normal_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """N(0, 2/fan_in) conv weights, identity BatchNorm: under the package's
    LeCun init the signal dies out with depth."""
    lecun_normal_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(math.sqrt(2.0))
    return model.eval()


def _subpixel_model_check(dev) -> None:
    """TrackNet with subpixel_up in bf16 on the card (K1 on its 14 ConvBNs
    and its 3 skip convs, the phase layout, the fp32 epilogue) against the
    fp32 plain path of itself and of the dense TrackNet on the CPU."""
    model, in_dim = make_tracknet(8, "concat", subpixel_up=True)
    he_normal_(model, 4)
    dense, _ = make_tracknet(8, "concat")
    dense.load_state_dict(model.state_dict())
    dense.eval()
    x = torch.rand((2, 64, 128, in_dim), generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        ref, ref_dense = model(x), dense(x)
    spread = float(ref.std())
    check(spread > SUBPIXEL_MIN_STD, f"TrackNet subpixel fp32: heatmap std {spread}, a dead signal")
    model.to(dev)
    conv3x3.reset_launches()
    with torch.inference_mode():
        got = model(x.to(dev, torch.bfloat16)).cpu()
    check(conv3x3.launches == 17, f"TrackNet subpixel: {conv3x3.launches} K1 launches")
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          "TrackNet subpixel: output shape or finiteness")
    err, err_dense = float((got - ref).abs().max()), float((got - ref_dense).abs().max())
    check(max(err, err_dense) <= SUBPIXEL_ATOL,
          f"TrackNet subpixel bf16 on the card vs fp32 plain: max err {err}, vs dense {err_dense}")
    print(f"TrackNet subpixel 2x64x128 bf16 (K1, He-normal) vs fp32 plain: max abs err "
          f"{err:.4f}, vs the dense TrackNet {err_dense:.4f} (bound {SUBPIXEL_ATOL}; "
          f"heatmap std {spread:.3f})")


def _yolo_model_check(dev, nk: int) -> None:
    name = {0: "YOLOv8m detect", 13: "YOLOv8m-pose", 12: "court YOLOv8m-pose (12 keypoints)"}[nk]
    model = he_normal_(YOLOv8("m", 1, nk), 7 + nk)
    x = torch.rand((2, 128, 160, 3), generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        ref = model(x)
    model.to(dev)
    conv3x3.reset_launches()
    with torch.inference_mode():
        got = {k: v.cpu() for k, v in model(x.to(dev, torch.bfloat16)).items()}
    check(conv3x3.launches == (58 if nk else 52), f"{name}: {conv3x3.launches} K1 launches")
    errs = {}
    for k, want in ref.items():
        check(got[k].shape == want.shape and bool(torch.isfinite(got[k]).all()),
              f"{name} {k}: shape or finiteness")
        d = (got[k] - want).abs()
        if k == "kpts":
            errs["kpts_xy"], errs["kpts_conf"] = float(d[..., :2].max()), float(d[..., 2].max())
        else:
            errs[k] = float(d.max())
    bounds = {"boxes": YOLO_PIXEL_ATOL, "scores": YOLO_SCORE_ATOL,
              "kpts_xy": YOLO_PIXEL_ATOL, "kpts_conf": YOLO_SCORE_ATOL}
    for k, e in errs.items():
        check(e <= bounds[k], f"{name} bf16 on the card vs fp32 plain: {k} max err {e}")
    print(f"{name} 2x128x160 bf16 (K1) vs fp32 plain: max abs err "
          + ", ".join(f"{k} {e:.4f} (bound {bounds[k]})" for k, e in errs.items())
          + f"; score range {float(ref['scores'].min()):.3f}-{float(ref['scores'].max()):.3f}")


def _resnet_model_check(dev) -> None:
    """ResNet-50 on the card (bf16: K1 on its 13 stride-1 conv2s, cuDNN
    elsewhere, BN folded in fp32) against its fp32 plain path on the CPU, at
    224x224 with He-normal weights."""
    model = he_normal_(ResNet50Regressor(), 17)
    x = imagenet_normalize(torch.rand((2, *RESNET_HW, 3), generator=torch.Generator().manual_seed(18)))
    with torch.inference_mode():
        ref = model(x)
    model.to(dev)
    conv3x3.reset_launches()
    with torch.inference_mode():
        got = model(x.to(dev, torch.bfloat16)).cpu()
    check(conv3x3.launches == 13, f"ResNet-50: {conv3x3.launches} K1 launches")
    check(got.shape == ref.shape == (2, 24) and bool(torch.isfinite(got).all()),
          "ResNet-50: output shape or finiteness")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    check(err <= RESNET_REL_ATOL * scale,
          f"ResNet-50 bf16 on the card vs fp32 plain: max err {err} of logits up to {scale}")
    print(f"ResNet-50 2x224x224 bf16 (K1 + cuDNN, He-normal) vs fp32 plain: max abs err {err:.4g} "
          f"on logits up to {scale:.4g} ({err / scale:.4f} of it; bound {RESNET_REL_ATOL}); "
          f"logit std {float(ref.std()):.4g}")


def _inpaintnet_check(dev) -> None:
    """InpaintNet (plain torch conv1d) on the card against the CPU on 16-frame
    windows: in fp32 without TF32, and in bf16 as the ball tracker runs it."""
    net = lecun_normal_(InpaintNet(), torch.Generator().manual_seed(19)).eval()
    g = torch.Generator().manual_seed(20)
    coords, mask = torch.rand((64, 16, 2), generator=g), (torch.rand((64, 16, 1), generator=g) > 0.7).float()
    with torch.inference_mode():
        ref = net(coords, mask)
    net.to(dev)
    with torch.inference_mode(), no_tf32():
        got32 = net(coords.to(dev), mask.to(dev)).cpu()
        got16 = net(coords.to(dev), mask.to(dev), torch.bfloat16).cpu()
    e32, e16 = float((got32 - ref).abs().max()), float((got16 - ref).abs().max())
    check(e32 <= INPAINT_FP32_ATOL and e16 <= INPAINT_BF16_ATOL,
          f"InpaintNet on the card vs the CPU: max err fp32 {e32}, bf16 {e16}")
    print(f"InpaintNet 64x16 on the card vs the CPU: max abs err fp32 {e32:.3g} (bound "
          f"{INPAINT_FP32_ATOL}), bf16 {e16:.4f} (bound {INPAINT_BF16_ATOL}); output std "
          f"{float(ref.std()):.4f}")


def synthetic_rally(n: int, seed: int) -> list[np.ndarray]:
    """A 1920x1080 RGB clip: a blue court with white lines, sensor noise and a
    bright ball on a parabolic path (one every 64 frames)."""
    rng = np.random.default_rng(seed)
    h, w = 1080, 1920
    court = np.empty((h, w, 3), np.uint8)
    court[:] = (40, 90, 160)
    court[:, 300:310] = court[:, 1610:1620] = 255
    court[150:160, 300:1620] = court[900:910, 300:1620] = court[525:530, 300:1620] = 255
    frames = []
    ys, xs = np.mgrid[-8:9, -8:9]
    disk = ys**2 + xs**2 <= 64
    for i in range(n):
        f = court + rng.integers(0, 12, (h, w, 3), dtype=np.uint8)
        j = i % 64  # a new rally every 64 frames keeps the ball in the frame
        cx = 200 + 24 * j
        cy = int(900 - 30 * j + 0.45 * j * j)
        patch = f[cy - 8: cy + 9, cx - 8: cx + 9]
        patch[disk] = (235, 240, 80)
        frames.append(f)
    return frames


def phase_slice() -> dict:
    n = 64
    frames = synthetic_rally(n, seed=6)
    with tempfile.TemporaryDirectory() as tmp:
        save = Path(tmp) / "ball.json"
        # No device argument: the entry point's default is the card.
        tracker = BallTracker(None, config=BallTrackerConfig(), save_path=save,
                              compute_dtype=torch.bfloat16, seed=0)
        tracker.video_info_post_init(VideoInfo(width=1920, height=1080, fps=30.0, total_frames=n))

        conv3x3.reset_launches()
        heatmap.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tracker.predict_and_update(iter(frames), total_frames=n)
        tracker.save_predictions()
        first_s = time.perf_counter() - t0
        launches = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(save.exists() and len(json.loads(save.read_text())) == n, "saved JSON cache")

    balls = list(tracker.results)
    chunks = -(-(n + 7) // 8)
    check(len(balls) == n and [b.frame for b in balls] == list(range(n)), "one Ball per frame")
    check(all(b.visibility in (0, 1) and all(math.isfinite(v) for v in b.xy) for b in balls),
          "ball fields")
    check(all(0 <= b.xy[0] < 1920 and 0 <= b.xy[1] < 1080 for b in balls), "ball in frame")
    check(launches["conv3x3_bn_act"] == 17 * chunks,
          f"K1 launches {launches['conv3x3_bn_act']} != 17 x {chunks} chunks")
    check(launches["heatmap_cc"] >= chunks, f"K2 launches {launches['heatmap_cc']} < {chunks}")

    # Second pass on the same tracker: steady-state speed and determinism.
    first = [b.serialize() for b in balls]
    tracker.restart()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracker.predict_and_update(iter(frames), total_frames=n)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    check([b.serialize() for b in tracker.results] == first, "second pass differs")
    print(f"slice: {n} frames 1920x1080, {chunks} chunks, visible {sum(b.visibility for b in balls)}; "
          f"first pass {n / first_s:.1f} frames/s, second pass {n / second_s:.1f} frames/s; "
          f"peak device memory {peak_gib:.2f} GiB; launches {launches}")
    profile_pass(tracker, frames)
    return launches


def profile_pass(tracker, frames, kernels=(("K1", "conv3x3_bn_act"), ("K2", "heatmap_cc")),
                 label="slice", top_n: int = 0) -> None:
    """A third pass under torch.profiler: device busy time (kernels and
    copies) against the pass's wall time, and each kernel's device time.
    Measured, not checked: the profiler's own cost slows the host side of
    this pass."""
    tracker.restart()
    profile_run(lambda: tracker.predict_and_update(iter(frames), total_frames=len(frames)),
                label, kernels, top_n)


def _union_ms(intervals) -> tuple[float, list[tuple[float, float]]]:
    """(ms covered by the union of (start, end) us intervals, the gaps
    between the merged intervals as (start us, length ms))."""
    busy, gaps, cur = 0.0, [], None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], (a - cur[1]) / 1e3))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e3, gaps


def profile_run(run, label: str, kernels, top_n: int = 0, chunks: int = 0,
                gaps: int = 0) -> dict:
    """`run()` under torch.profiler: device busy share (the union of every
    kernel and copy interval over all streams, against the run's wall
    time), each kernel's device time and launches (a chunk, where `chunks`
    is given), the `top_n` device ops, the `gaps` longest device idle
    gaps, and the host's synchronising CUDA calls. Measured, not checked:
    the profiler's own cost slows the host side of the run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print(f"{label} profile: device time not measured (the profiler saw no device activity)")
        return {}
    busy_ms, idle = _union_ms((e.time_range.start, e.time_range.end) for e in dev)
    summed_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    parts, kernel_ms, kernel_n = [], {}, {}
    for name, key in kernels:
        ev = [e for e in dev if key in e.name]
        if not ev:
            parts.append(f"{name} not measured (no launch seen by the profiler)")
            continue
        kernel_ms[name] = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        kernel_n[name] = len(ev)
        per = (f", {len(ev) / chunks:.1f} a chunk ({kernel_ms[name] / chunks:.3f} ms a chunk)"
               if chunks else "")
        parts.append(f"{name} {kernel_ms[name]:.3f} ms in {len(ev)} launches{per}")
    print(f"{label} profile: pass {wall_ms:.1f} ms under the profiler, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%; summed over streams "
          f"{summed_ms:.1f} ms); " + "; ".join(parts))
    by_name: dict[str, list[float]] = {}
    for e in dev:
        by_name.setdefault(e.name[:70], []).append(e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top_n]
    for name, t in top:
        print(f"  {label} device: {sum(t):8.3f} ms in {len(t):4d}  {name}")
    if gaps:
        t_first = min(e.time_range.start for e in dev)
        longest = sorted(idle, key=lambda g: -g[1])[:gaps]
        print(f"  {label} longest device idle gaps: " + ", ".join(
            f"{ms:.2f} ms at +{(at - t_first) / 1e3:.1f} ms" for at, ms in longest)
            + f" ({len(idle)} gaps, {sum(g[1] for g in idle):.1f} ms in all)")
        syncs = {}
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CPU and e.name in (
                    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                    "cudaMemcpy"):
                syncs[e.name] = syncs.get(e.name, 0) + 1
        print(f"  {label} host synchronising CUDA calls: {syncs or 'none recorded'}")
    graph_launches = sum(e.device_type == torch.autograd.DeviceType.CPU
                         and e.name == "cudaGraphLaunch" for e in events)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernel_ms": kernel_ms,
            "kernel_n": kernel_n, "graph_launches": graph_launches}


# The players' polygon gate: the synthetic rally's court from its far line
# (y = 150) down past the bottom of the frame, as a camera behind the near
# baseline sees it.
COURT_POLYGON = np.array([[200, 1100], [1720, 1100], [1620, 150], [300, 150]], float)


def synthetic_players(n: int, seed: int) -> list[np.ndarray]:
    """synthetic_rally with four player-sized figures (70x180 body, head
    above) walking across the court."""
    frames = synthetic_rally(n, seed)
    figures = [((400, 300), 6, (200, 60, 60)), ((1300, 330), -6, (60, 200, 60)),
               ((500, 650), 5, (230, 230, 230)), ((1250, 680), -5, (30, 30, 30))]
    for i, f in enumerate(frames):
        for (x0, y0), vx, colour in figures:
            x, y = x0 + vx * i, y0 + (i % 16)
            f[y: y + 180, x: x + 70] = colour
            f[y - 34: y, x + 18: x + 52] = (220, 180, 150)
    return frames


def _logit(p: float) -> float:
    p = min(max(p, 1e-7), 1.0 - 1e-7)
    return math.log(p / (1.0 - p))


def calibrate_cls_head(tracker, frames, target: int = 16) -> dict:
    """Make a random-weight cls head gate like a trained one. Untrained
    class logits sit near 0 (sigmoid ~0.5, on the players' conf .5), so
    every anchor passes the threshold or none does. Two shape-preserving
    changes to the cls projections, from probes of the gating scores on
    `frames` through the tracker's own preprocessing: scale the kernel until
    the logits of the 1st and the (3 target)-th largest score lie >= 0.5
    apart, then shift the bias by logit(conf) - logit(target-th largest
    score), for about `target` candidates a frame."""
    x = torch.from_numpy(np.stack(frames)).to(tracker.device)
    projs = [getattr(tracker.engine.model, f"cls_{i}").proj for i in range(3)]
    base = [(p.weight.detach().clone(), p.bias.detach().clone()) for p in projs]

    def set_head(scale: float, shift: float) -> None:
        with torch.no_grad():
            for p, (w, b) in zip(projs, base):
                p.weight.copy_(w * scale)
                p.bias.copy_(b + shift)

    def gate() -> torch.Tensor:
        with torch.inference_mode():
            return tracker.model_outputs(x)[1].float()

    scale, shift, mean, max_c = 1.0, 0.0, None, None
    for _ in range(6):
        set_head(scale, 0.0)
        top = gate().sort(dim=-1, descending=True).values
        q = {r: float(top[:, r - 1].mean()) for r in (1, target, 3 * target)}
        if not 1e-6 < q[target] < 1.0 - 1e-6:
            scale /= 8.0  # sigmoid saturated
            continue
        spread = _logit(q[1]) - _logit(q[3 * target])
        if spread < 0.5:
            scale *= min(max(4.0 / max(spread, 1e-4), 2.0), 256.0)
            continue
        shift = _logit(tracker.CONF) - _logit(q[target])
        set_head(scale, shift)
        n = nms.candidate_count(gate(), tracker.CONF)
        mean, max_c = float(n.float().mean()), int(n.max())
        if target / 2 <= mean <= 2 * target:
            break
        scale *= 4.0  # too steep between the ranks
    check(mean is not None and 0 < mean <= tracker.nms_top_k,
          f"{tracker}: calibration gave {mean} candidates a frame")
    return {"kernel_scale": scale, "bias_shift": round(shift, 4),
            "mean_candidates": mean, "max_candidates": max_c}


def host_split(tracker, frames, reps: int = 5) -> None:
    """Wall ms of the parts of one chunk's step, each run alone and ended by
    a synchronize (medians of `reps`): the host np.stack, the upload, the
    device forward (preprocess + model), batched_nms, and the whole
    predict_sample (ByteTrack or the keypoint objects included)."""
    def wall(fn) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    sample = np.stack(frames)
    x = torch.from_numpy(sample).to(tracker.device)
    with torch.inference_mode():
        out, gate = tracker.model_outputs(x)
        parts = {
            "np.stack": wall(lambda: np.stack(frames)),
            "upload": wall(lambda: torch.from_numpy(sample).to(tracker.device)),
            "preprocess + model": wall(lambda: tracker.model_outputs(x)),
            "batched_nms": wall(lambda: nms.batched_nms(
                out["boxes"], gate, conf_thres=tracker.CONF, iou_thres=tracker.IOU,
                max_det=tracker.max_detections, top_k=tracker.nms_top_k)),
        }
    tracker.restart()
    parts["predict_sample"] = wall(lambda: tracker.predict_sample(sample))
    print(f"{tracker} one chunk of {len(frames)}, wall ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))


def run_tracker_slice(tracker, frames, save: Path, convs_per_chunk: int, check_results) -> dict:
    """One tracker over `frames` as TrackingRunner.run drives it, with its
    cls head calibrated first; K1's launches counted over the first pass; a
    second pass must equal the first; a third runs under the profiler."""
    n = len(frames)
    tracker.video_info_post_init(VideoInfo(width=1920, height=1080, fps=30.0, total_frames=n))
    calib = calibrate_cls_head(tracker, frames[: tracker.batch_size])

    conv3x3.reset_launches()
    heatmap.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tracker.predict_and_update(iter(frames), total_frames=n)
    tracker.save_predictions()
    first_s = time.perf_counter() - t0
    launches = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(save.exists() and len(json.loads(save.read_text())) == n, f"{tracker}: saved JSON cache")

    results = list(tracker.results)
    chunks = -(-n // tracker.batch_size)
    check(len(results) == n, f"{tracker}: {len(results)} results for {n} frames")
    check(launches["conv3x3_bn_act"] == convs_per_chunk * chunks,
          f"{tracker}: K1 launches {launches['conv3x3_bn_act']} != {convs_per_chunk} x {chunks} chunks")
    found = check_results(results)
    saturation = tracker.nms_saturation.summary()

    first = [r.serialize() for r in results]
    tracker.restart()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracker.predict_and_update(iter(frames), total_frames=n)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    check([r.serialize() for r in tracker.results] == first, f"{tracker}: second pass differs")
    print(f"{tracker}: {n} frames 1920x1080, {chunks} chunks, {found}; first pass "
          f"{n / first_s:.1f} frames/s, second pass {n / second_s:.1f} frames/s; peak device "
          f"memory {peak_gib:.2f} GiB; launches {launches}; calibration {calib}; NMS "
          f"saturation {saturation}")
    host_split(tracker, frames[: tracker.batch_size])
    profile_pass(tracker, frames, (("K1", "conv3x3_bn_act"),), label=str(tracker), top_n=8)
    return launches


def _check_players(results) -> str:
    players = [pl for p in results for pl in p]
    check(all(type(p).__name__ == "Players" for p in results), "one Players per frame")
    check(len(players) > 0, "no player tracked")
    for pl in players:
        x1, y1, x2, y2 = pl.xyxy
        check(0 <= x1 <= x2 <= 1920 and 0 <= y1 <= y2 <= 1080, f"box {pl.xyxy} outside the frame")
        check(isinstance(pl.id, int) and pl.id >= 1, f"player id {pl.id!r}")
        check(pl.confidence > 0.5, f"confidence {pl.confidence} at or below conf")
    return f"{len(players)} player boxes, {len({pl.id for pl in players})} ids"


def _check_pose(results) -> str:
    people = [pk for p in results for pk in p]
    check(all(type(p).__name__ == "PlayersKeypoints" for p in results),
          "one PlayersKeypoints per frame")
    check(len(people) > 0, "no pose detected")
    for pk in people:
        check(len(pk) == 13, f"{len(pk)} keypoints")
        check(all(math.isfinite(v) for k in pk for v in k.xy), "keypoint not finite")
    return f"{len(people)} poses"


def phase_players(frames) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        save = Path(tmp) / "players.json"
        # No device argument: the entry point's default is the card.
        tracker = PlayerTracker(None, polygon_zone=PolygonZone(COURT_POLYGON, (1920, 1080)),
                                config=PlayersTrackerConfig(), save_path=save)
        return run_tracker_slice(tracker, frames, save, 52, _check_players)


def phase_pose(frames) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        save = Path(tmp) / "pose.json"
        tracker = PlayerKeypointsTracker(None, config=PlayerKeypointsTrackerConfig(),
                                         save_path=save)
        return run_tracker_slice(tracker, frames, save, 58, _check_pose)


# A fixed court for the synthetic rally: 12 points on its lines (the
# polygon's corners among them).
COURT_KEYPOINTS = [(300, 1080), (1620, 1080), (300, 905), (960, 905), (1620, 905), (300, 527),
                   (1620, 527), (300, 155), (960, 155), (1620, 155), (300, 150), (1620, 150)]


def fixed_court(**cache) -> KeypointsTracker:
    """The fixed court; `cache`: its load_path or save_path."""
    return KeypointsTracker(
        fixed_keypoints_detection=Keypoints(
            [Keypoint(id=i, xy=(float(x), float(y))) for i, (x, y) in enumerate(COURT_KEYPOINTS)]),
        **cache)


def _json(results) -> list:
    return [r.serialize() for r in results]


def decisive_clip(n: int, seed: int, gap: tuple[int, int] = (0, 0),
                  blank: tuple[int, int] = (0, 0)) -> list[np.ndarray]:
    """1920x1080: a dark noisy court, four red player-sized figures (bright
    to the detector, dark on average to the TrackNet) and a bright ball; the
    ball missing in the frames of `gap` [lo, hi), everything in those of
    `blank`."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[-8:9, -8:9]
    disk = ys**2 + xs**2 <= 64
    frames = []
    for i in range(n):
        f = rng.integers(20, 30, (1080, 1920, 3), dtype=np.uint8)
        if blank[0] <= i < blank[1]:
            frames.append(f)
            continue
        for x0, y0, vx in ((300, 300, 9), (1400, 350, -8), (500, 700, 7), (1300, 720, -6)):
            f[y0: y0 + 180, x0 + vx * i: x0 + vx * i + 70] = (250, 60, 60)
        cx, cy = 200 + 30 * i, int(900 - 30 * i + 0.45 * i * i)
        if not gap[0] <= i < gap[1]:
            f[cy - 8: cy + 9, cx - 8: cx + 9][disk] = (235, 240, 80)
        frames.append(f)
    return frames


def _fake_trackers(n: int, pose_size: int = 1280, inpaint: Path | None = None):
    players = PlayerTracker(None, polygon_zone=PolygonZone(COURT_POLYGON, (1920, 1080)),
                            config=PlayersTrackerConfig())
    pose = PlayerKeypointsTracker(
        None, config=PlayerKeypointsTrackerConfig(train_image_size=pose_size))
    ball = BallTracker(None, config=BallTrackerConfig(
        inpainting_model_path=None if inpaint is None else str(inpaint)))
    players.engine.model = CellDetector(pose=False)
    pose.engine.model = CellDetector(pose=True)
    ball.tracknet.model = BrightTrackNet()
    court = fixed_court()
    info = VideoInfo(width=1920, height=1080, fps=30.0, total_frames=n)
    for t in (players, pose, ball, court):
        t.video_info_post_init(info)
    return players, pose, ball, court


def phase_fused_decisive() -> None:
    """The fused pipeline against the per-tracker paths with decisive fakes
    at 1080p, rgb ingest, chunk 16 and 8, on a clip whose length is not a
    multiple of either: every cache equal frame by frame."""
    n = 45
    frames = decisive_clip(n, seed=12)
    players, pose, ball, _ = _fake_trackers(n)
    with torch.inference_mode():
        for tracker in (players, pose, ball):
            tracker.predict_and_update(iter(frames), total_frames=n)
    want = {"players": _json(players.results), "players_keypoints": _json(pose.results),
            "ball": _json(ball.results)}
    found = (sum(map(len, want["players"])), sum(map(len, want["players_keypoints"])),
             sum(b["visibility"] for b in want["ball"]))
    check(all(found), f"decisive fakes found nothing: {found}")
    for chunk in (16, 8):
        out = FusedPipeline(*_fake_trackers(n), chunk=chunk, ingest="rgb").run(iter(frames), n)
        check(len(out["keypoints"]) == n, f"fused chunk {chunk}: {len(out['keypoints'])} courts")
        for key, ref in want.items():
            got = _json(out[key])
            check(len(got) == n, f"fused chunk {chunk} {key}: {len(got)} results for {n} frames")
            bad = [f for f in range(n) if got[f] != ref[f]]
            check(not bad, f"fused chunk {chunk} {key} differs from the per-tracker path at "
                           f"frames {bad[:10]}")
    print(f"fused decisive check: {n} frames 1920x1080, rgb, chunk 16 and 8 equal to the "
          f"per-tracker paths frame by frame ({found[0]} boxes, {found[1]} poses, "
          f"{found[2]} visible balls)")


TRACKER_NAMES = ("players", "pose", "ball", "court")


def full_width_trackers(cache_dir: Path, load: bool = False) -> tuple:
    """(players, pose, ball, court) at the reference's full configuration
    (YOLOv8m detect with the court polygon gate, YOLOv8m-pose at 1280,
    TrackNet 288x512, the fixed court), random weights from seed 0, each
    saving its JSON cache under `cache_dir`, or loading it from there."""
    paths = {name: cache_dir / f"{name}.json" for name in TRACKER_NAMES}
    io = {name: ({"load_path": path} if load else {"save_path": path})
          for name, path in paths.items()}
    players = PlayerTracker(None, polygon_zone=PolygonZone(COURT_POLYGON, (1920, 1080)),
                            config=PlayersTrackerConfig(), **io["players"])
    pose = PlayerKeypointsTracker(None, config=PlayerKeypointsTrackerConfig(), **io["pose"])
    ball = BallTracker(None, config=BallTrackerConfig(), **io["ball"])
    return players, pose, ball, fixed_court(**io["court"])


def _fused_pass(runner, trackers) -> float:
    runner.restart()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check("fused_inference" in runner.stage_times, "the fused path did not run")
    return seconds


def phase_fused(frames) -> dict:
    """The main path at full width through TrackingRunner(fused=True), for
    each ingest. Returns the launch counts of the first i420 pass."""
    n = len(frames)
    clip = MemoryClip(frames, fps=30.0)
    real_chunks = -(-n // FUSED_CHUNK)
    chunks = -(-(n + 7) // FUSED_CHUNK)
    want_k1 = 110 * real_chunks + 17 * chunks
    launches = None
    with tempfile.TemporaryDirectory() as tmp:
        trackers = full_width_trackers(Path(tmp))
        players, pose, ball, court = trackers
        calib = {str(t): calibrate_cls_head(t, frames[:8]) for t in (players, pose)}
        for ingest in ("i420", "rgb"):
            runner = TrackingRunner(list(trackers), clip, tmp, fused=True,
                                    fused_chunk=FUSED_CHUNK, fused_ingest=ingest, render=False,
                                    collect_data=False)
            conv3x3.reset_launches()
            heatmap.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            first_s = _fused_pass(runner, trackers)
            counts = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            check(counts["conv3x3_bn_act"] == want_k1,
                  f"fused {ingest}: K1 launches {counts['conv3x3_bn_act']} != {want_k1}")
            check(counts["heatmap_cc"] == chunks,
                  f"fused {ingest}: K2 launches {counts['heatmap_cc']} != {chunks}")
            launches = launches or counts
            for t in trackers:
                check(len(t.results) == n, f"fused {ingest} {t}: {len(t.results)} results")
                check(len(json.loads(t.save_path.read_text())) == n, f"{t}: saved JSON cache")
            found = (f"{_check_players(players.results)}; {_check_pose(pose.results)}; "
                     f"{sum(b.visibility for b in ball.results)} visible balls")
            first = [_json(t.results) for t in trackers]
            second_s = _fused_pass(runner, trackers)
            check([_json(t.results) for t in trackers] == first,
                  f"fused {ingest}: second pass differs")
            print(f"fused {ingest}: {n} frames 1920x1080, chunk {FUSED_CHUNK}, {found}; first "
                  f"pass {n / first_s:.1f} frames/s, second pass {n / second_s:.1f} frames/s "
                  f"(stage fused_inference {runner.stage_times['fused_inference']:.3f} s); peak "
                  f"device memory {peak_gib:.2f} GiB; launches {counts}")
            split = FusedPipeline(players, pose, ball, court, chunk=FUSED_CHUNK,
                                  ingest=ingest).measure_device_split(iter(frames), n, n_chunks=4)
            per_chunk = {k: split[k] / 4 * 1e3 for k in ("upload_s", "det_s", "pose_s", "ball_s")}
            print(f"fused {ingest} device split, ms a chunk of {FUSED_CHUNK}: " + ", ".join(
                f"{k[:-2]} {v:.3f}" for k, v in per_chunk.items())
                  + f"; sub-steps {split['device_ms_per_frame']:.3f} ms a frame "
                    f"({split['device_fps']:.1f} frames/s); host pack "
                    f"{split['pack_s'] / split['frames'] * 1e3:.3f} ms a frame")
            runner.restart()
            profile_run(runner.run, f"fused {ingest}",
                        (("K1", "conv3x3_bn_act"), ("K2", "heatmap_cc")), top_n=10,
                        chunks=chunks, gaps=5)
        print(f"fused cls calibration: {calib}")
    i420_ms, rgb_ms = _pack_one_ms(frames[0])
    print(f"host pack of one 1920x1080 frame on one thread: rgb_to_i420 {i420_ms:.2f} ms, "
          f"RGB copy {rgb_ms:.2f} ms (medians of 9)")
    return launches


def _pack_one_ms(frame) -> tuple[float, float]:
    """Median ms of packing one frame on this thread: I420, and the RGB copy."""
    from padel_analytics_tpu_torch.ops.color import rgb_to_i420

    i420 = np.empty((frame.shape[0] * 3 // 2, frame.shape[1]), np.uint8)
    rgb = np.empty_like(frame)
    out = []
    for fn in (lambda: rgb_to_i420(frame, out=i420), lambda: np.copyto(rgb, frame)):
        fn()
        times = []
        for _ in range(9):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out.append(float(np.median(times)))
    return out[0], out[1]


def check_csv(path: Path, n: int) -> int:
    """data.csv as the reference writes it: the unnamed index and COLUMNS,
    one row a frame in order, every field empty (NaN) or a finite float.
    Returns the number of player positions it holds."""
    lines = path.read_text().splitlines()
    check(lines[0] == "," + ",".join(COLUMNS), f"{path.name}: header")
    check(len(lines) == n + 1, f"{path.name}: {len(lines) - 1} rows for {n} frames")
    positions = 0
    for i, line in enumerate(lines[1:]):
        fields = line.split(",")
        check(len(fields) == len(COLUMNS) + 1 and fields[:2] == [str(i), str(i)],
              f"{path.name}: row {i}")
        check(all(f == "" or math.isfinite(float(f)) for f in fields[2:]),
              f"{path.name}: row {i} holds a value that is not finite")
        positions += sum(f != "" for f in fields[2:10])
    return positions


def _collect_run(runner, csv: Path) -> tuple[float, bytes]:
    """One run of the runner (inference, then collect), data.csv written
    with the port's writer; returns (wall seconds, the file's bytes)."""
    runner.restart()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run()
    runner.data_analytics.write_csv(csv, runner.video_info.fps)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, csv.read_bytes()


def phase_collect(frames, smi: str) -> dict:
    """The main path: TrackingRunner(fused=True, render=False,
    collect_data=True) at full width (the runner's default ingest), then
    data.csv with the port's writer. The launch counters are zeroed before
    and read after the first run; a second run must write the same bytes;
    a per-tracker runner over the saved caches (no inference) too.
    Returns the first run's launch counts."""
    n = len(frames)
    clip = MemoryClip(frames, fps=30.0)
    chunks = -(-(n + 7) // FUSED_CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        trackers = full_width_trackers(tmp)
        calib = {str(t): calibrate_cls_head(t, frames[:8]) for t in trackers[:2]}
        runner = TrackingRunner(list(trackers), clip, tmp / "unused.mp4", fused=True,
                                fused_chunk=FUSED_CHUNK, render=False, collect_data=True)
        conv3x3.reset_launches()
        heatmap.reset_launches()
        first_s, first = _collect_run(runner, tmp / "data.csv")
        counts = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
        check("fused_inference" in runner.stage_times, "collect: the fused path did not run")
        check(counts["conv3x3_bn_act"] == 110 * -(-n // FUSED_CHUNK) + 17 * chunks
              and counts["heatmap_cc"] == chunks, f"collect: launches {counts}")
        positions = check_csv(tmp / "data.csv", n)
        check(positions > 0, "collect: data.csv holds no player position")
        second_s, second = _collect_run(runner, tmp / "data.csv")
        check(second == first, "collect: a second run wrote other data.csv bytes")
        collect_ms = runner.stage_times["draw_and_collect"] / n * 1e3
        fused_s = runner.stage_times["fused_inference"]

        # The caches just saved, loaded by a per-tracker runner: no
        # inference (no launch), the same data.csv.
        cached = full_width_trackers(tmp, load=True)
        check(all(len(t) == n for t in cached), "collect: caches not loaded")
        again = TrackingRunner(list(cached), clip, tmp / "unused.mp4", fused=False,
                               render=False, collect_data=True)
        conv3x3.reset_launches()
        heatmap.reset_launches()
        again.run()
        again.data_analytics.write_csv(tmp / "cached.csv", again.video_info.fps)
        check(conv3x3.launches == heatmap.launches == 0 and again.stage_times.keys()
              == {"draw_and_collect"}, "collect: the cache-skip runner ran inference")
        check((tmp / "cached.csv").read_bytes() == first,
              "collect: the cache-skip per-tracker run wrote other data.csv bytes")
        phase_render(cached, clip, tmp)
    print(f"collect ({smi}): {n} frames 1920x1080, fused ingest {runner.fused_ingest}, "
          f"{positions} player positions in data.csv; fused + collect {n / first_s:.1f} "
          f"frames/s first run, {n / second_s:.1f} second (fused inference {n / fused_s:.1f} "
          f"frames/s); collect pass {collect_ms:.4f} ms a frame on the host; data.csv equal on "
          f"the second run and from the loaded caches; launches {counts}; calibration {calib}")
    return counts


def phase_render(trackers, clip: MemoryClip, tmp: Path) -> None:
    """render=True: where OpenCV is absent it must refuse when the runner is
    built, before any inference; where it is present, 16 frames are drawn
    and encoded and read back."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        probe = full_width_trackers(tmp / "probe")  # fresh: nothing loaded, nothing inferred
        conv3x3.reset_launches()
        try:
            TrackingRunner(list(probe), clip, tmp / "r.mp4", fused=True, render=True,
                           collect_data=True)
        except ImportError as e:
            check("cv2" in str(e), f"render refusal does not name cv2: {e}")
        else:
            raise RuntimeError("chip_smoke: render=True without OpenCV did not refuse")
        check(conv3x3.launches == 0 and all(len(t) == 0 for t in probe),
              "render: inference ran before the refusal")
        print("render: OpenCV absent; TrackingRunner(render=True) refused before inference "
              "(ImportError naming cv2)")
        return
    runner = TrackingRunner(list(trackers), clip, tmp / "r.mp4", end=16, render=True,
                            collect_data=True)
    runner.run()
    cap = cv2.VideoCapture(str(tmp / "r.mp4"))
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    check(count == 16, f"render: {count} frames in the mp4")
    print(f"render: OpenCV {cv2.__version__} present; 16 frames 1920x1080 drawn, encoded (mp4v) "
          f"and read back; draw pass {runner.stage_times['draw_and_collect'] / 16 * 1e3:.2f} ms "
          "a frame on the host")


def phase_collect_decisive() -> None:
    """With the decisive fakes, the fused run's data.csv equals the
    per-tracker run's (1080p, 45 frames, rgb ingest, chunk 16)."""
    n = 45
    clip = MemoryClip(decisive_clip(n, seed=12), fps=30.0)
    csvs = []
    with tempfile.TemporaryDirectory() as tmp:
        for fused in (True, False):
            runner = TrackingRunner(list(_fake_trackers(n)), clip, Path(tmp) / "unused.mp4",
                                    fused=fused, fused_chunk=FUSED_CHUNK, fused_ingest="rgb",
                                    render=False, collect_data=True)
            with torch.inference_mode():
                runner.run()
            check(("fused_inference" in runner.stage_times) == fused, "decisive collect: path")
            path = Path(tmp) / f"{fused}.csv"
            runner.data_analytics.write_csv(path, runner.video_info.fps)
            csvs.append(path.read_bytes())
        positions = check_csv(path, n)
    check(positions > 0, "decisive collect: no player position")
    check(csvs[0] == csvs[1], "decisive collect: fused data.csv differs from the per-tracker one")
    print(f"collect decisive check: {n} frames 1920x1080, fused data.csv equal to the "
          f"per-tracker one ({positions} player positions)")


def phase_cli() -> dict:
    """The CLI's own code on the card: run_pipeline over a clip in memory
    (no video file ships with the repo) with a keypoints JSON and no render,
    the reference's default configuration; returns its launch counts."""
    n = 32
    frames = synthetic_players(n, seed=5)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "keypoints.json").write_text(json.dumps(COURT_KEYPOINTS))
        cfg = PipelineConfig(output_video_path=str(tmp / "unused.mp4"), render_video=False,
                             collect_data_path=str(tmp / "data.csv"),
                             fixed_court_keypoints_load_path=str(tmp / "keypoints.json"))
        conv3x3.reset_launches()
        heatmap.reset_launches()
        runner = cli.run_pipeline(cfg, video=MemoryClip(frames, fps=30.0), interactive=False)
        counts = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
        check("fused_inference" in runner.stage_times, "cli: the fused path did not run")
        check(all(counts.values()), f"cli: a kernel did not run: {counts}")
        check_csv(tmp / "data.csv", n)
    print(f"cli: run_pipeline on a {n}-frame 1920x1080 MemoryClip wrote data.csv ({n} rows); "
          f"launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# Phase 14: the fast configuration (the JAX package's headline plan).


def fast_trackers(cache_dir: Path) -> tuple:
    """(players, pose, ball, court) of the fast configuration: YOLOv8m detect
    @640 with the polygon gate, YOLOv8m-pose @640, TrackNet 288x512 with
    subpixel_up, the fixed court; random weights from seed 0, each saving
    its JSON cache under `cache_dir`."""
    save = {name: {"save_path": cache_dir / f"{name}.json"} for name in TRACKER_NAMES}
    players = PlayerTracker(None, polygon_zone=PolygonZone(COURT_POLYGON, (1920, 1080)),
                            config=PlayersTrackerConfig(), **save["players"])
    pose = PlayerKeypointsTracker(
        None, config=PlayerKeypointsTrackerConfig(train_image_size=640), **save["pose"])
    ball = BallTracker(None, config=BallTrackerConfig(subpixel_up=True), **save["ball"])
    return players, pose, ball, fixed_court(**save["court"])


def phase_fast_k1(dev, timed: dict, k1: dict) -> dict:
    """K1 at the fast configuration's new shapes: YOLOv8m-pose at 640x640
    (silu) and TrackNet's subpixel skip convs (identity epilogue), at the
    fused chunk of 16 and, for TrackNet, at the 2 windows a chunk of the
    nonoverlap mode; each against its plain version, timed beside cuDNN and
    its bound. Returns the sums of one fast chunk's launches at each stride."""
    pose640 = k1_call_shapes(YOLOv8("m", 1, 13), *POSE640_HW)
    check(len(pose640) == 58, f"K1 call sites of pose @640: {len(pose640)}")
    detect = k1_call_shapes(YOLOv8("m", 1), *DETECT_HW)
    sums = {}
    for stride, tn_batch in ((1, FUSED_CHUNK), (8, FUSED_CHUNK // 8)):
        tn = _k1_calls(dev, timed, TRACKNET_SUBPIXEL_CALLS, tn_batch)
        sums[f"tracknet_subpixel_b{tn_batch}"] = _k1_sum(
            f"TrackNet subpixel (B={tn_batch})", tn, tn_batch)
        det = _k1_calls(dev, timed, [(s, "silu") for s in detect], FUSED_CHUNK)
        pose = _k1_calls(dev, timed, [(s, "silu") for s in pose640], FUSED_CHUNK)
        if stride == 1:
            sums["yolov8m_pose_640x640_b16"] = _k1_sum("YOLOv8m-pose @640x640", pose, FUSED_CHUNK)
        sums[f"fast_chunk_stride{stride}"] = _k1_sum(
            f"one fast chunk at ball stride {stride} (TrackNet subpixel at B={tn_batch} + "
            f"detect + pose @640 at B={FUSED_CHUNK})", tn + det + pose, FUSED_CHUNK)
    print(f"K1 at the fast configuration's new shapes checked and timed: pose @640's "
          f"{len(set(pose640))} distinct at B={FUSED_CHUNK}, the {len(SUBPIXEL_SKIP_CONVS)} "
          f"subpixel skip convs at B={FUSED_CHUNK} and B={FUSED_CHUNK // 8}")
    k1["max_abs_err"] = max(v["max_err"] for v in timed.values())
    return sums


def _pass_ratio(R: np.ndarray) -> float:
    """Dense MACs over banded MACs of one pass (the gate's ratio)."""
    _, w, n_tiles, band = resize._band_plan(R, resize.BAND_TILE)
    return R.shape[0] * R.shape[1] / (band * n_tiles * w.shape[1])


def phase_banded(dev, frames) -> None:
    """Each resize pass of the fused plans (from 1080p and from the 960x540
    wire) with its form and MAC ratio; every banded one against the dense
    form on the card over a chunk of real frames: the uint8 results equal,
    or one step apart where fp32 summation order moves a value across a .5
    boundary (counted); both forms timed."""
    wire = (540, 960)
    plans = [(src, dst, m) for src in ((1080, 1920), wire) for dst, m in (
        ((1280, 1280), "pil_bicubic"), ((640, 640), "pil_bicubic"), ((288, 512), "pil_bicubic"),
        ((360, 640), "cv2_linear"))]
    x_src = torch.from_numpy(np.stack(frames[:FUSED_CHUNK])).to(dev)
    x_wire = torch.from_numpy(np.stack([resize_area(f, wire)
                                        for f in frames[:FUSED_CHUNK]])).to(dev)
    for src, dst, method in plans:
        plan = resize.resize_plan(src, dst, method)
        forms = plan.forms()
        print(f"resize {src[1]}x{src[0]} -> {dst[1]}x{dst[0]} {method}: " + ", ".join(
            f"{axis} pass {form} (dense/banded MACs {_pass_ratio(R):.2f})"
            for axis, R, form in (("W", plan.r_w, forms[0]), ("H", plan.r_h, forms[1]))))
        if "banded" not in forms:
            continue
        x = x_src if src == (1080, 1920) else x_wire
        got = plan.apply(x)
        want = plan.apply(x, banded=False)
        torch.cuda.synchronize()
        off = (torch.floor(got + 0.5).clamp(0, 255) - torch.floor(want + 0.5).clamp(0, 255)).abs()
        moved = int((off > 0).sum())
        check(float(off.max()) <= 1.0 and moved <= off.numel() // 1000,
              f"banded resize {src} -> {dst}: {moved} values moved, max {float(off.max())}")
        banded_ms = cuda_time_ms(lambda: plan.apply(x), reps=5)
        dense_ms = cuda_time_ms(lambda: plan.apply(x, banded=False), reps=5)
        print(f"  banded against dense on the card, B={FUSED_CHUNK}: {moved} of {off.numel()} "
              f"uint8 values one step apart (a .5 boundary), none further; banded "
              f"{banded_ms:.3f} ms, dense {dense_ms:.3f} ms")


def _median_ms(fn, reps: int = 9) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_area(frames) -> None:
    """The host's INTER_AREA against cv2 where OpenCV imports (bit-equal:
    1080p and 720p frames to the 960x540 wire, and the float32 median), and
    the derived ingest's host pack timed: INTER_AREA and the I420 pack
    apart, on one thread (medians of 9) and over a chunk on the pack pool
    (ms a frame), beside the full-resolution I420 pack."""
    from concurrent.futures import ThreadPoolExecutor

    wire = (540, 960)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        print("INTER_AREA against cv2: OpenCV absent here (held against cv2 on the CPU host by "
              "tests/test_torch_area.py)")
    else:
        rng = np.random.default_rng(13)
        small = [np.ascontiguousarray(f[180:900, 320:1600]) for f in frames[:2]]
        median = (frames[0].astype(np.float32) + frames[1]) / 2
        cases = ([(f, wire) for f in frames[:4]] + [(f, wire) for f in small]
                 + [(median, wire), (median[:720, :1280].copy(), wire),
                    (rng.integers(0, 256, (97, 129, 3), dtype=np.uint8), (48, 64))])
        for img, dst in cases:
            want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
            check(np.array_equal(resize_area(img, dst), want),
                  f"INTER_AREA {img.shape} {img.dtype} -> {dst} differs from cv2")
        print(f"INTER_AREA bit-equal to OpenCV {cv2.__version__} on {len(cases)} cases (1080p and "
              "720p uint8 frames and float32 medians to 960x540, an odd 129x97)")
    frame = frames[0]
    planes = resize_area_planes(frame, wire).copy()
    i420 = np.empty((wire[0] * 3 // 2, wire[1]), np.uint8)
    one = {"INTER_AREA": _median_ms(lambda: resize_area_planes(frame, wire)),
           "I420 at 960x540": _median_ms(lambda: planes_to_i420(planes, i420)),
           "I420 at 1920x1080": _median_ms(lambda: rgb_to_i420(frame))}
    chunk = frames[:FUSED_CHUNK]
    outs = np.empty((len(chunk),) + i420.shape, np.uint8)
    full = np.empty((len(chunk), 1620, 1920), np.uint8)
    jobs = {"INTER_AREA": lambda i: resize_area_planes(chunk[i], wire),
            "INTER_AREA + I420 (the derived pack)":
                lambda i: planes_to_i420(resize_area_planes(chunk[i], wire), outs[i]),
            "I420 at 1920x1080": lambda i: rgb_to_i420(chunk[i], out=full[i])}
    pool_ms = {}
    with ThreadPoolExecutor(PACK_THREADS) as pool:
        for name, job in jobs.items():
            pool_ms[name] = _median_ms(
                lambda: list(pool.map(job, range(len(chunk)))), reps=5) / len(chunk)
    print("host pack, one thread (ms a frame): " + ", ".join(
        f"{k} {v:.3f}" for k, v in one.items()) + f"; on {PACK_THREADS} threads over a chunk "
          f"of {len(chunk)} (ms a frame): " + ", ".join(f"{k} {v:.3f}" for k, v in pool_ms.items()))


def decisive_fast_clip(n: int, seed: int) -> list[np.ndarray]:
    """1920x1080 decisive_clip for the derived ingest: three red figures and
    a bright square ball whose every edge lies 3-5 px inside an 8x8 cell of
    both model inputs (the 384x640 letterbox, x/3 and y/3 + 12, and the
    640x640 pose squash, x/3 and y/1.6875), moving 24 px (one detector cell)
    a frame. Resampling blurs an edge by at most 2 model pixels on either
    path, so no cell's maximum crosses the fakes' threshold between the rgb
    and the derived input."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        f = rng.integers(20, 30, (1080, 1920, 3), dtype=np.uint8)
        for (y0, y1), x0, vx in (((47, 264), 60, 24), ((290, 507), 1692, -24),
                                 ((817, 1033), 252, 24)):
            x = x0 + vx * i
            f[y0:y1, x: x + 72] = (250, 60, 60)
        x = 108 + 24 * i
        f[574:600, x: x + 24] = (235, 240, 80)
        frames.append(f)
    return frames


def phase_fast_decisive() -> None:
    """Decisive fakes at 1080p, chunk 16, pose at 640: the derived run's det
    boxes and pose keypoints equal the rgb run's within 1e-2 px (letterboxing
    the wire and scaling back is the affine map of letterboxing the source);
    the nonoverlap caches equal the stride-1 caches (each heatmap channel of
    the fake depends on its own frame alone)."""
    n = 45
    frames = decisive_fast_clip(n, seed=12)
    runs = {}
    for name, kw in (("rgb", {"ingest": "rgb"}),
                     ("derived", {"ingest": "derived", "wire_long_side": WIRE_LONG_SIDE}),
                     ("derived stride 8", {"ingest": "derived", "wire_long_side": WIRE_LONG_SIDE,
                                           "ball_stride": 8})):
        pipe = FusedPipeline(*_fake_trackers(n, pose_size=640), chunk=FUSED_CHUNK, **kw)
        runs[name] = pipe.run(iter(frames), n)
        check(pipe.ingest == kw["ingest"], f"decisive fast {name}: ingest {pipe.ingest}")
    boxes = poses = 0
    for f in range(n):
        a, b = runs["rgb"]["players"][f], runs["derived"]["players"][f]
        check(len(a) == len(b), f"decisive fast: frame {f} boxes {len(a)} vs {len(b)}")
        for pa, pb in zip(a, b):
            check(np.allclose(pa.xyxy, pb.xyxy, atol=1e-2) and pa.id == pb.id,
                  f"decisive fast: frame {f} box {pa.xyxy} vs {pb.xyxy}")
            boxes += 1
        ka, kb = runs["rgb"]["players_keypoints"][f], runs["derived"]["players_keypoints"][f]
        check(len(ka) == len(kb), f"decisive fast: frame {f} poses {len(ka)} vs {len(kb)}")
        for pka, pkb in zip(ka, kb):
            check(all(np.allclose(qa.xy, qb.xy, atol=1e-2) for qa, qb in zip(pka, pkb)),
                  f"decisive fast: frame {f} keypoints differ")
            poses += 1
    check(boxes > 0 and poses > 0, "decisive fast: nothing detected")
    for key in ("players", "players_keypoints", "ball", "keypoints"):
        got = _json(runs["derived stride 8"][key])
        check(got == _json(runs["derived"][key]),
              f"decisive fast: nonoverlap {key} differs from stride 1")
    visible = sum(b.visibility for b in runs["derived"]["ball"])
    check(visible > 0, "decisive fast: no visible ball")
    print(f"fast decisive check: {n} frames 1920x1080, chunk {FUSED_CHUNK}, pose @640: derived "
          f"(wire 960x540) boxes and keypoints within 1e-2 px of rgb ({boxes} boxes, {poses} "
          f"poses); ball_stride 8 caches equal to stride 1 ({visible} visible balls)")


def phase_fast(frames, smi: str) -> dict:
    """The fast configuration through TrackingRunner(fused=True,
    fused_ingest="derived", fused_wire_long_side=960) at full width, at ball
    stride 1 and 8. Returns each stride's launch counts of its first pass."""
    n = len(frames)
    clip = MemoryClip(frames, fps=30.0)
    real_chunks = -(-n // FUSED_CHUNK)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        trackers = fast_trackers(Path(tmp))
        players, pose, ball, court = trackers
        calib = {str(t): calibrate_cls_head(t, frames[:8]) for t in (players, pose)}
        for stride in (1, 8):
            chunks = -(-(n + (7 if stride == 1 else 0)) // FUSED_CHUNK)
            runner = TrackingRunner(list(trackers), clip, tmp, fused=True,
                                    fused_chunk=FUSED_CHUNK, fused_ingest="derived",
                                    fused_wire_long_side=WIRE_LONG_SIDE,
                                    fused_ball_stride=stride, render=False, collect_data=False)
            conv3x3.reset_launches()
            heatmap.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            first_s = _fused_pass(runner, trackers)
            counts = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            want_k1 = 110 * real_chunks + 17 * chunks
            check(counts == {"conv3x3_bn_act": want_k1, "heatmap_cc": chunks},
                  f"fast stride {stride}: launches {counts}, want K1 {want_k1}, K2 {chunks}")
            check(runner._fused_pipeline.ingest == "derived", "fast: the ingest fell back")
            for t in trackers:
                check(len(t.results) == n, f"fast stride {stride} {t}: {len(t.results)} results")
            found = (f"{_check_players(players.results)}; {_check_pose(pose.results)}; "
                     f"{sum(b.visibility for b in ball.results)} visible balls")
            check(all(0 <= b.xy[0] < 1920 and 0 <= b.xy[1] < 1080 for b in ball.results),
                  f"fast stride {stride}: ball outside the frame")
            first = [_json(t.results) for t in trackers]
            second_s = _fused_pass(runner, trackers)
            check([_json(t.results) for t in trackers] == first,
                  f"fast stride {stride}: second pass differs")
            print(f"fast stride {stride} ({smi}): {n} frames 1920x1080, derived wire 960x540, "
                  f"pose @640, TrackNet subpixel, chunk {FUSED_CHUNK}, {found}; first pass "
                  f"{n / first_s:.1f} frames/s, second pass {n / second_s:.1f} frames/s; peak "
                  f"device memory {peak_gib:.2f} GiB; launches {counts}")
            split = FusedPipeline(players, pose, ball, court, chunk=FUSED_CHUNK, ingest="derived",
                                  wire_long_side=WIRE_LONG_SIDE, ball_stride=stride
                                  ).measure_device_split(iter(frames), n, n_chunks=4)
            per_chunk = {k: split[k] / 4 * 1e3 for k in ("upload_s", "det_s", "pose_s", "ball_s")}
            print(f"fast stride {stride} device split, ms a chunk of {FUSED_CHUNK}: " + ", ".join(
                f"{k[:-2]} {v:.3f}" for k, v in per_chunk.items())
                  + f"; sub-steps {split['device_ms_per_frame']:.3f} ms a frame "
                    f"({split['device_fps']:.1f} frames/s); host pack "
                    f"{split['pack_s'] / split['frames'] * 1e3:.3f} ms a frame")
            runner.restart()
            prof = profile_run(runner.run, f"fast stride {stride}",
                               (("K1", "conv3x3_bn_act"), ("K2", "heatmap_cc")), top_n=8,
                               chunks=chunks, gaps=3)
            out[f"fast_stride{stride}"] = {**counts, "chunks": chunks,
                                           "device_ms": prof.get("kernel_ms", {})}
        print(f"fast cls calibration: {calib}")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the model-based court (yolo, resnet) and InpaintNet.


def phase_court_k1(dev, timed: dict, k1: dict) -> dict:
    """K1 at the court models' shapes, traced from the models on the meta
    device: the court YOLOv8m-pose (12 keypoints) at its 640x640 squash (58
    convs; its keypoint head's c4 = max(192 // 4, 36) = 48 channels, as
    pose's max(48, 39)) and ResNet-50's 13 stride-1 conv2s at 224x224, each
    at B=8 and at the fused chunk of 16, against the plain version, timed
    beside cuDNN and the bound. Returns the sums over each model's convs."""
    court = k1_call_shapes(YOLOv8("m", 1, 12), *COURT_YOLO_HW)
    resnet = k1_call_shapes(ResNet50Regressor(), *RESNET_HW)
    check(len(court) == 58 and len(resnet) == 13, f"K1 call sites {len(court)}, {len(resnet)}")
    check(sorted(set(resnet)) == sorted(RESNET_CONVS), f"ResNet-50 K1 shapes {sorted(set(resnet))}")
    sums = {}
    for batch in (BATCH, FUSED_CHUNK):
        sums[f"court_yolo_640x640_b{batch}"] = _k1_sum(
            "the court YOLOv8m-pose @640x640", _k1_calls(dev, timed, [(s, "silu") for s in court],
                                                         batch), batch)
        sums[f"resnet50_224x224_b{batch}"] = _k1_sum(
            "ResNet-50 @224x224", _k1_calls(dev, timed, [(s, "relu") for s in resnet], batch), batch)
    k1["max_abs_err"] = max(v["max_err"] for v in timed.values())
    return sums


def write_inpaint_checkpoint(directory: Path) -> Path:
    """A seeded InpaintNet in the reference's checkpoint format
    ({'model': state_dict, 'param_dict': {'seq_len': 16}}), written by
    torch.save; nothing is downloaded."""
    net = lecun_normal_(InpaintNet(), torch.Generator().manual_seed(23))
    path = directory / "inpaintnet.pt"
    torch.save({"model": net.state_dict(), "param_dict": {"seq_len": 16}}, path)
    return path


def court_tracker(mode: str, batch: int = 8, **cache) -> KeypointsTracker:
    """The model court at its full configuration (YOLOv8m-pose with 12
    keypoints at 640, or ResNet-50 at 224), random weights from seed 0."""
    return KeypointsTracker(config=CourtKeypointsTrackerConfig(model_type=mode, batch_size=batch),
                            **cache)


def calibrate_court(court, frames) -> dict:
    """Make the random court head give a court a real model would. 'yolo':
    the cls head as calibrate_cls_head does (about 2 candidates a frame, the
    best one kept), then the keypoint head's (x, y) projections scaled until
    the kept candidate's 12 keypoints spread ~150 px around its anchor (they
    sit within a cell of it at random weights). 'resnet': the fc kernel
    scaled until the logits' spread over `frames` is 0.3, its bias set to the
    logits of the synthetic court's 12 keypoints (normalised), so the
    regression lands near the court lines with a per-frame jitter.
    Script-side only; the package never calibrates."""
    model = court.engine.model
    x = torch.from_numpy(np.stack(frames)).to(court.device)
    if court.model_type == "resnet":
        plan = resize.resize_plan(tuple(x.shape[1:3]), RESNET_HW, "pil_bilinear")
        with torch.no_grad():
            model.fc.bias.zero_()
        with torch.inference_mode():
            logits = model(imagenet_normalize(plan.apply(x) / 255.0).to(court.compute_dtype))
        scale = 0.3 / max(float(logits.std()), 1e-6)
        target = np.clip(np.array(COURT_KEYPOINTS, np.float64) / (1920.0, 1080.0), 0.02, 0.98)
        bias = torch.tensor(np.log(target / (1 - target)).reshape(-1), dtype=torch.float32)
        with torch.no_grad():
            model.fc.weight.mul_(scale)
            model.fc.bias.copy_(bias.to(court.device))
        return {"fc_kernel_scale": float(f"{scale:.3g}"), "fc_bias": "logit(court keypoints)"}
    calib = calibrate_cls_head(court, frames, target=2)
    projs = [getattr(model, f"kpt_{i}").proj for i in range(3)]
    xy = torch.tensor([c % 3 < 2 for c in range(36)], device=court.device)
    spread = None
    for _ in range(4):
        with torch.inference_mode():
            out, scores = court.model_outputs(x)
            best = scores.argmax(dim=-1)
            k = out["kpts"][torch.arange(len(best), device=best.device), best][..., :2]
            spread = float(k.std(dim=1).mean())
        if spread >= 100.0:
            break
        with torch.no_grad():
            for p in projs:
                f = min(150.0 / max(spread, 1e-3), 64.0)
                p.weight[xy] *= f
                p.bias[xy] *= f
    return {**calib, "keypoint_spread_px": round(spread, 1)}


def _court_runner(mode: str, frames, tmp: Path, fused: bool, inpaint: Path):
    """The decisive fakes (cell detectors, the bright-pixel TrackNet) with a
    model court and an InpaintNet, under a runner that collects data.csv.
    'yolo': a 12-keypoint cell detector; 'resnet': ResNet-50 with He-normal
    weights and its head calibrated, at the fused chunk's batch."""
    n = len(frames)
    players, pose, ball, _ = _fake_trackers(n, inpaint=inpaint)
    court = court_tracker(mode, batch=FUSED_CHUNK)
    if mode == "yolo":
        court.engine.model = CellDetector(pose=True, nk=12)
    else:
        he_normal_(court.engine.model, 24)
        calibrate_court(court, frames[:4])
    court.video_info_post_init(VideoInfo(width=1920, height=1080, fps=30.0, total_frames=n))
    runner = TrackingRunner([players, pose, ball, court], MemoryClip(frames, fps=30.0),
                            tmp / "unused.mp4", fused=fused, fused_chunk=FUSED_CHUNK,
                            fused_ingest="rgb", render=False, collect_data=True)
    with torch.inference_mode():
        runner.run()
    check(("fused_inference" in runner.stage_times) == fused, f"court decisive {mode}: path")
    csv = tmp / f"{mode}_{fused}.csv"
    runner.data_analytics.write_csv(csv, runner.video_info.fps)
    return runner.trackers, csv


def phase_court_decisive() -> None:
    """The fused model court and the fused InpaintNet pass against the
    per-tracker runner (TrackingRunner fused=False), 1080p, 45 frames with a
    6-frame gap in the ball and 3 blank frames (no court), rgb, chunk 16: the yolo court's cache equal
    (decisive fakes), the resnet court's within COURT_RESNET_PX at the same
    batch, the inpainted ball cache equal, data.csv of the yolo run equal."""
    n = 45
    frames = decisive_clip(n, seed=12, gap=(20, 26), blank=(33, 36))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        inpaint = write_inpaint_checkpoint(tmp)
        for mode in ("yolo", "resnet"):
            (fused, fused_csv), (sep, sep_csv) = (_court_runner(mode, frames, tmp, f, inpaint)
                                                  for f in (True, False))
            a, b = (_json(fused["keypoints_tracker"].results),
                    _json(sep["keypoints_tracker"].results))
            check(len(a) == len(b) == n, f"court decisive {mode}: {len(a)}, {len(b)} results")
            empty = sum(not k for k in a)
            if mode == "yolo":
                bad = [f for f in range(n) if a[f] != b[f]]
                check(not bad, f"court decisive yolo: fused differs at frames {bad[:10]}")
                check(empty == 3, f"court decisive yolo: {empty} empty detections, want the 3 "
                                  "blank frames'")
                check(fused_csv.read_bytes() == sep_csv.read_bytes(),
                      "court decisive yolo: fused data.csv differs from the per-tracker one")
                positions = check_csv(fused_csv, n)
            else:
                err = max(abs(p - q) for ka, kb in zip(a, b) for pa, pb in zip(ka, kb)
                          for p, q in zip(pa["xy"], pb["xy"]))
                check(empty == 0 and err <= COURT_RESNET_PX,
                      f"court decisive resnet: fused vs per-tracker max err {err} px, {empty} empty")
            balls = _json(fused["ball_tracker"].results)
            check(balls == _json(sep["ball_tracker"].results),
                  f"court decisive {mode}: the fused inpainted ball cache differs")
            print(f"court decisive {mode}: {n} frames 1920x1080, chunk {FUSED_CHUNK}, fused = "
                  f"per-tracker runner: " + (f"court cache equal ({empty} empty detections), "
                                             f"data.csv equal ({positions} player positions)"
                                             if mode == "yolo" else
                                             f"court within {err:.3g} px (bound {COURT_RESNET_PX})")
                  + f"; inpainted ball cache equal ({sum(x['visibility'] for x in balls)} visible)")


def phase_court(frames, smi: str) -> dict:
    """The moving-camera main path at full width through
    TrackingRunner([players, pose, ball, court], fused=True, render=False,
    collect_data=True): YOLOv8m detect @640, YOLOv8m-pose @1280, TrackNet +
    InpaintNet (seq_len 16) and the court from YOLOv8m-pose (12 keypoints)
    @640, then from ResNet-50 @224; heads calibrated. Per mode: the launch
    counters zeroed before and read after the first pass, a second pass
    equal to the first (caches and data.csv), measure_device_split's court_s,
    the inpaint pass's ms, peak memory, empty court detections. Returns each
    mode's launch counts."""
    n = len(frames)
    clip = MemoryClip(frames, fps=30.0)
    real_chunks = -(-n // FUSED_CHUNK)
    chunks = -(-(n + 7) // FUSED_CHUNK)
    out = {}
    for mode, court_convs in (("yolo", 58), ("resnet", 13)):
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            inpaint = write_inpaint_checkpoint(tmp)
            players, pose, _, _ = full_width_trackers(tmp)
            ball = BallTracker(None, config=BallTrackerConfig(inpainting_model_path=str(inpaint)),
                               save_path=tmp / "ball.json")
            court = court_tracker(mode, save_path=tmp / "court.json")
            trackers = (players, pose, ball, court)
            calib = {str(t): calibrate_cls_head(t, frames[:8]) for t in (players, pose)}
            calib[f"court {mode}"] = calibrate_court(court, frames[:8])
            inpaint_ms: list[float] = []
            pass_fn = ball._inpaint_pass

            def timed_inpaint(pred, video_len):
                t0 = time.perf_counter()
                result = pass_fn(pred, video_len)  # ends in a download: synchronised
                inpaint_ms.append((time.perf_counter() - t0) * 1e3)
                return result

            ball._inpaint_pass = timed_inpaint
            runner = TrackingRunner(list(trackers), clip, tmp / "unused.mp4", fused=True,
                                    fused_chunk=FUSED_CHUNK, render=False, collect_data=True)
            conv3x3.reset_launches()
            heatmap.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            first_s, first_csv = _collect_run(runner, tmp / "data.csv")
            counts = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            check("fused_inference" in runner.stage_times, f"court {mode}: the fused path did not run")
            want_k1 = (110 + court_convs) * real_chunks + 17 * chunks
            check(counts == {"conv3x3_bn_act": want_k1, "heatmap_cc": chunks},
                  f"court {mode}: launches {counts}, want K1 {want_k1}, K2 {chunks}")
            for t in trackers:
                check(len(t.results) == n, f"court {mode} {t}: {len(t.results)} results")
                check(len(json.loads(t.save_path.read_text())) == n, f"court {mode} {t}: saved cache")
            kps = list(court.results)
            empty = sum(not k for k in kps)
            check(all(len(k) == 12 and all(math.isfinite(v) for p in k for v in p.xy)
                      for k in kps if k), f"court {mode}: keypoints")
            check(mode == "yolo" or empty == 0, f"court resnet: {empty} empty detections")
            positions = check_csv(tmp / "data.csv", n)
            found = (f"{_check_players(players.results)}; {_check_pose(pose.results)}; "
                     f"{sum(b.visibility for b in ball.results)} visible balls after inpainting; "
                     f"{empty} frames without a court; {positions} player positions in data.csv")
            first = [_json(t.results) for t in trackers]
            second_s, second_csv = _collect_run(runner, tmp / "data.csv")
            check([_json(t.results) for t in trackers] == first and second_csv == first_csv,
                  f"court {mode}: second pass differs")
            fused_s = runner.stage_times["fused_inference"]
            print(f"court {mode} ({smi}): {n} frames 1920x1080, chunk {FUSED_CHUNK}, ingest "
                  f"{runner.fused_ingest}, {found}; fused + collect {n / first_s:.1f} frames/s "
                  f"first pass, {n / second_s:.1f} second (fused inference {n / fused_s:.1f} "
                  f"frames/s), second equal to the first; inpaint pass {inpaint_ms[0]:.2f} / "
                  f"{inpaint_ms[-1]:.2f} ms (first / second); peak device memory {peak_gib:.2f} "
                  f"GiB; launches {counts}; calibration {calib}")
            split = FusedPipeline(players, pose, ball, court, chunk=FUSED_CHUNK,
                                  ingest=runner.fused_ingest).measure_device_split(
                iter(frames), n, n_chunks=4)
            per_chunk = {k: split[k] / 4 * 1e3
                         for k in ("upload_s", "det_s", "pose_s", "ball_s", "court_s")}
            print(f"court {mode} device split, ms a chunk of {FUSED_CHUNK}: " + ", ".join(
                f"{k[:-2]} {v:.3f}" for k, v in per_chunk.items())
                  + f"; sub-steps {split['device_ms_per_frame']:.3f} ms a frame "
                    f"({split['device_fps']:.1f} frames/s)")
            out[f"court_{mode}"] = counts
            del runner, trackers, players, pose, ball, court
            torch.cuda.empty_cache()
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start(target, world: int, *args) -> list:
    """target(rank, port, *args) started in `world` spawned processes."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, port, *args)) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _wait(procs: list, timeout: float = 900) -> list[int]:
    """Wait for `procs` (none outlives the call); their exit codes."""
    for p in procs:
        p.join(timeout=timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return [p.exitcode for p in procs]


def _join(procs: list, what: str, timeout: float = 900) -> None:
    """Wait for `procs`; raises unless every one exits 0."""
    codes = _wait(procs, timeout)
    check(all(c == 0 for c in codes), f"{what}: exit codes {codes}")


def _spawn(target, world: int, *args, timeout: float = 900) -> None:
    """Run target(rank, port, *args) in `world` spawned processes; raises
    unless every one exits 0 (none outlives the call)."""
    _join(_start(target, world, *args), target.__name__, timeout)


def _run_files(trackers, clip, out: Path, **kwargs) -> dict[str, bytes]:
    """One TrackingRunner(fused=True, render=False, collect_data=True) run
    saving each tracker's cache and data.csv under `out`; their bytes."""
    out.mkdir()
    for t, name in zip(trackers, TRACKER_NAMES):
        t.save_path = out / f"{name}.json"
    runner = TrackingRunner(list(trackers), clip, out / "unused.mp4", fused=True,
                            fused_chunk=FUSED_CHUNK, fused_ingest="rgb", render=False,
                            collect_data=True, **kwargs)
    with torch.inference_mode():
        runner.run()
    check("fused_inference" in runner.stage_times, "mesh decisive: the fused path did not run")
    runner.write_csv(out / "data.csv")
    return {p.name: p.read_bytes() for p in sorted(out.iterdir()) if p.suffix in (".json", ".csv")}


def phase_mesh_decisive(mesh) -> None:
    """(a) With the decisive fakes, the mesh runner's files equal the
    single-device run()'s byte for byte, for each association."""
    n = 45
    clip = MemoryClip(decisive_clip(n, seed=12), fps=30.0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        files = {(assoc, m is not None): _run_files(_fake_trackers(n), clip,
                                                    tmp / f"{assoc}{m is not None}",
                                                    fused_association=assoc, mesh=m)
                 for assoc, m in (("host", None), ("host", mesh), ("device", None),
                                  ("auto", mesh))}
    for (assoc, on_mesh), got in files.items():
        check(len(got) == 5, f"mesh decisive {assoc}: files {sorted(got)}")
    check(files["host", True] == files["host", False],
          "mesh decisive: the mesh runner (host ByteTrack) differs from run()")
    check(files["auto", True] == files["device", False],
          "mesh decisive: the mesh runner (the scan) differs from run() with 'device'")
    players = json.loads(files["auto", True]["players.json"])
    print(f"mesh decisive check: {n} frames 1920x1080, rgb, chunk {FUSED_CHUNK}, one NCCL rank: "
          f"caches and data.csv equal to run()'s byte for byte with host ByteTrack and with the "
          f"scan ({sum(map(len, players))} boxes, "
          f"{len({p['id'] for f in players for p in f})} scan IDs; host ByteTrack and the scan "
          f"{'agree' if files['host', True] == files['auto', True] else 'differ'} here)")


def _divergence_rate(host_ids, dev_ids) -> float:
    """The share of detections whose scan ID disagrees with host ByteTrack's
    under the first-seen mapping of scan IDs to host IDs, a detection one
    side dropped counting as a disagreement (tests/test_association_device.py)."""
    mapping: dict[int, int] = {}
    total = mismatch = 0
    for hid, did in zip(host_ids.reshape(-1).tolist(), dev_ids.reshape(-1).tolist()):
        if hid == 0 and did == 0:
            continue
        total += 1
        if hid == 0 or did == 0:
            mismatch += 1
            continue
        mapping.setdefault(did, hid)
        mismatch += mapping[did] != hid
    return mismatch / max(total, 1)


def _scan_measure(calls, dev, smi: str) -> None:
    """The scan on the run's recorded rows: device and host-torch ms a chunk
    (the first pass warms), device launches a chunk (profiled), and the ID
    divergence from host ByteTrack on the same detections."""
    from torch.profiler import ProfilerActivity, profile

    rows = [np.concatenate([b, s[..., None], v[..., None]], -1).astype(np.float32)
            for b, s, v, *_ in calls]

    def scan(device) -> list[np.ndarray]:
        state, out = init_state(device=device), []
        for k, r in enumerate(rows):
            t = torch.from_numpy(r).to(device)
            state, ids = associate_chunk(state, t[..., :4], t[..., 4], t[..., 5] > 0.5,
                                         first=k == 0)
            out.append(ids.cpu().numpy())
        return out

    ms = {}
    for label, device in (("device", dev), ("host", torch.device("cpu"))):
        scan(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = scan(device)
        ms[label] = (time.perf_counter() - t0) / len(rows) * 1e3
        check(all(np.array_equal(a, b[3]) for a, b in zip(ids, calls)),
              f"mesh: the scan on the {label} differs from the run's IDs")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scan(dev)
        torch.cuda.synchronize()
    launches = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    boxes = np.concatenate([c[0] for c in calls])
    scores = np.concatenate([c[1] for c in calls])
    valid = np.concatenate([c[2] for c in calls])
    dev_ids = np.concatenate([c[3] for c in calls])
    bt = ByteTrack(frame_rate=30.0)
    host_ids = np.zeros(valid.shape, np.int64)
    for f in range(len(boxes)):
        keep = valid[f]
        ids_f, kept = bt.update_with_detections(boxes[f][keep], scores[f][keep])
        host_ids[f, np.flatnonzero(keep)[kept]] = ids_f
    print(f"mesh scan ({smi}): {len(rows)} chunks of {rows[0].shape[0]} frames x "
          f"{rows[0].shape[1]} slots, {int(valid.sum())} detections; at the drain "
          f"{np.mean([c[4] for c in calls]) * 1e3:.3f} ms a chunk (upload, scan on "
          f"{calls[0][5]}, download); on the same rows the card "
          f"{ms['device']:.3f} ms a chunk in {launches / len(rows):.0f} device launches a chunk, "
          f"the host's torch {ms['host']:.3f} ms a chunk; ID divergence from host ByteTrack "
          f"{_divergence_rate(host_ids, dev_ids):.4f} ({int((host_ids > 0).sum())} host IDs, "
          f"{int((dev_ids > 0).sum())} scan IDs)")


def _ball_ints(trackers) -> list:
    return [(b.xy, b.visibility) for b in trackers[2].results]


def phase_mesh(mesh, frames, smi: str) -> dict:
    """(b) The full-width reference plan through the mesh runner, (c) run()
    with the device scan, (d) BallTracker(mesh=...). Returns (b)'s first
    pass's launch counts."""
    n = len(frames)
    clip = MemoryClip(frames, fps=30.0)
    blocks = -(-n // (FUSED_CHUNK * mesh.size))
    calls: list = []
    scan_call = fused_mod._Scan.__call__

    def recorded(self, boxes, scores, valid):
        t0 = time.perf_counter()
        ids = scan_call(self, boxes, scores, valid)  # ends in a download: synchronised
        calls.append((boxes, scores, valid, ids, time.perf_counter() - t0, self.device))
        return ids

    fused_mod._Scan.__call__ = recorded
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            trackers = full_width_trackers(tmp)
            calib = {str(t): calibrate_cls_head(t, frames[:8]) for t in trackers[:2]}
            runner = TrackingRunner(list(trackers), clip, tmp / "unused.mp4", fused=True,
                                    fused_chunk=FUSED_CHUNK, render=False, collect_data=True,
                                    mesh=mesh)
            conv3x3.reset_launches()
            heatmap.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            first_s, first_csv = _collect_run(runner, tmp / "data.csv")
            counts = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            check("fused_inference" in runner.stage_times, "mesh: the fused path did not run")
            # det + pose a block; TrackNet a batch of FUSED_CHUNK windows; K2
            # a batch and the shard's first L-1 frames.
            want = {"conv3x3_bn_act": 110 * blocks + 17 * -(-n // FUSED_CHUNK),
                    "heatmap_cc": -(-n // FUSED_CHUNK) + 1}
            check(counts == want, f"mesh: launches {counts}, want {want}")
            for t in trackers:
                check(len(t.results) == n and len(json.loads(t.save_path.read_text())) == n,
                      f"mesh {t}: results and saved cache")
            positions = check_csv(tmp / "data.csv", n)
            first = [_json(t.results) for t in trackers]
            run_calls = len(calls)
            second_s, second_csv = _collect_run(runner, tmp / "data.csv")
            check([_json(t.results) for t in trackers] == first and second_csv == first_csv,
                  "mesh: second pass differs")
            fused_s = runner.stage_times["fused_inference"]
            mesh_ball = _ball_ints(trackers)
            single = TrackingRunner(list(trackers), clip, tmp / "unused.mp4", fused=True,
                                    fused_chunk=FUSED_CHUNK, render=False, collect_data=True)
            _collect_run(single, tmp / "single.csv")
            agree = sum(a == b for a, b in zip(mesh_ball, _ball_ints(trackers)))
            print(f"mesh ({smi}): one NCCL rank, {n} frames 1920x1080, chunk {FUSED_CHUNK}, "
                  f"ingest {runner.fused_ingest}, {_check_players(trackers[0].results)}; "
                  f"{positions} player positions in data.csv; fused + collect "
                  f"{n / first_s:.1f} frames/s first pass, {n / second_s:.1f} second (fused "
                  f"inference {n / fused_s:.1f} frames/s), second equal to the first; ball ints "
                  f"equal to run()'s at {agree} of {n} frames; peak device memory "
                  f"{peak_gib:.2f} GiB; launches {counts}; calibration {calib}")
            _scan_measure(calls[:run_calls], mesh.device, smi)
            runner.restart()
            profile_run(runner.run, "mesh", (("K1", "conv3x3_bn_act"), ("K2", "heatmap_cc")),
                        top_n=8, chunks=blocks, gaps=5)

            # (c) run() with the scan at the drain.
            device_run = TrackingRunner(list(trackers), clip, tmp / "unused.mp4", fused=True,
                                        fused_chunk=FUSED_CHUNK, render=False,
                                        collect_data=True, fused_association="device")
            firsts = _collect_run(device_run, tmp / "device.csv")[0]
            seconds = _collect_run(device_run, tmp / "device.csv")[0]
            check(device_run._fused_pipeline.association == "device", "device run: association")
            print(f"fused device association ({smi}): run() with the scan at the drain, {n} "
                  f"frames 1920x1080, fused + collect {n / firsts:.1f} frames/s first pass, "
                  f"{n / seconds:.1f} second (fused inference "
                  f"{n / device_run.stage_times['fused_inference']:.1f} frames/s)")
    finally:
        fused_mod._Scan.__call__ = scan_call

    # (d) BallTracker(mesh=...): the decisive fake, then full width.
    dn = 45
    dframes = decisive_clip(dn, seed=12)
    balls = []
    for m in (None, mesh):
        ball = _fake_trackers(dn)[2]
        ball.mesh = m
        balls.append(_json(ball.predict_frames(iter(dframes), total_frames=dn)))
    check(balls[0] == balls[1], "mesh ball tracker: the decisive fake's balls differ")
    full = []
    for m in (None, mesh):
        ball = BallTracker(None, config=BallTrackerConfig(), mesh=m)
        ball.video_info_post_init(VideoInfo(width=1920, height=1080, fps=30.0, total_frames=n))
        t0 = time.perf_counter()
        full.append(_json(ball.predict_frames(iter(frames), total_frames=n)))
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
    check(len(full[1]) == n, "mesh ball tracker: results")
    print(f"mesh ball tracker: decisive fake {dn} frames 1080p equal to the single-device "
          f"balls ({sum(b['visibility'] for b in balls[0])} visible); full width, random "
          f"weights: {sum(a == b for a, b in zip(*full))} of {n} frames equal to the "
          f"single-device tracker's ({n / full_s:.1f} frames/s through the mesh, first call)")
    return counts


def _mesh_rank(rank: int, port: int, world: int, out: str) -> None:
    """One rank of --mesh-ranks: NCCL on card `rank`; writes its caches and
    times under `out`."""
    out = Path(out)
    torch.cuda.set_device(rank)
    init_distributed("cuda", rank=rank, world_size=world, timeout_s=300,
                     init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = make_mesh(data=world, device=torch.device("cuda", rank))
        dn = 45
        fakes = _fake_trackers(dn)
        files = _run_files(fakes, MemoryClip(decisive_clip(dn, seed=12), fps=30.0),
                           out / f"decisive{rank}", mesh=mesh)
        frames = synthetic_players(128, seed=9)
        n = len(frames)
        clip = MemoryClip(frames, fps=30.0)
        (out / f"full{rank}").mkdir()
        trackers = full_width_trackers(out / f"full{rank}")
        for t, name in zip(trackers[:2], TRACKER_NAMES):
            t.engine.model.load_state_dict(torch.load(out / f"{name}.pt", map_location="cpu"))
        runner = TrackingRunner(list(trackers), clip, out / "unused.mp4", fused=True,
                                fused_chunk=FUSED_CHUNK, render=False, collect_data=True,
                                mesh=mesh)
        conv3x3.reset_launches()
        heatmap.reset_launches()
        times = [_collect_run(runner, out / f"data{rank}.csv")[0] for _ in range(2)]
        (out / f"rank{rank}.json").write_text(json.dumps({
            "seconds": times, "n": n, "fused_s": runner.stage_times["fused_inference"],
            "launches": [conv3x3.launches, heatmap.launches], "files": sorted(files),
            "decisive": [_json(t.results) for t in fakes],
            "results": [_json(t.results) for t in trackers]}))
    finally:
        torch.distributed.destroy_process_group()


def phase_mesh_cards(world: int, smi: str) -> dict:
    """The mesh over `world` cards, one process each (--mesh-ranks)."""
    check(torch.cuda.device_count() >= world, f"{world} ranks need {world} cards")
    frames = synthetic_players(128, seed=9)
    n = len(frames)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "single").mkdir()
        trackers = full_width_trackers(tmp / "single")
        calib = {str(t): calibrate_cls_head(t, frames[:8]) for t in trackers[:2]}
        for t, name in zip(trackers[:2], TRACKER_NAMES):
            torch.save(t.engine.model.state_dict(), tmp / f"{name}.pt")
        _spawn(_mesh_rank, world, world, str(tmp))
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]
        # The decisive fakes: rank 0's files equal a one-card run()'s with
        # the scan, the other ranks write none; every rank's results equal.
        want = _run_files(_fake_trackers(45), MemoryClip(decisive_clip(45, seed=12), fps=30.0),
                          tmp / "decisive_single", fused_association="device")
        got = {p.name: p.read_bytes() for p in sorted((tmp / "decisive0").iterdir())
               if p.suffix in (".json", ".csv")}
        check(got == want, "mesh ranks: rank 0's decisive files differ from run()'s")
        for r, rec in enumerate(ranks[1:], 1):
            check(rec["files"] == [], f"mesh ranks: rank {r} wrote {rec['files']}")
            check(rec["decisive"] == ranks[0]["decisive"] and rec["results"] == ranks[0]["results"],
                  f"mesh ranks: rank {r}'s results differ from rank 0's")
        # One card on the same clip and weights: run() and run_mesh at one rank.
        single = TrackingRunner(list(trackers), MemoryClip(frames, fps=30.0), tmp / "u.mp4",
                                fused=True, fused_chunk=FUSED_CHUNK, render=False,
                                collect_data=True)
        single_s = [_collect_run(single, tmp / "single.csv")[0] for _ in range(2)]
        agree = sum(a == b for a, b in zip(_ball_ints(trackers),
                                           [(tuple(b["xy"]), b["visibility"])
                                            for b in ranks[0]["results"][2]]))
    print(f"mesh over {world} cards ({smi}): one process a card, NCCL; decisive fakes: rank "
          f"0's caches and data.csv equal to one card's run(), the other ranks' results equal "
          f"and no file written; full width {n} frames "
          f"1920x1080, chunk {FUSED_CHUNK} a rank: fused + collect "
          f"{n / ranks[0]['seconds'][0]:.1f} frames/s first pass, "
          f"{n / ranks[0]['seconds'][1]:.1f} second (fused inference "
          f"{n / ranks[0]['fused_s']:.1f}); every rank's results equal to rank 0's; launches a "
          f"rank (K1, K2, both passes) {[rec['launches'] for rec in ranks]}; one card's run() "
          f"{n / single_s[0]:.1f} / {n / single_s[1]:.1f} frames/s; ball ints equal to run()'s "
          f"at {agree} of {n} frames; calibration {calib}")
    return {"conv3x3_bn_act": ranks[0]["launches"][0], "heatmap_cc": ranks[0]["launches"][1]}



# ----------------------------------------------------------- phase 17: training

#: Adam steps each family takes on its fixed batch, and the warm-up steps the
#: median step time leaves out.
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
#: One step on the card against the same step on the host CPU (fp32, TF32
#: off) and a float64 step on the CPU: the card's loss within 1e-4 of the
#: CPU's (relative), and the card's gradient no farther from the float64
#: gradient than twice the CPU's fp32 gradient is, plus 1e-4 (relative L2
#: over every parameter). The fp32 step of a random-weight network is
#: ill-conditioned whoever computes it (on the CPU the port's and the JAX
#: package's TrackNet gradients differ by 0.7%, each 0.4-0.65% from float64,
#: tests/_torch_train.py; ResNet-50's card and CPU gradients by 2.2%), so
#: the float64 step is the yardstick; the loss is well-conditioned.
CARD_CPU_LOSS_TOL, CARD_F64_RATIO, CARD_F64_FLOOR = 1e-4, 2.0, 1e-4
#: YOLOv8m's and TrackNet's CPU steps take a batch of 2 (8 cores; at 8 each
#: would take about a minute); ResNet-50 and InpaintNet their full batch.
#: The train -> serve check's TrackNet epochs (11 steps each).
SERVE_EPOCHS = 30
#: The train -> serve rally (frames, width, height), the apps' device and the
#: ball tracker's (its default: the card), and its model resolution.
SERVE_CLIP, SERVE_DEVICE, SERVE_HW = (96, 1024, 576), "cuda", (288, 512)
CPU_BATCH = {"yolo_det": 2, "yolo_pose": 2, "tracknet": 2, "court_resnet": 8, "inpaintnet": 32}
TRAIN_FAMILIES = tuple(CPU_BATCH)
#: The families' full widths: YOLOv8m at 640, TrackNet at 288x512, ResNet-50
#: at 224 (the models' own).
YOLO_VARIANT, YOLO_SIZE, TRACKNET_HW, RESNET_SIZE = "m", 640, (288, 512), 224


def yolo_scenes(rng, n: int, size: int, nk: int, max_gt: int = 4):
    """n (size, size, 3) uint8 scenes of 1-`max_gt` bright upright boxes on
    a textured court, and their ultralytics labels: (N, max_gt) classes 0,
    (N, max_gt, 4) cxcywh in [0, 1], (N, max_gt, nk, 3) keypoints (x, y in
    [0, 1], visibility 2) inside each box, (N, max_gt) mask."""
    images = rng.integers(30, 90, (n, size, size, 3), dtype=np.uint8)
    images[..., 2] = np.clip(images[..., 2].astype(int) + 80, 0, 255)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    kpts = np.zeros((n, max_gt, nk, 3), np.float32)
    mask = np.zeros((n, max_gt), bool)
    for i in range(n):
        for j in range(rng.integers(1, max_gt + 1)):
            bw, bh = rng.uniform(0.08, 0.2) * size, rng.uniform(0.2, 0.45) * size
            x0, y0 = rng.uniform(0, size - bw), rng.uniform(0, size - bh)
            images[i, int(y0): int(y0 + bh), int(x0): int(x0 + bw)] = rng.integers(
                150, 255, 3, dtype=np.uint8)
            boxes[i, j] = ((x0 + bw / 2) / size, (y0 + bh / 2) / size, bw / size, bh / size)
            kx, ky = rng.uniform(x0, x0 + bw, nk), rng.uniform(y0, y0 + bh, nk)
            kpts[i, j] = np.stack([kx / size, ky / size, np.full(nk, 2.0)], -1)
            mask[i, j] = True
    return images, np.zeros((n, max_gt), np.int32), boxes, kpts, mask


def _xyxy_px(boxes, size: int) -> np.ndarray:
    b = boxes * size
    return np.concatenate([b[..., :2] - b[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2], -1)


def ball_rally(n: int, w: int, h: int, seed: int):
    """A (h, w) rally clip: a textured court with lines, sensor noise, a
    yellow ball of radius w / 170 on parabolic arcs, absent every 13th
    frame. Returns (frames uint8 list, ground truth (n, 2) px, visibility
    (n,))."""
    rng = np.random.default_rng(seed)
    bg = np.empty((h, w, 3), np.int16)
    bg[:] = (40, 90, 160)
    lw = max(2, w // 200)
    bg[:, w // 6: w // 6 + lw] = bg[:, 5 * w // 6: 5 * w // 6 + lw] = bg[h // 2: h // 2 + lw] = 255
    bg = np.clip(bg + rng.integers(-15, 15, bg.shape), 0, 245).astype(np.uint8)
    r = max(2, w // 170)
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    disk = ys ** 2 + xs ** 2 <= r * r
    frames, gt, vis = [], np.zeros((n, 2), np.float32), np.zeros(n, np.int64)
    for i in range(n):
        f = bg + rng.integers(0, 10, bg.shape, dtype=np.uint8)
        j = i % 40
        cx, cy = int(w * (0.1 + 0.02 * j)), int(h * (0.8 - 0.045 * j + 0.0012 * j * j))
        if i % 13 != 12:
            f[cy - r: cy + r + 1, cx - r: cx + r + 1][disk] = (235, 240, 80)
            gt[i], vis[i] = (cx, cy), 1
        frames.append(f)
    return frames, gt, vis


def _train_family(name: str, rng):
    """(the model with seeded LeCun weights, on the CPU; its fixed full-width
    batch as CPU tensors; loss(model, *batch, targets=None): the train-mode
    forward and loss; the step maker taking the mesh)."""
    if name.startswith("yolo"):
        nk = 13 if name == "yolo_pose" else 0
        model = YOLOv8(YOLO_VARIANT, 1, nk)
        images, labels, boxes, kpts, mask = yolo_scenes(rng, 8, YOLO_SIZE, nk or 1)
        k = kpts.copy()
        k[..., :2] *= YOLO_SIZE
        batch = [torch.from_numpy(images).float() / 255, torch.from_numpy(labels),
                 torch.from_numpy(_xyxy_px(boxes, YOLO_SIZE))]
        batch += [torch.from_numpy(k)] if nk else []
        batch += [torch.from_numpy(mask)]

        def loss(m, *b, targets=None):
            return tyolo.yolo_loss(m, *b, pose=bool(nk), targets=targets)

        step = functools.partial(tyolo.make_yolo_train_step, bool(nk))
    elif name == "tracknet":
        model, _ = make_tracknet(8, "concat")
        frames, gt, vis = ball_rally(15, TRACKNET_HW[1], TRACKNET_HW[0], seed=17)
        clip = tdata.RallyClip(frames=np.stack(frames), coords=gt, visibility=vis.astype(
            np.float32), median=np.median(np.stack(frames), 0).astype(np.uint8))
        batch = list(next(tdata.window_batches(clip, 8, 8, np.random.default_rng(0))))
        loss, step = ttn.tracknet_loss, ttn.make_tracknet_train_step
    elif name == "court_resnet":
        model = ResNet50Regressor(24)
        images = torch.from_numpy(rng.integers(0, 255, (8, RESNET_SIZE, RESNET_SIZE, 3)).astype(
            np.float32))
        batch = [imagenet_normalize(images / 255), torch.from_numpy(
            rng.uniform(0.1, 0.9, (8, 24)).astype(np.float32))]
        loss, step = tcourt.court_loss, tcourt.make_court_train_step
    else:
        model = InpaintNet()
        t = np.arange(400, dtype=np.float32)
        coords = np.stack([960 + 700 * np.sin(t / 40), 540 + 300 * np.cos(t / 23)], -1)
        rally = tdata.synthesize_inpaint_rally(coords, np.ones(400, np.float32), (1920, 1080),
                                               rng, gap_rate=0.1)
        batch = list(next(tdata.coordinate_window_batches(rally, 16, 32, rng)))
        loss, step = tinp.inpaintnet_loss, tinp.make_inpaintnet_train_step
    lecun_normal_(model, torch.Generator().manual_seed(17))
    return model, batch, loss, step


def _grad_rel_l2(a: torch.nn.Module, b: torch.nn.Module) -> tuple[float, float]:
    """(relative L2 error of a's gradient against b's over every parameter,
    the worst tensor's)."""
    num = den = worst = 0.0
    gb = dict(b.named_parameters())
    for k, p in a.named_parameters():
        d2 = float((p.grad.cpu() - gb[k].grad.cpu()).norm()) ** 2
        w2 = float(gb[k].grad.norm()) ** 2
        num, den, worst = num + d2, den + w2, max(worst, (d2 / max(w2, 1e-60)) ** 0.5)
    return (num / den) ** 0.5, worst


def _f64(t: torch.Tensor) -> torch.Tensor:
    return t.double() if t.is_floating_point() else t


def card_vs_cpu_step(dev, name: str, model, batch, loss) -> dict:
    """One forward and backward of `loss` from the same weights on the same
    batch (its first CPU_BATCH rows): on the card and on the host CPU in
    fp32 with TF32 off, and on the CPU in float64 (the models keep their
    own fp32 casts: the heads' outputs, the losses). YOLO's assignment is
    made once, on the CPU model's outputs, and given to all three: the
    card's own differs only where two alignment metrics tie within rounding
    (the count is printed)."""
    n = CPU_BATCH[name]
    cpu_b = [t[:n] for t in batch]
    card_b = [t.to(dev) for t in cpu_b]
    models = {"cpu": copy.deepcopy(model).train(), "card": copy.deepcopy(model).to(dev).train(),
              "f64": copy.deepcopy(model).double().train()}
    inputs = {"cpu": cpu_b, "card": card_b, "f64": [_f64(t) for t in cpu_b]}
    targets, extra = None, ""
    with no_tf32():
        if name.startswith("yolo"):
            gts = cpu_b[1:]
            with torch.no_grad():
                anc, _ = tyolo.anchor_tensors((YOLO_SIZE, YOLO_SIZE), "cpu")
                out = copy.deepcopy(model).train()(cpu_b[0], raw=True)
                out_c = copy.deepcopy(model).to(dev).train()(card_b[0], raw=True)
                targets = tyolo.assign_batch(out["scores"], out["boxes"], anc, gts[0], gts[1],
                                             gts[-1])
                own = tyolo.assign_batch(out_c["scores"], out_c["boxes"], anc.to(dev),
                                         *[card_b[i] for i in (1, 2, len(card_b) - 1)])
            check(int(targets[0].sum()) > 0, f"train {name}: no anchor assigned")
            extra = (f", fg anchors {int(targets[0].sum())}, the card's own assignment differs "
                     f"at {int((own[0].cpu() != targets[0]).sum())}")
        losses = {}
        for k, m in models.items():
            kw = {}
            if targets is not None:
                kw["targets"] = tuple((t.to(dev) if k == "card" else _f64(t) if k == "f64" else t)
                                      for t in targets)
            lk = loss(m, *inputs[k], **kw)
            lk.backward()
            losses[k] = float(lk.detach())
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    card_err, worst = _grad_rel_l2(models["card"], models["f64"])
    cpu_err, _ = _grad_rel_l2(models["cpu"], models["f64"])
    card_cpu, _ = _grad_rel_l2(models["card"], models["cpu"])
    check(math.isfinite(losses["card"]) and loss_rel <= CARD_CPU_LOSS_TOL,
          f"train {name}: card loss {losses['card']} vs CPU {losses['cpu']}")
    check(card_err <= CARD_F64_RATIO * cpu_err + CARD_F64_FLOOR,
          f"train {name}: card gradient {card_err} from float64, the CPU's {cpu_err}")
    print(f"train {name}: one step at batch {n}: loss card {losses['card']:.6f}, CPU "
          f"{losses['cpu']:.6f} (rel {loss_rel:.2e}), float64 {losses['f64']:.6f}; gradient "
          f"rel L2 from float64: card {card_err:.2e} (worst tensor {worst:.2e}), CPU fp32 "
          f"{cpu_err:.2e}; card from CPU {card_cpu:.2e}{extra}")
    return {"loss_rel": loss_rel, "grad_rel_l2_f64": card_err, "cpu_grad_rel_l2_f64": cpu_err,
            "card_cpu_grad_rel_l2": card_cpu}


def phase_train(dev, smi: str) -> dict:
    """17 (a): each family at full width: TRAIN_STEPS Adam steps on its fixed
    batch (finite losses that fall), the median step ms after the warm-up,
    the peak device memory; the card step against the CPU step."""
    rng = np.random.default_rng(17)
    out = {}
    for name in TRAIN_FAMILIES:
        model, batch, loss, step = _train_family(name, rng)
        err = card_vs_cpu_step(dev, name, model, batch, loss)
        state = init_train_state(model.to(dev), 1e-3)
        card_b = [t.to(dev) for t in batch]
        fn = step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, l = fn(state, *card_b)
            losses.append(float(l))  # a download: the step has ended
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(math.isfinite(v) for v in losses), f"train {name}: losses {losses}")
        check(losses[-1] < losses[0], f"train {name}: the loss did not fall: {losses}")
        ms = float(np.median(times[TRAIN_WARMUP:])) * 1e3
        shape = tuple(batch[0].shape)
        print(f"train {name}: batch {shape}, {TRAIN_STEPS} Adam steps, loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}; median step {ms:.1f} ms (steps {TRAIN_WARMUP + 1}-"
              f"{TRAIN_STEPS}), peak device memory {peak:.2f} GiB, fp32 TF32 off; {smi}")
        out[name] = {"step_ms": ms, "peak_gib": peak, **err}
        del state, model, card_b
        torch.cuda.empty_cache()
    return out


def phase_train_mesh(mesh) -> None:
    """17 (b): one YOLOv8m step through the mesh path (an NCCL group of one
    rank: the BatchNorm statistics, the normalizers, the gradients and the
    loss all-reduced) against the no-mesh step from the same weights on the
    same batch: the loss within 1e-5 (relative), the gradient within 1e-3
    (relative L2; cuDNN's and the gather's backward sum in a nondeterministic
    order), the running statistics within 1e-5 of their largest."""
    model, batch, _, _ = _train_family("yolo_det", np.random.default_rng(18))
    b = [t.to(mesh.device) for t in batch]
    states, losses = [], []
    for m in (mesh, None):
        state = init_train_state(copy.deepcopy(model).to(mesh.device), 1e-3)
        state, loss = tyolo.make_yolo_train_step(mesh=m)(state, *b)
        states.append(state)
        losses.append(float(loss))
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    grad_rel, worst = _grad_rel_l2(states[0].model, states[1].model)
    bufs = dict(states[1].model.named_buffers())
    stats = max(float((v - bufs[k]).abs().max()) / max(float(bufs[k].abs().max()), 1e-30)
                for k, v in states[0].model.named_buffers() if "running" in k)
    check(loss_rel <= 1e-5, f"train mesh: loss {losses[0]} vs {losses[1]}")
    check(grad_rel <= 1e-3, f"train mesh: gradient rel L2 {grad_rel}")
    check(stats <= 1e-5, f"train mesh: running statistics {stats}")
    print(f"train mesh: YOLOv8m step through an NCCL group of one rank vs no mesh: loss "
          f"{losses[0]:.6f} vs {losses[1]:.6f} (rel {loss_rel:.2e}), gradient rel L2 "
          f"{grad_rel:.2e} (worst tensor {worst:.2e}), running statistics {stats:.2e}")


def _write_png(path: Path, image: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(str(path), cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
    except ImportError:
        from PIL import Image

        Image.fromarray(image).save(path)


def _write_rally_dir(root: Path, frames, gt, vis) -> None:
    fd = root / "frame" / "r1"
    fd.mkdir(parents=True)
    (root / "csv").mkdir()
    for i, f in enumerate(frames):
        _write_png(fd / f"{i}.png", f)
    rows = ["Frame,X,Y,Visibility"] + [f"{i},{int(g[0])},{int(g[1])},{v}"
                                       for i, (g, v) in enumerate(zip(gt, vis))]
    (root / "csv" / "r1_ball.csv").write_text("\n".join(rows) + "\n")


def _ball_error(tracker, frames, gt, vis, cap: float) -> tuple[float, int]:
    """Mean distance (px) of the tracker's ball from the truth over the
    visible frames, a miss or a distance beyond `cap` counted as `cap`;
    and the frames within 5 px."""
    h, w = frames[0].shape[:2]
    tracker.video_info_post_init(VideoInfo(width=w, height=h, fps=30.0, total_frames=len(frames)))
    with torch.inference_mode():
        tracker.predict_and_update(iter(frames), total_frames=len(frames))
    errs = [min(math.hypot(b.xy[0] - g[0], b.xy[1] - g[1]) if b.visibility else cap, cap)
            for b, g, v in zip(tracker.results, gt, vis) if v]
    return float(np.mean(errs)), sum(e <= 5 for e in errs)


def phase_train_serve(smi: str) -> dict:
    """17 (c): apps.train_tracknet on a synthetic rally directory on the
    card, its .pt served by BallTracker through K1 and K2 with a smaller
    ball error than random weights; apps.train_yolo on synthetic scenes and
    apps.evaluate on its checkpoint through K1."""
    n, w, h = SERVE_CLIP
    frames, gt, vis = ball_rally(n, w, h, seed=19)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _write_rally_dir(root, frames, gt, vis)
        t0 = time.perf_counter()
        check(train_tracknet.main(["--match-dir", str(root), "--rallies", "r1", "--epochs",
                                   str(SERVE_EPOCHS), "--batch", "8", "--device", SERVE_DEVICE,
                                   "--height", str(SERVE_HW[0]), "--width", str(SERVE_HW[1]),
                                   "--out", str(root / "tn.pt")]) == 0, "train_tracknet")
        train_s = time.perf_counter() - t0
        cap = 50.0
        # RGB frames reach TrackNet as they do in training: without the
        # reference's median-buffer channel swap, which would show a model
        # trained on RGB the clip's first 400 frames (all of this one) in BGR.
        cfg = BallTrackerConfig(height=SERVE_HW[0], width=SERVE_HW[1])
        random_err = _ball_error(BallTracker(None, config=cfg, device=SERVE_DEVICE, seed=0,
                                             channel_quirk=False), frames, gt, vis, cap)
        conv3x3.reset_launches()
        heatmap.reset_launches()
        trained = BallTracker(str(root / "tn.pt"), config=cfg, device=SERVE_DEVICE,
                              channel_quirk=False)
        trained_err = _ball_error(trained, frames, gt, vis, cap)
        launches["train_serve"] = {"conv3x3_bn_act": conv3x3.launches,
                                   "heatmap_cc": heatmap.launches}
        chunks = -(-(n + 7) // 8)
        check(conv3x3.launches == 17 * chunks and heatmap.launches >= chunks,
              f"train -> serve: launches {launches['train_serve']}")
        check(trained_err[0] < random_err[0],
              f"train -> serve: ball error {trained_err} not below random weights' {random_err}")
        print(f"train -> serve: apps.train_tracknet {SERVE_EPOCHS} epochs on a {n}-frame {w}x{h} "
              f"rally ({train_s:.1f} s); BallTracker ball error over the {int(vis.sum())} visible "
              f"frames (miss = {cap:.0f} px): random weights {random_err[0]:.2f} px "
              f"({random_err[1]} within 5 px), trained {trained_err[0]:.2f} px "
              f"({trained_err[1]} within 5 px); launches {launches['train_serve']}; {smi}")

        images, labels, boxes, kpts, mask = yolo_scenes(np.random.default_rng(20), 16, YOLO_SIZE, 1)
        (root / "images").mkdir()
        (root / "labels").mkdir()
        for i in range(len(images)):
            _write_png(root / "images" / f"im{i}.png", images[i])
            (root / "labels" / f"im{i}.txt").write_text("".join(
                f"0 {' '.join(f'{v:.5f}' for v in boxes[i, j])}\n" for j in range(4)
                if mask[i, j]))
        data = ["--images", str(root / "images"), "--labels", str(root / "labels"),
                "--imgsz", str(YOLO_SIZE), "--variant", YOLO_VARIANT]
        t0 = time.perf_counter()
        check(train_yolo.main(data + ["--epochs", "3", "--batch", "8", "--device", SERVE_DEVICE,
                                      "--out", str(root / "det.pt")]) == 0, "train_yolo")
        yolo_s = time.perf_counter() - t0
        conv3x3.reset_launches()
        heatmap.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(evaluate.main(data + ["--weights", str(root / "det.pt"), "--conf", "0.01",
                                        "--device", SERVE_DEVICE]) == 0, "evaluate")
        record = json.loads(buf.getvalue().strip().splitlines()[-1])
        launches["evaluate"] = {"conv3x3_bn_act": conv3x3.launches,
                                "heatmap_cc": heatmap.launches}
        check(conv3x3.launches > 0, "evaluate: K1 did not launch")
        check(record["images"] == 16 and 0.0 <= record["map"] <= 1.0, f"evaluate: {record}")
        print(f"train -> evaluate: apps.train_yolo (YOLOv8{YOLO_VARIANT}, 16 scenes at "
              f"{YOLO_SIZE}, 3 epochs of batch "
              f"8, {yolo_s:.1f} s), apps.evaluate through K1 ({conv3x3.launches} launches): "
              f"{json.dumps(record)}")
    return launches


# ------------------------------------------------- phase 18: weights and validation

#: The weights-and-validation rally (1920x1080 frames, four player figures).
VALIDATE_FRAMES = 48
#: validate_weights' court keypoints JSON: COURT_KEYPOINTS with its first two
#: points on COURT_POLYGON's near corners, so that the polygon the app builds
#: (keypoints 0, 1, -1, -2) is the players' gate of the other phases.
VALIDATE_KEYPOINTS = [(200, 1100), (1720, 1100), *COURT_KEYPOINTS[2:]]
#: (name, the convert_weights kind and flags) of each family written in the
#: reference's format and converted to the JAX package's .msgpack and orbax
#: directory.
WEIGHT_FAMILIES = {
    "players": ["yolo", "--variant", "m"],
    "pose": ["yolo", "--variant", "m", "--keypoints", "13"],
    "tracknet": ["tracknet"],
    "inpaintnet": ["inpaintnet"],
    "court_resnet": ["resnet"],
}


def _pt_state_dict(name: str, path: Path) -> dict:
    """The port's state_dict of a reference-format .pt, through the loaders
    its trackers use."""
    from padel_analytics_tpu_torch.models.convert import (
        convert_inpaintnet_checkpoint,
        convert_tracknet_checkpoint,
        load_torch_checkpoint,
    )
    from padel_analytics_tpu_torch.trackers.court_keypoints import _load_resnet
    from padel_analytics_tpu_torch.trackers.players import _load_yolo

    if name in ("players", "pose"):
        return _load_yolo(str(path))
    if name == "court_resnet":
        return _load_resnet(str(path))
    convert = convert_tracknet_checkpoint if name == "tracknet" else convert_inpaintnet_checkpoint
    return convert(load_torch_checkpoint(str(path)))[0]


def write_weights(root: Path, frames) -> dict:
    """18 (a): full-width seeded weights in the reference's formats under
    root/pt (YOLOv8m detect and YOLOv8m-pose with 13 keypoints, their cls
    heads calibrated on `frames`; TrackNet with its param_dict; InpaintNet;
    ResNet-50 under torchvision names; training/checkpoint.py's save_*),
    each converted by apps.convert_weights to root/msgpack/<name>.msgpack
    and to the orbax directory root/orbax/<name> and read back: every tensor
    bit-equal to the .pt's. Returns {name: (pt, msgpack, orbax)} and prints
    the read ms of each format."""
    from padel_analytics_tpu_torch.apps import convert_weights
    from padel_analytics_tpu_torch.models.convert import load_flax_state_dict
    from padel_analytics_tpu_torch.training import checkpoint as tckpt

    for fmt in ("pt", "msgpack", "orbax"):
        (root / fmt).mkdir()
    players = PlayerTracker(None, polygon_zone=PolygonZone(COURT_POLYGON, (1920, 1080)),
                            config=PlayersTrackerConfig())
    pose = PlayerKeypointsTracker(None, config=PlayerKeypointsTrackerConfig())
    calib = {str(t): calibrate_cls_head(t, frames[:8]) for t in (players, pose)}
    models = {
        "players": (tckpt.save_yolov8, players.engine.model),
        "pose": (tckpt.save_yolov8, pose.engine.model),
        "tracknet": (lambda p, m: tckpt.save_tracknet(p, m, 8, "concat"),
                     BallTracker(None, config=BallTrackerConfig()).tracknet.model),
        "inpaintnet": (tckpt.save_inpaintnet,
                       lecun_normal_(InpaintNet(), torch.Generator().manual_seed(23))),
        "court_resnet": (tckpt.save_resnet, lecun_normal_(
            ResNet50Regressor(), torch.Generator().manual_seed(0))),
    }
    paths, reads = {}, {}
    for name, (save, model) in models.items():
        pt, msg = root / "pt" / f"{name}.pt", root / "msgpack" / f"{name}.msgpack"
        orb = root / "orbax" / name
        save(pt, model)
        for out in (msg, orb):
            with contextlib.redirect_stdout(io.StringIO()):
                check(convert_weights.main([WEIGHT_FAMILIES[name][0], str(pt), str(out),
                                            *WEIGHT_FAMILIES[name][1:]]) == 0,
                      f"convert_weights {name} -> {out.name}")
        t0 = time.perf_counter()
        want = _pt_state_dict(name, pt)
        reads[name] = {"pt_ms": round((time.perf_counter() - t0) * 1e3, 1)}
        keys = {k for k in want if not k.endswith("num_batches_tracked")}
        for fmt, path in (("msgpack", msg), ("orbax", orb)):
            t0 = time.perf_counter()
            got = load_flax_state_dict(path)
            reads[name][f"{fmt}_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
            check(keys == {k for k in got if not k.endswith("num_batches_tracked")},
                  f"{name}: the {fmt} names differ from the .pt's")
            bad = [k for k in keys if not torch.equal(got[k], want[k].float())]
            check(not bad, f"{name}: {fmt} tensors differ from the .pt's: {bad[:5]}")
        size = sum(p.stat().st_size for p in orb.rglob("*") if p.is_file())
        paths[name] = (pt, msg, orb)
        reads[name].update({"msgpack_MB": round(msg.stat().st_size / 2**20, 1),
                            "orbax_MB": round(size / 2**20, 1), "tensors": len(keys)})
    print(f"weights (a): five families written in the reference's formats, converted by "
          f"apps.convert_weights to .msgpack and orbax directories (plain layout), read back "
          f"bit-equal; read ms by format (host) {json.dumps(reads)}; calibration {calib}")
    return paths


def _validate_trackers(paths: dict, which: int, cache_dir: Path, batch: int = 8) -> list:
    """The reference plan's four trackers with the written weights (which:
    0 the .pt files, 1 the .msgpack files, 2 the orbax directories), caching
    under cache_dir with validate_weights' reference-cache names."""
    from padel_analytics_tpu_torch.apps.validate_weights import REF_CACHE_NAMES

    def weights(name):
        return str(paths[name][which])

    save = {k: cache_dir / v for k, v in REF_CACHE_NAMES.items()}
    players = PlayerTracker(weights("players"), PolygonZone(COURT_POLYGON, (1920, 1080)),
                            batch_size=batch, save_path=save["players"])
    pose = PlayerKeypointsTracker(weights("pose"), batch_size=batch,
                                  save_path=save["players_keypoints"])
    ball = BallTracker(weights("tracknet"), weights("inpaintnet"),
                       config=BallTrackerConfig(batch_size=batch), save_path=save["ball"])
    return [players, pose, ball, fixed_court(save_path=save["keypoints"])]


def phase_weights_validate(smi: str) -> dict:
    """Phase 18: (a) the weights in the reference's formats, the JAX
    package's .msgpack and its orbax directories; (b) the main path from
    each, caches and data.csv byte-equal, K1 and K2 launched; (c)
    apps.validate_weights against the port's per-tracker caches; (d)
    compare_predictions over (b) and the ball's velocity and hits; (e) the
    committed JAX-written orbax directory through the zstd decoder. Returns
    (b)'s launch counts from the .msgpack ('validate') and orbax
    ('validate_orbax') passes."""
    from padel_analytics_tpu_torch.analytics.velocity_estimator import (
        BallVelocityEstimator,
        ImpactType,
    )
    from padel_analytics_tpu_torch.apps import compare_predictions, validate_weights
    from padel_analytics_tpu_torch.apps.validate_weights import REF_CACHE_NAMES
    from padel_analytics_tpu_torch.trackers.velocity_in_time import detect_hits

    n = VALIDATE_FRAMES
    frames = synthetic_players(n, seed=31)
    clip = MemoryClip(frames, fps=30.0)
    chunks = -(-(n + 7) // FUSED_CHUNK)
    want_k1 = 110 * -(-n // FUSED_CHUNK) + 17 * chunks
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = write_weights(tmp, frames)

        # (b) the main path from the .pt files, the .msgpack files and the
        # orbax directories, passes in turns (pt, msgpack, orbax, orbax,
        # msgpack, pt); the launch counters zeroed before and read after each.
        runners, runs = {}, {}
        for which, fmt in enumerate(("pt", "msgpack", "orbax")):
            cache = tmp / f"run_{fmt}"
            cache.mkdir()
            runners[fmt] = (TrackingRunner(_validate_trackers(paths, which, cache), clip,
                                           tmp / "unused.mp4", fused=True,
                                           fused_chunk=FUSED_CHUNK, render=False,
                                           collect_data=True), cache)
        for fmt in ("pt", "msgpack", "orbax", "orbax", "msgpack", "pt"):
            runner, cache = runners[fmt]
            conv3x3.reset_launches()
            heatmap.reset_launches()
            seconds, csv = _collect_run(runner, cache / "data.csv")
            counts = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
            check("fused_inference" in runner.stage_times, f"weights (b) {fmt}: not fused")
            check(counts == {"conv3x3_bn_act": want_k1, "heatmap_cc": chunks},
                  f"weights (b) {fmt}: launches {counts}, want K1 {want_k1}, K2 {chunks}")
            check(check_csv(cache / "data.csv", n) > 0, f"weights (b) {fmt}: no player in csv")
            files = {k: (cache / v).read_bytes() for k, v in REF_CACHE_NAMES.items()}
            if fmt in runs:
                check(files == runs[fmt]["files"] and csv == runs[fmt]["csv"],
                      f"weights (b) {fmt}: a second pass wrote other files")
                runs[fmt]["fps"].append(n / seconds)
            else:
                runs[fmt] = {"fps": [n / seconds], "csv": csv, "files": files,
                             "counts": counts, "runner": runner}
        for fmt in ("msgpack", "orbax"):
            for kind in REF_CACHE_NAMES:
                check(runs["pt"]["files"][kind] == runs[fmt]["files"][kind],
                      f"weights (b): the {kind} cache from {fmt} differs from the .pt run's")
            check(runs["pt"]["csv"] == runs[fmt]["csv"],
                  f"weights (b): data.csv from {fmt} differs from the .pt run's")
        found = {k: sum(map(len, json.loads(v))) if k != "ball" else
                 sum(b["visibility"] for b in json.loads(v))
                 for k, v in runs["pt"]["files"].items()}
        print(f"weights (b) ({smi}): the main path (fused i420 + collect, reference plan, "
              f"InpaintNet on the ball) on a {n}-frame 1920x1080 rally, passes in turns: from "
              f".pt {' and '.join(f'{v:.1f}' for v in runs['pt']['fps'])} frames/s, from "
              f".msgpack {' and '.join(f'{v:.1f}' for v in runs['msgpack']['fps'])} frames/s, "
              f"from orbax {' and '.join(f'{v:.1f}' for v in runs['orbax']['fps'])} frames/s; "
              f"caches and data.csv byte-equal across all six passes; launches a pass: "
              f".msgpack {runs['msgpack']['counts']}, orbax {runs['orbax']['counts']}; "
              f"found {found}")

        # (d) compare_predictions over (b)'s two runs, the ball's velocity
        # and hits over its results.
        worst = {}
        for kind in REF_CACHE_NAMES:
            stats = compare_predictions.COMPARATORS[kind](
                json.loads(runs["pt"]["files"][kind]), json.loads(runs["msgpack"]["files"][kind]))
            worst[kind] = stats.get("max_px", stats.get("mean_center_px"))
            check(worst[kind] in (0.0, None, math.inf) and stats["frames"] == n,
                  f"weights (d): {kind} {stats}")
        results = {k: t.results.predictions for k, t in runs["msgpack"]["runner"].trackers.items()}
        estimator = BallVelocityEstimator(30.0, results["players_tracker"],
                                          results["ball_tracker"], results["keypoints_tracker"])
        visible = [i for i, b in enumerate(results["ball_tracker"]) if b.visibility]
        t0, t1 = (visible[0], visible[-1]) if len(visible) >= 2 else (0, n - 1)
        t_est = []
        for _ in range(20):
            t = time.perf_counter()
            data, velocity = estimator.estimate_velocity(t0, t1, ImpactType.RACKET, get_Vz=True)
            t_est.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        hits = detect_hits(results["ball_tracker"])
        hits_ms = (time.perf_counter() - t) * 1e3
        check(math.isfinite(velocity.norm), f"weights (d): velocity {velocity}")
        print(f"weights (d): compare_predictions .pt run vs .msgpack run, max px (players: "
              f"mean centre px) {worst}; BallVelocityEstimator frames {t0} -> {t1} "
              f"({len(visible)} visible balls, random weights): {velocity.norm:.3f} m/s "
              f"({velocity}), {float(np.median(t_est)):.3f} ms on the host (median of 20); "
              f"detect_hits over {n} frames: {len(hits)} hits {hits}, {hits_ms:.3f} ms")

        # (c) apps.validate_weights on the same clip and the .pt files. Its
        # reference caches: the per-tracker paths (every batch = the fused
        # chunk) on the frames the fused i420 ingest delivers (the I420
        # round trip done on the host).
        ref = tmp / "ref"
        ref.mkdir()
        rt = [i420_to_rgb(torch.from_numpy(rgb_to_i420(f)), f.shape[0], dtype=torch.uint8).numpy()
              for f in frames]
        kp = np.array(VALIDATE_KEYPOINTS, float)
        check(np.array_equal(np.stack([kp[0], kp[1], kp[-1], kp[-2]]), COURT_POLYGON),
              "weights (c): the keypoints' polygon is not the players' gate")
        trackers = _validate_trackers(paths, 0, ref, batch=FUSED_CHUNK)
        # The fused run takes the ball's median from the source frames
        # (FusedPipeline._gather_setup) and TrackNet's frames from the I420
        # decode: so does the reference, its median computed on the source
        # head and kept for the round-tripped clip (the first-frame
        # fingerprint it is keyed by set to that clip's).
        trackers[2].ensure_median_for_clip(frames[: trackers[2].median_max_sample_num])
        trackers[2]._median_fp = hashlib.sha1(rt[0].tobytes()).hexdigest()
        trackers[3] = KeypointsTracker(fixed_keypoints_detection=Keypoints(
            [Keypoint(id=i, xy=(float(x), float(y))) for i, (x, y) in enumerate(kp)]),
            save_path=ref / REF_CACHE_NAMES["keypoints"])
        per_tracker = TrackingRunner(trackers,
                                     MemoryClip(rt, fps=30.0), tmp / "unused.mp4",
                                     fused=False, render=False, collect_data=False)
        per_tracker.run()
        check("fused_inference" not in per_tracker.stage_times, "weights (c): ref not per-tracker")
        (tmp / "kps.json").write_text(json.dumps(VALIDATE_KEYPOINTS))
        wdir = tmp / "wdir"
        wdir.mkdir()
        for name in ("players", "pose", "tracknet", "inpaintnet"):
            (wdir / validate_weights.WEIGHT_NAMES[name]).symlink_to(paths[name][0])
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = validate_weights.main(
                ["--weights-dir", str(wdir), "--cache-dir", str(ref), "--video", "memory",
                 "--keypoints", str(tmp / "kps.json"), "--out", str(tmp / "report.json"),
                 "--fast-path"], video=clip)
        wall_s = time.perf_counter() - t0
        report = json.loads((tmp / "report.json").read_text())
        check(rc == 0, f"validate_weights exited {rc}")
        check(all(report["weights"][k] for k in ("players", "pose", "tracknet", "inpaintnet")),
              f"validate: weights {report['weights']}")
        per = {k: report[k].get("max_px", report[k].get("mean_center_px"))
               for k in REF_CACHE_NAMES}
        check(report["within_1px_verdict"] is True,
              f"validate: within_1px_verdict {report['within_1px_verdict']}, max px {per}, "
              f"report {json.dumps(report)[:2000]}")
        fast = report["fast_path"]
        fast_px = {k: fast[k].get("max_px", fast[k].get("mean_center_px")) for k in REF_CACHE_NAMES}
        print(f"validate (c) ({smi}): apps.validate_weights on the {n}-frame rally (4 .pt "
              f"weights, fixed court) against the per-tracker paths' caches: "
              f"within_1px_verdict {report['within_1px_verdict']}, max_px_overall "
              f"{report['max_px_overall']}, per tracker (players: mean centre px) {per}; "
              f"--fast-path (derived wire {fast['config']['wire_long_side']}, pose@"
              f"{fast['config']['pose_image_size']}) against this run's reference plan, random "
              f"weights: max_px_vs_parity {fast['max_px_vs_parity']}, per tracker {fast_px}, "
              f"within_bound_verdict (5 px) {fast['within_bound_verdict']}; wall {wall_s:.1f} s "
              "(both plans, models built)")
    phase_orbax_fixture(smi)
    return {"validate": runs["msgpack"]["counts"], "validate_orbax": runs["orbax"]["counts"]}


#: 18 (e): passes of the decoder over the fixture's chunks (0.4 MiB each).
ORBAX_DECODE_REPEATS = 100


def phase_orbax_fixture(smi: str) -> None:
    """18 (e): the committed JAX-written orbax directory
    (tests/data_torch/orbax_jax/: OCDBT, zstd-compressed zarr, a float32
    leaf in a data file, bfloat16, a list), which this host has no orbax to
    write, read through the decoder built here from csrc/zstd_decode.c by
    the host C compiler: every leaf's sha256 equal to the digest file's;
    the decoder's build seconds and its MB/s over the fixture's chunks."""
    from padel_analytics_tpu_torch.core.checkpoint import load_checkpoint

    _build.host_library("zstd_decode")
    build_s = _build.build_log["zstd_decode"]["seconds"]
    tree = load_checkpoint(orbax_cases.FIXTURE)
    got = {k: orbax_cases.digest(v) for k, v in orbax_cases.leaves(tree).items()}
    want = json.loads(orbax_cases.DIGESTS.read_text())
    check(got == want, f"orbax fixture: leaves differ from the digests: "
          f"{sorted(k for k in want if got.get(k) != want[k])}")
    rate = orbax_cases.decoder_rate(orbax_cases.FIXTURE, repeats=ORBAX_DECODE_REPEATS)
    print(f"weights (e) (host of {smi}): the committed JAX-written orbax directory, {len(got)} "
          f"leaves equal to their sha256 digests; zstd decoder built in {build_s:.2f} s "
          f"(cc -O2), the directory read in {rate['load_ms']:.1f} ms, the decoder alone "
          f"{rate['MB_per_s']:.1f} MB/s over {rate['chunks']} chunks "
          f"({rate['decoded_MB']:.1f} MB decoded from {rate['compressed_MB']:.1f} MB)")


# --------------------------------------------------- phase 19: the model axis

#: Phase 19's global batch of each family, cut from phase 17's (YOLOv8m 8,
#: TrackNet 8): under gloo every sharded conv's output is all-gathered and
#: its input gradient all-reduced through the host.
TP_BATCH = {"yolo_det": 2, "yolo_pose": 2, "tracknet": 2, "court_resnet": 8, "inpaintnet": 32}
#: Steps each run times after the compared one (the port's StageTimer).
TP_TIMED = 2
#: A sharded step against the one-process card step from the same weights on
#: the same batch (phase 17 (b)'s bounds): the loss within 1e-5 (relative),
#: the gathered gradient within 1e-3 (relative L2, whole model; cuDNN picks
#: other algorithms for fewer output channels and gloo sums in its own
#: order) or, where it is farther, no farther from a float64 step on the
#: card than twice the one-process step is, plus 1e-4 (phase 17 (a)'s
#: yardstick: the fp32 step of a random-weight TrackNet or ResNet-50 is
#: itself 0.2-2% from float64, PERF.md §6, PR 10; my first chip run of this
#: phase measured TrackNet's sharded and one-process gradients 2.5e-3 apart),
#: the running statistics within 1e-5 of their BatchNorm's largest
#: running variance (a mean near 0 is a sum that cancels: its error scales
#: with the spread, not with itself), and after the Adam step at most 1% of the parameters more than
#: 0.05 lr away (Adam's first step turns a rounding-noise gradient into
#: +-lr).
TP_LOSS_TOL, TP_GRAD_TOL, TP_STATS_TOL, TP_PARAM_LR, TP_PARAM_FRAC = 1e-5, 1e-3, 1e-5, 0.05, 1e-2
TP_F64_RATIO, TP_F64_FLOOR = 2.0, 1e-4
TP_SEED, TP_LR = 19, 1e-3
#: 19 (b): the TP-trained TrackNet's rally (frames, width, height) for one
#: step of 8 windows of 8 frames, and the served clip (phase 17's).
TP_TRAIN_CLIP = (15, 1024, 576)
#: 19 (c): YOLOv8m's global batch over data 2 x model 2 on four cards.
TP_CARDS_BATCH = 8


def _tp_family(name: str, batch: int):
    """(the seeded model, its phase-17 batch cut to `batch` rows, the step
    maker taking the mesh): the same on every process."""
    model, full, _, step = _train_family(name, np.random.default_rng(TP_SEED))
    return model, [t[:batch] for t in full], step


def _state_bytes(state) -> int:
    """This process's bytes of parameters and Adam moments."""
    tensors = list(state.model.parameters()) + [
        t for s in state.optimizer.state.values() for t in s.values()
        if torch.is_tensor(t) and t.dim() > 0]
    return sum(t.numel() * t.element_size() for t in tensors)


def tp_step(name: str, dev, batch: int, mesh=None) -> dict:
    """One Adam step of `name` on its phase-19 batch on `dev`, the model
    sharded over `mesh.model` where given (the batch split over the mesh's
    'data' axis): the loss, the gathered gradient and parameters after the
    step, the buffers (CPU tensors), this process's parameter + Adam bytes;
    then TP_TIMED more steps, timed with the port's StageTimer, and the
    process's peak device memory above what it held before the call."""
    base = torch.cuda.memory_allocated(dev)  # what the process held before
    model, full, step = _tp_family(name, batch)
    rows = slice(None)
    if mesh is not None:
        shard_params_for_tp(model, mesh)
        per = batch // mesh.size
        rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    b = [t[rows].to(dev) for t in full]
    state = init_train_state(model.to(dev), TP_LR)
    fn = step(mesh)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    timer = StageTimer()
    with timer.stage("first") as s:
        state, loss = fn(state, *b)
        s.value = loss
    sharded = {f"{k}.weight" for k, m in model.named_modules() if tp_axis(m) is not None}

    def whole(k, t):
        t = mesh.model.all_gather(t.detach(), 0) if k in sharded else t.detach()
        return t.to("cpu", copy=True)  # a copy: the timed steps go on to change `t`

    out = {"loss": float(loss), "sharded": len(sharded), "bytes": _state_bytes(state),
           "grads": {k: whole(k, p.grad) for k, p in model.named_parameters()},
           "params": {k: whole(k, p) for k, p in model.named_parameters()},
           "buffers": {k: v.detach().to("cpu", copy=True) for k, v in model.named_buffers()}}
    for _ in range(TP_TIMED):
        with timer.stage("step") as s:
            state, s.value = fn(state, *b)
    out["first_ms"] = timer.summary()["first"]["mean_ms"]
    out["step_ms"] = timer.summary()["step"]["mean_ms"]
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    return out


def tp_f64_grads(name: str, dev, batch: int) -> dict:
    """The one-process step's gradient of `name` in float64 on `dev` (the
    models keep their own fp32 casts), as CPU tensors."""
    model, full, step = _tp_family(name, batch)
    model = model.double().to(dev)
    step(None)(init_train_state(model, TP_LR), *[_f64(t).to(dev) for t in full])
    return {k: p.grad.cpu() for k, p in model.named_parameters()}


def _grad_rel(got: dict, want: dict) -> tuple[float, float]:
    """(relative L2 distance of gradient `got` from `want` over every
    parameter, the worst tensor's)."""
    num = den = worst = 0.0
    for k, w in want.items():
        d2, w2 = float((got[k].double() - w.double()).norm()) ** 2, float(w.double().norm()) ** 2
        num, den, worst = num + d2, den + w2, max(worst, (d2 / max(w2, 1e-60)) ** 0.5)
    return (num / den) ** 0.5, worst


def tp_compare(name: str, got: dict, want: dict, what: str, f64) -> dict:
    """`got` (a sharded step's tp_step) against `want` (the one-process
    step's) within phase 19's bounds, `f64()` giving the float64 yardstick
    where the gradients are farther apart than TP_GRAD_TOL; returns the
    errors."""
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    grad, worst = _grad_rel(got["grads"], want["grads"])
    yardstick = None
    if grad > TP_GRAD_TOL:
        ref = f64()
        yardstick = (_grad_rel(got["grads"], ref)[0], _grad_rel(want["grads"], ref)[0])
    bufs = want["buffers"]
    stats = max([float((got["buffers"][k] - v).abs().max())
                 / float(bufs[k.rsplit(".", 1)[0] + ".running_var"].abs().max())
                 for k, v in bufs.items() if ".running_" in k] or [0.0])
    d = torch.cat([((got["params"][k] - w).abs() / TP_LR).reshape(-1)
                   for k, w in want["params"].items()])
    frac = float((d > TP_PARAM_LR).float().mean())
    check(math.isfinite(got["loss"]) and loss_rel <= TP_LOSS_TOL,
          f"{what} {name}: loss {got['loss']} vs {want['loss']}")
    check(grad <= TP_GRAD_TOL or yardstick[0] <= TP_F64_RATIO * yardstick[1] + TP_F64_FLOOR,
          f"{what} {name}: gradient rel L2 {grad}, from float64 {yardstick} (sharded, one "
          "process)")
    check(stats <= TP_STATS_TOL, f"{what} {name}: running statistics {stats}")
    check(frac <= TP_PARAM_FRAC, f"{what} {name}: {frac} of the parameters beyond "
                                 f"{TP_PARAM_LR} lr")
    return {"loss_rel": loss_rel, "grad_rel_l2": grad, "worst_tensor": worst,
            "stats_rel": stats, "param_frac": frac, "f64": yardstick,
            "grad_text": f"gradient rel L2 {grad:.2e} (worst tensor {worst:.2e})" + (
                "" if yardstick is None else f", from a float64 card step {yardstick[0]:.2e} "
                f"against the one-process step's {yardstick[1]:.2e}")}


def _tp_rank(rank: int, port: int, out: str, device: str) -> None:
    """One of phase 19's two ranks, both on `device` (the card), joined by
    gloo (the phase's choice: NCCL refuses two ranks on one card): (a)
    every family's sharded step on a data 1 x model 2 mesh; (b)
    apps.train_tracknet --model-parallel 2 on the rally under `out`/data."""
    out = Path(out)
    dev = torch.device(device)
    os.environ["LOCAL_RANK"] = str(dev.index)  # the apps' device: both ranks on one card
    torch.cuda.set_device(dev)
    init_distributed(dev, backend="gloo", rank=rank, world_size=2, timeout_s=600,
                     init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = make_mesh(data=1, model=2, device=dev)
        for name in TRAIN_FAMILIES:
            torch.save(tp_step(name, dev, TP_BATCH[name], mesh), out / f"{name}{rank}.pt")
            torch.cuda.empty_cache()
        check(train_tracknet.main(_tp_app_argv(out, out / f"tp{rank}.pt")
                                  + ["--model-parallel", "2"]) == 0, "train_tracknet TP")
    finally:
        torch.distributed.destroy_process_group()


def _tp_app_argv(root: Path, dest: Path) -> list[str]:
    """apps.train_tracknet on the card for one step of 8 windows (a
    sharded and a one-process run part within a few free-running Adam
    steps, so one is compared) on the rally under `root`/data."""
    return ["--match-dir", str(root / "data"), "--rallies", "r1", "--epochs", "1", "--batch",
            "8", "--device", SERVE_DEVICE, "--height", str(SERVE_HW[0]), "--width",
            str(SERVE_HW[1]), "--out", str(dest)]


def phase_model_axis(dev, smi: str) -> dict:
    """19 (a) each family's sharded step on two gloo ranks on the card against
    the one-process card step; (b) train_tracknet --model-parallel 2 on the
    card against --model-parallel 1, its .pt served by BallTracker through
    K1 and K2 (launches counted)."""
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        frames, gt, vis = ball_rally(*TP_TRAIN_CLIP, seed=21)
        _write_rally_dir(tmp / "data", frames, gt, vis)
        t0 = time.perf_counter()
        _spawn(_tp_rank, 2, str(tmp), str(dev))
        ranks_s = time.perf_counter() - t0
        for name in TRAIN_FAMILIES:
            want = tp_step(name, dev, TP_BATCH[name])
            got = [torch.load(tmp / f"{name}{r}.pt") for r in (0, 1)]
            err = tp_compare(name, got[0], want, "model axis",
                             lambda: tp_f64_grads(name, dev, TP_BATCH[name]))
            check(got[1]["loss"] == got[0]["loss"], f"model axis {name}: the ranks' losses")
            apart = max(float((got[1]["params"][k] - v).abs().max())
                        for k, v in got[0]["params"].items()) / TP_LR
            print(f"model axis {name}: batch {TP_BATCH[name]}, data 1 x model 2, gloo on "
                  f"one card; {got[0]['sharded']} weights sharded; loss {got[0]['loss']:.6f} "
                  f"vs one process {want['loss']:.6f} (rel {err['loss_rel']:.2e}), "
                  f"{err['grad_text']}, running statistics {err['stats_rel']:.2e}, "
                  f"parameters beyond {TP_PARAM_LR} lr {err['param_frac']:.2e}, the ranks' "
                  f"parameters "
                  f"{apart:.2e} lr apart; step ms (gloo staging through the host, not TP "
                  f"on the card) first {got[0]['first_ms']:.1f}, then {got[0]['step_ms']:.1f} "
                  f"/ {got[1]['step_ms']:.1f} (ranks 0 / 1) vs one process "
                  f"{want['step_ms']:.1f}; peak memory a rank {got[0]['peak_gib']:.2f} / "
                  f"{got[1]['peak_gib']:.2f} GiB vs {want['peak_gib']:.2f}; parameters + "
                  f"Adam a rank {got[0]['bytes'] / 2**20:.1f} MiB vs unsharded "
                  f"{want['bytes'] / 2**20:.1f} MiB ({got[0]['bytes'] / want['bytes']:.3f}); "
                  f"{smi}")
            torch.cuda.empty_cache()
        check(not (tmp / "tp1.pt").exists(), "model axis: rank 1 wrote the checkpoint")
        check(train_tracknet.main(_tp_app_argv(tmp, tmp / "one.pt")) == 0, "train_tracknet")
        got, want = (load_for_resume("tracknet", tmp / f) for f in ("tp0.pt", "one.pt"))
        weights = [k for k in want if want[k].is_floating_point() and "running" not in k]
        d = torch.cat([((got[k] - want[k]).abs() / TP_LR).reshape(-1) for k in weights])
        frac = float((d > TP_PARAM_LR).float().mean())
        stats = max(float((got[k] - want[k]).abs().max())
                    / float(want[k.rsplit(".", 1)[0] + ".running_var"].abs().max())
                    for k in want if ".running_" in k)
        check(frac <= TP_PARAM_FRAC and stats <= TP_STATS_TOL,
              f"train_tracknet --model-parallel 2: {frac} beyond {TP_PARAM_LR} lr, "
              f"statistics {stats}")
        n, w, h = SERVE_CLIP
        clip, clip_gt, clip_vis = ball_rally(n, w, h, seed=19)
        cfg = BallTrackerConfig(height=SERVE_HW[0], width=SERVE_HW[1])
        conv3x3.reset_launches()
        heatmap.reset_launches()
        served = BallTracker(str(tmp / "tp0.pt"), config=cfg, device=SERVE_DEVICE,
                             channel_quirk=False)
        err = _ball_error(served, clip, clip_gt, clip_vis, 50.0)
        launches = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
        chunks = -(-(n + 7) // 8)
        check(conv3x3.launches == 17 * chunks and heatmap.launches >= chunks,
              f"model axis -> serve: launches {launches}")
        check(all(math.isfinite(b.xy[0]) and math.isfinite(b.xy[1]) for b in served.results),
              "model axis -> serve: non-finite ball")
    print(f"model axis -> serve: apps.train_tracknet --model-parallel 2 (two gloo ranks on "
          f"the card, one step of 8 windows at {SERVE_HW[0]}x{SERVE_HW[1]}) against "
          f"--model-parallel 1: {frac:.2e} of the parameters beyond {TP_PARAM_LR} lr, running "
          f"statistics {stats:.2e}; the two ranks' phase {ranks_s:.1f} s; its .pt served by "
          f"BallTracker on {n} frames {w}x{h}: launches {launches}, ball error {err[0]:.2f} px "
          f"(miss = 50 px, {err[1]} within 5 px); {smi}")
    return launches


def _tp_card_rank(rank: int, port: int, world: int, out: str) -> None:
    """One rank of 19 (c): NCCL on card `rank`, a data world/2 x model 2
    mesh, one YOLOv8m step."""
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    init_distributed(dev, rank=rank, world_size=world, timeout_s=600,
                     init_method=f"tcp://127.0.0.1:{port}")
    try:
        mesh = make_mesh(data=world // 2, model=2, device=dev)
        torch.save(tp_step("yolo_det", dev, TP_CARDS_BATCH, mesh), Path(out) / f"r{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def phase_model_axis_cards(world: int, smi: str) -> None:
    """19 (c): one YOLOv8m step at data world/2 x model 2 over NCCL, one
    process a card, against the one-card step."""
    check(torch.cuda.device_count() >= world and world % 2 == 0,
          f"the model axis over {world} ranks needs {world} cards, an even number")
    with tempfile.TemporaryDirectory() as tmp:
        _spawn(_tp_card_rank, world, world, tmp)
        got = [torch.load(Path(tmp) / f"r{r}.pt") for r in range(world)]
    want = tp_step("yolo_det", torch.device("cuda", 0), TP_CARDS_BATCH)
    err = tp_compare("yolo_det", got[0], want, f"model axis over {world} cards",
                     lambda: tp_f64_grads("yolo_det", torch.device("cuda", 0), TP_CARDS_BATCH))
    for r in range(1, world):
        check(got[r]["loss"] == got[0]["loss"], f"model axis over {world} cards: rank {r}'s loss")
    print(f"model axis over {world} cards ({smi}): YOLOv8m, batch {TP_CARDS_BATCH}, data "
          f"{world // 2} x model 2, NCCL; loss {got[0]['loss']:.6f} vs one card "
          f"{want['loss']:.6f} (rel {err['loss_rel']:.2e}), {err['grad_text']}, running "
          f"statistics {err['stats_rel']:.2e}, parameters beyond {TP_PARAM_LR} lr "
          f"{err['param_frac']:.2e}; step ms {[round(g['step_ms'], 1) for g in got]} vs one "
          f"card {want['step_ms']:.1f}; peak GiB a rank {[round(g['peak_gib'], 2) for g in got]} "
          f"vs {want['peak_gib']:.2f}; parameters + Adam a rank {got[0]['bytes'] / 2**20:.1f} "
          f"MiB vs {want['bytes'] / 2**20:.1f}")


# ------------------------------------------- phase 20: the training and quality harness

#: The JAX tests' budgets (tests/test_convergence_demo.py) but the stride
#: demo's: TrackNet (steps, frames), the stride demo's, InpaintNet's and
#: YOLOv8n's steps. The stride demo takes 120 steps, not 60: from the port's
#: seeded start its nonoverlap row reached 0.875 within 4 px at 60 steps
#: (the bound is 0.9), 1.0 at 120.
TOOLS_TRACKNET, TOOLS_STRIDE = (60, 72), (120, 96)
TOOLS_INPAINT_STEPS, TOOLS_YOLO_STEPS = 600, 150
#: derived_quality's (det, pose) steps at scale 1 and at scale 5, half
#: production (source 960x540, wire 480, pose 640 -> 320, det letterbox 320).
#: Both take 300, not the JAX test's 150 and 200: from the port's seeded
#: start 150 detector steps left the parity config at 0.31 detect rate at
#: scale 1 and 0.375 at scale 5 (the bound is 0.3), 300 at 0.63-1.0; 200
#: pose steps left pose@half's match rate at 0.375 on the card (the bound is
#: 0.4), and at 0.28-0.42 on the CPU from three seeds, 300 at 0.52-0.99.
DERIVED_STEPS = {1: (300, 300), 5: (300, 300)}
#: The demos' TrackNet (48x80, seq_len 8) and its batches: one window a call
#: in the convergence evaluation, 8 in BallTracker and the fused pipeline.
TOOLS_HW, TOOLS_SEQ = (48, 80), 8
#: Where the trained TrackNet and YOLOv8n are kept for later reuse.
TOOLS_WEIGHTS = _build.BUILD_DIR / "tools"


def _tool_launches() -> dict:
    return {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}


def _reset_tool_launches() -> None:
    conv3x3.reset_launches()
    heatmap.reset_launches()


def _k1_check(dev, g, cin: int, cout: int, h: int, w: int, act: str, batch: int) -> float:
    """K1 at one shape on random operands against its plain version, within
    phase 3's bound (2 bf16 ulp + 1e-3); returns the max abs error."""
    x = torch.randn((batch, h, w, cin), device=dev, generator=g).to(torch.bfloat16)
    wt = torch.randn((3, 3, cin, cout), device=dev, generator=g) / math.sqrt(9 * cin)
    scale = torch.rand(cout, device=dev, generator=g) + 0.5
    bias = torch.randn(cout, device=dev, generator=g) * 0.1
    got = conv3x3.conv3x3_bn_act_packed(x, conv3x3.pack_weight(wt), scale, bias, act)
    ref = conv3x3.conv3x3_bn_act_plain(x.float(), wt.to(torch.bfloat16).float(), scale, bias, act)
    err = (got.float() - ref).abs()
    check(bool(torch.all(err <= K1_RTOL * ref.abs() + K1_ATOL)),
          f"K1 {cin}->{cout} @{h}x{w} B={batch} {act} beyond its bf16 bound "
          f"(max err {float(err.max())})")
    return float(err.max())


def tools_k1_shapes(dev) -> float:
    """Every K1 shape the demos launch (traced from the models on the meta
    device at each input and batch the demos serve), checked against the
    plain version; returns the largest error."""
    from padel_analytics_tpu_torch.tools.derived_quality import Geometry

    tracknet, in_dim = make_tracknet(TOOLS_SEQ, "concat")
    det, pose = YOLOv8("n", 1), YOLOv8("n", 1, 13)
    calls = [("TrackNet", tracknet, TOOLS_HW, in_dim, "relu", (1, 8)),
             ("YOLOv8n detect", det, (64, 64), 3, "silu", (8,))]
    for scale in (1, 5):
        geo = Geometry.at(scale)
        lb = resize.letterbox_plan(geo.src_hw, geo.det)
        calls.append(("YOLOv8n detect", det, (lb.out_h, lb.out_w), 3, "silu", (8,)))
        for size in (geo.pose_full, geo.pose_fast):
            calls.append(("YOLOv8n-pose", pose, (size, size), 3, "silu", (8,)))
    g = torch.Generator(device=dev).manual_seed(20)
    seen, worst, lines = set(), 0.0, []
    for label, model, hw, cin, act, batches in calls:
        shapes = k1_call_shapes(model, *hw, cin)
        new = 0
        for batch in batches:
            for s in shapes:
                if (s, act, batch) not in seen:
                    seen.add((s, act, batch))
                    worst = max(worst, _k1_check(dev, g, *s, act, batch))
                    new += 1
        lines.append(f"{label} @{hw[0]}x{hw[1]} B={'/'.join(map(str, batches))}: {len(shapes)} "
                     f"launches a forward, {new} new shapes")
    print(f"tools K1: {len(seen)} (shape, act, batch) within the bf16 bound of the plain "
          f"version, max abs err {worst:.3g}; " + "; ".join(lines))
    return worst


def tools_k2(dev, model) -> None:
    """K2 at 48x80 bit-equal to the plain version at both cluster sizes
    (the plan's choice printed): blobs with an empty map and a tie, uniform
    masks, and the trained TrackNet's own heatmaps of one window."""
    h, w = TOOLS_HW
    plans = {c: heatmap.cc_plan(h, w, c) for c in heatmap.CLUSTER_SIZES}
    rng = np.random.default_rng(20)
    ys, xs = np.mgrid[0:h, 0:w]
    blobs = np.zeros((TOOLS_SEQ, h, w), np.float32)
    for i in range(TOOLS_SEQ - 2):
        for _ in range(rng.integers(1, 4)):
            cy, cx, s = rng.integers(2, h - 2), rng.integers(2, w - 2), rng.uniform(1.0, 4.0)
            blobs[i] += np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
    blobs[-1, 5:8, 5:8] = blobs[-1, 30:33, 60:63] = 1.0  # equal areas (the tie); [-2] empty
    x = torch.from_numpy(np.concatenate(
        [np.full((h, w, 3), 45.0)] + [rng.uniform(40, 60, (h, w, 3)) for _ in range(TOOLS_SEQ)],
        -1)[None].astype(np.float32) / 255).to(dev, torch.bfloat16)
    with torch.no_grad():
        model.eval()
        trained = model(x)[0].permute(2, 0, 1).float()
        model.train()
    for name, hms in (("blobs (empty map and tie included)", torch.from_numpy(blobs).to(dev)),
                      ("uniform mask 50%", torch.from_numpy(
                          (rng.random((TOOLS_SEQ, h, w)) < 0.5).astype(np.float32)).to(dev)),
                      ("the trained TrackNet's heatmaps", trained)):
        _k2_case(f"{name} (tools)", hms, plans)
    print(f"K2 plan's cluster size at {h}x{w}: {heatmap.cc_plan(h, w).cluster}")


def _derived_invariants(grid: dict) -> None:
    """The five invariants of tests/test_derived_quality.py at scale 1."""
    parity, fast = grid["parity"], grid["fast"]
    dfp, half = grid["derived_fullpose"], grid["i420_halfpose"]
    check(parity["kpt_px"] < 10.0 and parity["detect_rate"] >= 0.3
          and parity["pose_match_rate"] >= 0.9, f"derived: parity does not localize: {parity}")
    check(dfp["kpt_px"] <= parity["kpt_px"] + 2.0 and dfp["pose_match_rate"] >= 0.9,
          f"derived: the derived ingest costs pose: {parity} vs {dfp}")
    check(fast["detect_rate"] >= parity["detect_rate"] - 0.25
          and fast["mean_iou"] >= parity["mean_iou"] - 0.10,
          f"derived: detection cost beyond its bound: {parity} vs {fast}")
    check(fast["pose_match_rate"] >= 0.4 and fast["kpt_px"] <= parity["kpt_px"] + 10.0,
          f"derived: pose@half cost beyond its bound: {parity} vs {fast}")
    check(abs(fast["kpt_px"] - half["kpt_px"]) <= 3.0
          and abs(fast["pose_match_rate"] - half["pose_match_rate"]) <= 0.15
          and half["detect_rate"] == parity["detect_rate"],
          f"derived: the axes interact: {fast} vs {half}, {parity}")


def _fmt(d: dict) -> str:
    return "{" + ", ".join(f"{k} {v:.4f}" for k, v in d.items()) + "}"


def _tools_convergence(dev) -> dict:
    """TrackNet convergence: 9 windows of 8, each 17 K1 launches and one K2,
    before and after training; K2 at 48x80 on the trained model after."""
    from padel_analytics_tpu_torch.tools import convergence

    steps, n = TOOLS_TRACKNET
    _reset_tool_launches()
    out = convergence.run_demo(steps=steps, n=n, device=dev, verbose=False)
    launches = _tool_launches()
    b, a, losses = out["before"], out["after"], out["losses"]
    cpu = convergence.evaluate(copy.deepcopy(out["model"]).cpu(), out["clip"], TOOLS_SEQ)
    print(f"tools convergence: TrackNet {TOOLS_HW[0]}x{TOOLS_HW[1]}, {steps} steps on {n} frames "
          f"({out['step_ms']:.2f} ms a step, {out['wall_s']:.1f} s): before {_fmt(b)}; after, "
          f"bf16 on the card {_fmt(a)}, fp32 on the CPU {_fmt(cpu)}; loss first-5 "
          f"{np.mean(losses[:5]):.5f} -> last-5 {np.mean(losses[-5:]):.5f}; launches {launches}")
    windows = n // TOOLS_SEQ
    check(launches == {"conv3x3_bn_act": 2 * 17 * windows, "heatmap_cc": 2 * windows},
          f"tools convergence: launches {launches}")
    check(a["within_4px"] >= 0.8 and a["mean_px"] < b["mean_px"] / 3
          and np.mean(losses[-5:]) < np.mean(losses[:5]) / 10,
          f"tools convergence: not converged: {b} -> {a}")
    save_tracknet(TOOLS_WEIGHTS / "tracknet_48x80.pt", out["model"], TOOLS_SEQ)
    tools_k2(dev, out["model"])
    return launches


def _tools_stride(dev) -> dict:
    from padel_analytics_tpu_torch.tools import stride_quality

    steps, n = TOOLS_STRIDE
    _reset_tool_launches()
    out = stride_quality.run_demo(steps=steps, n=n, device=dev, verbose=False)
    launches = _tool_launches()
    r1, r8 = out["stride1"], out["nonoverlap"]
    cpu_model = copy.deepcopy(out["model"]).cpu()
    c1, c8 = (stride_quality._tracker_eval(out["clip"], cpu_model, s, TOOLS_SEQ, *TOOLS_HW)
              for s in (1, TOOLS_SEQ))
    print(f"tools stride: {steps} steps on {n} frames ({out['step_ms']:.2f} ms a step, "
          f"{out['wall_s']:.1f} s); BallTracker bf16 stride 1 {_fmt(r1)}, nonoverlap {_fmt(r8)}; "
          f"fp32 on the CPU stride 1 {_fmt(c1)}, nonoverlap {_fmt(c8)}; launches {launches}")
    check(min(launches.values()) > 0, "tools stride: a kernel did not launch")
    check(r1["within_4px"] >= 0.9 and r8["within_4px"] >= 0.9
          and r8["mean_px"] <= r1["mean_px"] + 2.0, f"tools stride: beyond the bounds: {r1}, {r8}")
    return launches


def _tools_inpaint(dev) -> dict:
    from padel_analytics_tpu_torch.tools import inpaint_convergence

    _reset_tool_launches()
    out = inpaint_convergence.run_demo(steps=TOOLS_INPAINT_STEPS, device=dev, verbose=False)
    launches = _tool_launches()
    cpu = inpaint_convergence.masked_px_error(copy.deepcopy(out["model"]).cpu(), out["eval_rally"])
    print(f"tools inpaint: InpaintNet {TOOLS_INPAINT_STEPS} steps ({out['step_ms']:.2f} ms a step, "
          f"{out['wall_s']:.1f} s): masked px error before {out['before_px']:.2f}, after bf16 on "
          f"the card {out['after_px']:.2f}, fp32 on the CPU {cpu:.2f}; launches {launches} (no "
          f"kernel on this path)")
    check(out["before_px"] > 180 and out["after_px"] < 120
          and out["after_px"] < out["before_px"] / 3,
          f"tools inpaint: not converged: {out['before_px']} -> {out['after_px']}")
    return launches


def _tools_yolo(dev) -> dict:
    from padel_analytics_tpu_torch.tools import yolo_convergence

    _reset_tool_launches()
    out = yolo_convergence.run_demo(steps=TOOLS_YOLO_STEPS, device=dev, verbose=False)
    launches = _tool_launches()
    b, a, losses = out["before"], out["after"], out["losses"]
    per_forward = len(k1_call_shapes(YOLOv8("n", 1), *yolo_convergence.HW))
    cpu = yolo_convergence.evaluate_map(copy.deepcopy(out["model"]).cpu(), *out["eval"])
    print(f"tools yolo: YOLOv8n detect 64x64, {TOOLS_YOLO_STEPS} steps ({out['step_ms']:.2f} ms a "
          f"step, {out['wall_s']:.1f} s): before {_fmt(b)}; after, bf16 on the card {_fmt(a)}, "
          f"fp32 on the CPU {_fmt(cpu)}; loss first-5 {np.mean(losses[:5]):.3f} -> last-5 "
          f"{np.mean(losses[-5:]):.3f}; launches {launches}")
    check(launches["conv3x3_bn_act"] == 2 * per_forward,
          f"tools yolo: K1 launches {launches}, {per_forward} a forward")
    check(b["map50"] < 0.2 and a["map50"] >= 0.6
          and np.mean(losses[-5:]) < np.mean(losses[:5]) / 3,
          f"tools yolo: not converged: {b} -> {a}")
    save_yolov8(TOOLS_WEIGHTS / "yolov8n_det_64.pt", out["model"])
    return launches


def _tools_derived(dev, scale: int) -> dict:
    """derived_quality at `scale` with every config; at scale 1 the five
    invariants and the parity and fast configs served in fp32 on the CPU
    beside, at scale 5 the parity config held to localize."""
    from padel_analytics_tpu_torch.tools import derived_quality as dq

    det_steps, pose_steps = DERIVED_STEPS[scale]
    _reset_tool_launches()
    out = dq.run_demo(det_steps=det_steps, pose_steps=pose_steps, isolate=True, scale=scale,
                      device=dev, verbose=False)
    launches = _tool_launches()
    grid, geo = out["grid"], out["geometry"]
    print(f"tools derived scale {scale} (source {geo.src_hw[1]}x{geo.src_hw[0]}, wire "
          f"{geo.wire}, pose {geo.pose_full} -> {geo.pose_fast}, det letterbox {geo.det}): "
          f"det {det_steps} steps ({out['det_step_ms']:.2f} ms a step, final loss "
          f"{out['det_loss']:.3f}), pose {pose_steps} ({out['pose_step_ms']:.2f} ms, "
          f"{out['pose_loss']:.3f}), {out['wall_s']:.1f} s; launches {launches}")
    for name, row in grid.items():
        print(f"  {name} bf16 on the card: {_fmt(row)}")
    check(min(launches.values()) > 0, f"tools derived scale {scale}: a kernel did not launch")
    if scale == 1:
        cpu = dq.serve_grid(copy.deepcopy(out["det"]).cpu(), copy.deepcopy(out["pose"]).cpu(),
                            geo, out["eval"], dq.eval_jobs(geo))
        for name, row in cpu.items():
            print(f"  {name} fp32 on the CPU: {_fmt(row)}")
        _derived_invariants(grid)
    else:
        parity = grid["parity"]
        check(parity["detect_rate"] >= 0.3 and parity["pose_match_rate"] >= 0.9,
              f"tools derived scale {scale}: the parity config does not localize: {parity}")
    return launches


#: Phase 20's demos, each in a process of its own: they are bound by the
#: host's kernel launches (the card is mostly idle), so they run side by
#: side, on two CPU threads each.
TOOLS_JOBS = {
    "tools_convergence": _tools_convergence,
    "tools_stride": _tools_stride,
    "tools_inpaint": _tools_inpaint,
    "tools_yolo": _tools_yolo,
    "tools_derived_scale1": functools.partial(_tools_derived, scale=1),
    "tools_derived_scale5": functools.partial(_tools_derived, scale=5),
}


def _tools_job(rank: int, port: int, out: str) -> None:
    """One of TOOLS_JOBS on the card: its printed lines, its launches and
    any failure's traceback written to out/<name>.json for the parent to
    print; a failure then raises on (the process exits non-zero)."""
    import traceback

    name = list(TOOLS_JOBS)[rank]
    torch.set_num_threads(2)
    buf, rec = io.StringIO(), {}
    try:
        with contextlib.redirect_stdout(buf):
            rec["launches"] = TOOLS_JOBS[name](torch.device("cuda", 0))
    except BaseException:
        rec["error"] = traceback.format_exc()
        raise
    finally:
        rec["log"] = buf.getvalue()
        Path(out, f"{name}.json").write_text(json.dumps(rec))


def phase_tools(smi: str) -> dict:
    """20: the training and quality harness (padel_analytics_tpu_torch/tools)
    on the card. The demos (TOOLS_JOBS) run in processes of their own while
    this one checks (d): the scene digests against the CPU's and every K1
    shape of the demos; each demo's process zeroes the launch counters
    before it and reads them after it (training launches neither kernel:
    train-mode ConvBN is F.conv2d, so the counts are its served passes'),
    holds its bounds and keeps its weights (f). Then every demo's lines are
    printed in TOOLS_JOBS' order, and a failed demo or check raises."""
    from padel_analytics_tpu_torch.tools._common import require_cv2

    t0 = time.perf_counter()
    cv2 = require_cv2()
    TOOLS_WEIGHTS.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        procs = _start(_tools_job, len(TOOLS_JOBS), tmp)
        try:
            digests = tools_cases.scene_digests()
            max_err = tools_k1_shapes(torch.device("cuda", 0))
        finally:
            codes = _wait(procs, timeout=600)
        recs = {}
        for name in TOOLS_JOBS:
            path = Path(tmp, f"{name}.json")
            recs[name] = json.loads(path.read_text()) if path.exists() else {
                "log": "", "error": "the process wrote no record"}
    differ = {k: v for k, v in digests.items() if v != tools_cases.SCENE_DIGESTS[k]}
    check(not differ, f"tools: scene digests differ from the CPU's: {differ}")
    print(f"tools: the {len(digests)} scene digests equal the CPU's (cv2 {cv2.__version__}, "
          f"numpy {np.__version__})")
    for name, rec in recs.items():
        print(rec["log"], end="")
    for (name, rec), code in zip(recs.items(), codes):
        check(code == 0 and "error" not in rec, f"{name}: exit code {code}; {rec.get('error')}")
    print(f"tools: phase 20 took {time.perf_counter() - t0:.1f} s, its {len(TOOLS_JOBS)} demos "
          f"side by side; {smi}")
    return {"launches_by_path": {name: rec["launches"] for name, rec in recs.items()},
            "max_abs_err": max_err}

# ------------------------------------------------ phase 21: the staged path

#: 21 (a)'s (chunk, superchunk) pairs on the 45-frame clip: 32 and 24 frames
#: a round, neither a divisor of the clip and its ball tail.
STAGED_DECISIVE = ((16, 2), (8, 3))
#: 21 (c)'s superchunks at full width (the JAX package's default is 16).
STAGED_SUPERCHUNKS = (4, 16)
STAGED_PASSES = 3  # timed passes a path, the median reported


def phase_staged_decisive() -> None:
    """21 (a): run_staged against run() with phase 9's decisive fakes (and a
    12-keypoint cell detector as the yolo court) on a 45-frame 1920x1080
    clip, for each STAGED_DECISIVE (chunk, superchunk), each ingest,
    ball_stride 8, the yolo court and the device association: every cache
    equal frame by frame, and each lane one graph replay a round."""
    n = 45
    frames = decisive_clip(n, seed=12)
    players, pose, ball, fixed = _fake_trackers(n)
    yolo = court_tracker("yolo", batch=FUSED_CHUNK)
    yolo.engine.model = CellDetector(pose=True, nk=12)
    yolo.video_info_post_init(players.video_info)
    cases = {"rgb": {}, "i420": {"ingest": "i420"},
             "derived": {"ingest": "derived", "wire_long_side": WIRE_LONG_SIDE},
             "ball_stride 8": {"ball_stride": 8}, "yolo court": {},
             "association device": {"association": "device"}}
    t0 = time.perf_counter()
    for chunk, superchunk in STAGED_DECISIVE:
        for name, kwargs in cases.items():
            court = yolo if name == "yolo court" else fixed
            kwargs = {"chunk": chunk, "ingest": "rgb", **kwargs}
            players.restart()  # ByteTrack afresh for each run
            want = FusedPipeline(players, pose, ball, court, **kwargs).run(iter(frames), n)
            players.restart()
            pipe = FusedPipeline(players, pose, ball, court, **kwargs)
            got = pipe.run_staged(iter(frames), n, superchunk=superchunk)
            what = f"staged decisive {name}, chunk {chunk} x {superchunk}"
            check(sorted(got) == sorted(want), f"{what}: keys {sorted(got)}")
            for key in want:
                a, b = _json(got[key]), _json(want[key])
                bad = [f for f in range(n) if f >= len(a) or a[f] != b[f]]
                check(len(a) == n and not bad, f"{what}: {key} differs from run() at frames "
                                               f"{bad[:10]} ({len(a)} results)")
            lanes = ("det", "pose", "ball") + (("court",) if court is yolo else ())
            rounds = -(-(n + pipe._ball_off) // (chunk * superchunk))
            replays = pipe.last_staged_graphs["replays"]
            check(replays == dict.fromkeys(lanes, rounds),
                  f"{what}: graph replays {replays}, want {rounds} a lane")
    print(f"staged decisive check: {len(cases) * len(STAGED_DECISIVE)} runs of {n} frames "
          f"1920x1080 ({', '.join(cases)}; chunk x superchunk "
          f"{', '.join(f'{c} x {s}' for c, s in STAGED_DECISIVE)}) equal to run() frame by "
          f"frame, one graph replay a lane a round; {time.perf_counter() - t0:.1f} s")


def phase_staged_weights() -> None:
    """21 (b): the full TrackNet (288x512, bf16, random weights) on the ball
    beside the decisive fakes: its predictor bias raised in place between
    two run_staged calls lights every pixel; the last ConvBN's BatchNorm
    scale zeroed (folded into K1's epilogue: a stale graph would replay the
    old one) lights none. Each change must change the ball and recapture
    the ball lane; each restore must restore it."""
    n = 45
    frames = decisive_clip(n, seed=12)
    players, pose, _, court = _fake_trackers(n)
    ball = BallTracker(None, config=BallTrackerConfig())
    ball.video_info_post_init(players.video_info)
    model = ball.tracknet.model
    pipe = FusedPipeline(players, pose, ball, court, chunk=FUSED_CHUNK)

    def staged() -> list:
        return _json(pipe.run_staged(iter(frames), n, superchunk=2)["ball"])

    first = staged()
    seen = []
    for label, param, change in (("predictor bias +50", model.predictor.bias,
                                  lambda t: t.add_(50.0)),
                                 ("up_block_3.conv_2 BN scale 0", model.up_block_3.conv_2.bn.weight,
                                  lambda t: t.zero_())):
        saved = param.detach().clone()
        with torch.no_grad():
            change(param)
        changed = staged()
        captured = pipe.last_staged_graphs["captured"]
        with torch.no_grad():
            param.copy_(saved)
        restored = staged()
        visible = sum(b["visibility"] for b in changed)
        check(changed != first and captured == 2,
              f"staged weights: {label} left the ball as it was ({captured} graphs captured)")
        check(restored == first, f"staged weights: restoring {label} did not restore the ball")
        seen.append(f"{label}: {sum(a != b for a, b in zip(changed, first))} of {n} balls "
                    f"changed ({visible} visible), the ball lane's 2 graphs recaptured")
    print(f"staged weights (TrackNet 288x512 bf16, chunk {FUSED_CHUNK} x 2): "
          f"{sum(b['visibility'] for b in first)} visible at first; " + "; ".join(seen)
          + "; each restore gave the first ball back")


def _staged_counts(n: int, superchunk: int) -> dict:
    """The K1 and K2 launches the design implies for one pass over n frames:
    run() (superchunk 0) skips det and pose on the chunks of the ball's tail
    alone; a staged round runs every sub-step on each of its chunks."""
    chunks = -(-(n + 7) // FUSED_CHUNK)
    if not superchunk:
        return {"K1": 110 * -(-n // FUSED_CHUNK) + 17 * chunks, "K2": chunks}
    staged = superchunk * -(-(n + 7) // (FUSED_CHUNK * superchunk))
    return {"K1": 127 * staged, "K2": staged}


def phase_staged(frames, smi: str) -> dict:
    """21 (c): the reference plan at full width through TrackingRunner(
    fused=True, fused_staged=S) for S in STAGED_SUPERCHUNKS beside run() (S =
    0), all on phase 10's trackers and clip at the default i420 ingest: the
    caches against run()'s (every difference named), the median frames/s of
    STAGED_PASSES passes, a profiled pass (busy share, K1 and K2 executions
    against the design's counts, graph launches), capture s, the loop's host
    split, pinned host bytes, peak device memory."""
    n = len(frames)
    clip = MemoryClip(frames, fps=30.0)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        trackers = full_width_trackers(Path(tmp))
        for t in trackers[:2]:
            calibrate_cls_head(t, frames[:8])
        want = None
        for s in (0,) + STAGED_SUPERCHUNKS:
            label = f"staged S={s}" if s else "staged run()"
            runner = TrackingRunner(list(trackers), clip, tmp, fused=True,
                                    fused_chunk=FUSED_CHUNK, fused_staged=s, render=False,
                                    collect_data=False)
            torch.cuda.reset_peak_memory_stats()
            conv3x3.reset_launches()
            heatmap.reset_launches()
            first_s = _fused_pass(runner, trackers)
            wrapper = {"K1": conv3x3.launches, "K2": heatmap.launches}
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            got = [_json(t.results) for t in trackers]
            pipe = runner._fused_pipeline
            first_graphs = dict(pipe.last_staged_graphs) if s else None
            if s:
                # The wrappers count the warm-up chunk and the capture of each
                # graph the first pass captured (one a lane and parity); the
                # replays pass them by.
                parities = first_graphs["captured"] // 3
                want_wrapper = {"K1": 127 * (s + 1) * parities, "K2": (s + 1) * parities}
            else:
                want_wrapper = _staged_counts(n, 0)
            check(wrapper == want_wrapper, f"{label}: the wrappers counted {wrapper} in the first "
                                           f"pass, want {want_wrapper}")
            if want is None:
                want = got
            diffs = {name: [f for f in range(n) if a[f] != b[f]][:10]
                     for name, a, b in zip(TRACKER_NAMES, got, want)}
            diffs = {k: v for k, v in diffs.items() if v}
            check(not diffs, f"{label}: caches differ from run()'s at frames {diffs}")
            times = sorted(_fused_pass(runner, trackers) for _ in range(STAGED_PASSES))
            check([_json(t.results) for t in trackers] == want, f"{label}: a later pass differs")
            fps = n / times[len(times) // 2]
            runner.restart()
            want_n = _staged_counts(n, s)
            prof = profile_run(runner.run, label, (("K1", "conv3x3_bn_act"), ("K2", "heatmap_cc")),
                               chunks=want_n["K2"], gaps=3)
            seen = prof.get("kernel_n", {})
            check(seen == want_n, f"{label}: the profiler counted {seen}, the design {want_n}")
            busy = prof["busy_ms"] / prof["wall_ms"]
            rec = {"fps": fps, "first_pass_fps": n / first_s, "busy": busy, "counts": seen,
                   "k1_ms_a_chunk": prof["kernel_ms"]["K1"] / want_n["K2"],
                   "k2_ms_a_chunk": prof["kernel_ms"]["K2"] / want_n["K2"],
                   "graph_launches": prof["graph_launches"], "peak_gib": peak_gib}
            line = (f"{label}: {n} frames 1920x1080 i420, chunk {FUSED_CHUNK}: {fps:.1f} frames/s "
                    f"(median of {STAGED_PASSES}; first pass {n / first_s:.1f}); profiled busy "
                    f"{100 * busy:.1f}%, K1 {seen['K1']} and K2 {seen['K2']} executions (design "
                    f"{want_n}), {prof['graph_launches']} graph launches; peak device memory "
                    f"{peak_gib:.2f} GiB")
            if s:
                graphs, split = pipe.last_staged_graphs, pipe.last_staged_split
                rounds = want_n["K2"] // s
                check(prof["graph_launches"] == 3 * rounds,
                      f"{label}: {prof['graph_launches']} graph launches, want 3 a round")
                rec.update(capture_s=first_graphs["capture_s"], split=split,
                           pinned_bytes=graphs["pinned_bytes"])
                line += (f"; first pass captured {first_graphs['captured']} graphs in "
                         f"{first_graphs['capture_s'] * 1e3:.1f} ms (the wrappers counted "
                         f"{wrapper} there: warm-up and capture); pinned host "
                         f"{graphs['pinned_bytes'] / 2**20:.1f} MiB; the profiled pass's host "
                         f"split (s) " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
            out[s] = rec
            print(line + f"; {smi}")
    return out


def phase_fast_tracknet(dev, k1: dict) -> dict:
    """21 (d): FastTrackNet over the Flax tree of the full TrackNet (random
    weights from seed 0) at 288x512, batch 16, bf16: 17 K1 launches a
    forward; equal to the TrackNet module's own K1 stacks followed by the
    same fp32 predictor, and within the JAX package's bf16 bound (2e-2) of
    the module's output (whose predictor rounds its logits to bf16); against
    its plain version on the card (every conv the plain fp32 conv of the
    same bf16 operands) within that bound too; timed beside the plain
    version. The kernels line's entry."""
    from padel_analytics_tpu_torch.models import FastTrackNet
    from padel_analytics_tpu_torch.models import tracknet_fast
    from padel_analytics_tpu_torch.models.convert import flax_from_state_dict
    from padel_analytics_tpu_torch.models.layers import max_pool_2x2, upsample_nearest_2x

    model, in_dim = make_tracknet(8, "concat")
    he_normal_(model, 30)
    tree = _to_dev(flax_from_state_dict(model.state_dict()), dev)
    model.to(dev).eval()
    x = torch.rand((FUSED_CHUNK, 288, 512, in_dim), generator=torch.Generator().manual_seed(31))
    x = x.to(dev, torch.bfloat16)
    fast = FastTrackNet(8, torch.bfloat16, dev)
    with torch.inference_mode():
        conv3x3.reset_launches()
        got = fast.apply(tree, x)
        torch.cuda.synchronize()
        launches = conv3x3.launches
        x1 = model.down_block_1(x)
        x2 = model.down_block_2(max_pool_2x2(x1))
        x3 = model.down_block_3(max_pool_2x2(x2))
        y = model.bottleneck(max_pool_2x2(x3))
        y = model.up_block_3(model.up_block_2(model.up_block_1(y, x3), x2), x1)
        w = model.predictor.weight.to(torch.bfloat16).float()
        with no_tf32():
            logits = F.conv2d(y.float().permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
        want = torch.sigmoid(logits + model.predictor.bias.float())
        module_err = float((got - model(x)).abs().max())
        kernel_conv = tracknet_fast.conv3x3_bn_act
        tracknet_fast.conv3x3_bn_act = conv3x3.conv3x3_bn_act_plain
        try:
            plain = fast.apply(tree, x)
            plain_ms = cuda_time_ms(lambda: fast.apply(tree, x), reps=3)
        finally:
            tracknet_fast.conv3x3_bn_act = kernel_conv
        ms = cuda_time_ms(lambda: fast.apply(tree, x))
    plain_err = float((got - plain).abs().max())
    check(launches == 17, f"FastTrackNet: {launches} K1 launches a forward, want 17")
    check(got.shape == (FUSED_CHUNK, 288, 512, 8) and bool(torch.isfinite(got).all()),
          f"FastTrackNet: output {tuple(got.shape)}")
    check(torch.equal(got, want), "FastTrackNet differs from TrackNet's stacks + fp32 predictor")
    check(module_err < 2e-2 and plain_err < 2e-2,
          f"FastTrackNet: {module_err} from the module, {plain_err} from the plain version")
    convs = k1["sums"][f"b{FUSED_CHUNK}"]["tracknet_288x512"]
    print(f"FastTrackNet 288x512 B={FUSED_CHUNK} bf16: {launches} K1 launches a forward; equal to "
          f"the TrackNet module's stacks + the fp32 predictor; max abs {module_err:.3g} from the "
          f"module's output (its logits rounded to bf16), {plain_err:.3g} from the plain version; "
          f"{ms:.3f} ms a forward (folds and packs the tree each call), plain {plain_ms:.3f} ms, "
          f"the 17 convs' bound {convs['bound_ms']:.3f} ms ({convs['bound_by']})")
    return {"name": "fast_tracknet", "route": "cuda",
            "source": "padel_analytics_tpu_torch/models/tracknet_fast.py (K1: "
                      "padel_analytics_tpu_torch/csrc/conv3x3_bn_act.cu)",
            "replaces": "padel_analytics_tpu/ops/pallas_conv.py:211 (through "
                        "padel_analytics_tpu/models/tracknet_fast.py)",
            "launches": launches, "max_abs_err": plain_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": convs["bound_ms"], "bound_by": convs["bound_by"], "library_ms": None,
            "timed_per": f"one forward, B={FUSED_CHUNK} windows at 288x512, the tree on the card"}


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return torch.from_numpy(tree).to(dev)


def staged_kernel_entries(k1: dict, k2: dict, staged: dict) -> list[dict]:
    """The kernels line's staged_* entries: K1 and K2 as the staged main path
    (TrackingRunner(fused_staged=16)) runs them, their executions counted by
    the profiler (a graph replay does not pass through the wrappers'
    counters) and their device ms a chunk from its profiled pass; the plain,
    bound and library times are phase 3's and 4's for the same chunk."""
    rec = staged[STAGED_SUPERCHUNKS[-1]]
    out = []
    for k, key, name in ((k1, "k1_ms_a_chunk", "K1"), (k2, "k2_ms_a_chunk", "K2")):
        out.append({"name": f"staged_{k['name']}", "route": "cuda", "source": k["source"],
                    "replaces": k["replaces"], "launches": rec["counts"][name],
                    "max_abs_err": k["max_abs_err"], "ms": rec[key], "plain_ms": k["plain_ms"],
                    "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                    "library_ms": k["library_ms"],
                    "timed_per": f"device ms a chunk of {FUSED_CHUNK} in the profiled staged pass "
                                 f"(superchunk {STAGED_SUPERCHUNKS[-1]})"})
    return out


# -------------------------------------------- phase 22: the JAX call forms


def _counting_inpaintnet_forwards() -> list:
    """A list that gains an entry at every InpaintNet forward from now on."""
    calls: list = []
    real = InpaintNet.forward

    def forward(self, *args, **kwargs):
        calls.append(1)
        return real(self, *args, **kwargs)

    InpaintNet.forward = forward
    return calls


def phase_ball_no_inpaint(want: dict) -> dict:
    """(a): BallTracker(use_inpaintnet=False) with an InpaintNet checkpoint,
    per tracker and fused. Returns the per-tracker pass's launches."""
    n = 64
    frames = synthetic_rally(n, seed=6)
    info = VideoInfo(width=1920, height=1080, fps=30.0, total_frames=n)
    real_forward = InpaintNet.forward
    forwards = _counting_inpaintnet_forwards()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            inpaint = str(write_inpaint_checkpoint(tmp))

            def ball(name: str, **kwargs) -> BallTracker:
                # No device argument: the entry point's default is the card.
                t = BallTracker(None, save_path=tmp / f"{name}.json", seed=0, **kwargs)
                t.video_info_post_init(info)
                return t

            off = ball("off", config=BallTrackerConfig(inpainting_model_path=inpaint),
                       use_inpaintnet=False)
            none = ball("none", config=BallTrackerConfig())
            check(off.inpaintnet is None, "use_inpaintnet=False built an InpaintNet")
            conv3x3.reset_launches()
            heatmap.reset_launches()
            t0 = time.perf_counter()
            off.predict_and_update(iter(frames), total_frames=n)
            off.save_predictions()
            off_s = time.perf_counter() - t0
            launches = {"conv3x3_bn_act": conv3x3.launches, "heatmap_cc": heatmap.launches}
            check(launches == want, f"ball without InpaintNet: launches {launches} != {want}")
            none.predict_and_update(iter(frames), total_frames=n)
            none.save_predictions()
            check((tmp / "off.json").read_bytes() == (tmp / "none.json").read_bytes(),
                  "use_inpaintnet=False: the cache differs from the path-less tracker's")
            check(not forwards, f"use_inpaintnet=False ran {len(forwards)} InpaintNet forwards")
            on = ball("on", config=BallTrackerConfig(inpainting_model_path=inpaint))
            on.predict_and_update(iter(frames), total_frames=n)
            check(len(forwards) > 0, "the control (use_inpaintnet=True) ran no InpaintNet")
            control = len(forwards)

            players, pose, _, court = full_width_trackers(tmp)
            calibrate_cls_head(players, frames[:8])
            calibrate_cls_head(pose, frames[:8])
            fused = {}
            for name, tracker in (("off", off), ("none", none)):
                runner = TrackingRunner([players, pose, tracker, court], MemoryClip(frames, 30.0),
                                        tmp, fused=True, fused_chunk=FUSED_CHUNK, render=False,
                                        collect_data=False)
                fused_s = _fused_pass(runner, (players, pose, tracker, court))
                fused[name] = [_json(t.results) for t in (players, pose, tracker, court)]
            check(fused["off"] == fused["none"],
                  "fused, use_inpaintnet=False: the caches differ from the path-less run's")
            streamed = []
            players.restart()
            FusedPipeline(players, pose, off, court, chunk=FUSED_CHUNK).run(
                iter(frames), n, stream=lambda *new: streamed.append(len(new[2])))
            check(sum(streamed) == n and len(streamed) > 1,
                  f"fused, use_inpaintnet=False: streamed {streamed}, not the clip's {n} balls")
            check(len(forwards) == control, "InpaintNet ran in the fused runs")
    finally:
        InpaintNet.forward = real_forward
    print(f"entry points (a): use_inpaintnet=False on {n} frames 1920x1080: "
          f"{n / off_s:.1f} frames/s (first pass), launches {launches}, cache byte-equal to no "
          f"inpaint path, 0 InpaintNet forwards (the flag on: {control}); fused "
          f"{n / fused_s:.1f} frames/s (second run), caches equal, streamed in {len(streamed)} "
          "calls")
    return launches


def phase_load_target(frames, want: dict) -> dict:
    """(b): a full-width YOLOv8m detector through load_checkpoint(target,
    path) from .msgpack and from an orbax directory, served through the
    players path. Returns the orbax-served pass's launches."""
    from padel_analytics_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
    from padel_analytics_tpu_torch.models.convert import (
        flax_from_state_dict,
        state_dict_from_flax,
    )

    n = len(frames)
    info = VideoInfo(width=1920, height=1080, fps=30.0, total_frames=n)
    polygon = PolygonZone(COURT_POLYGON, (1920, 1080))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        source = PlayerTracker(None, polygon_zone=polygon, config=PlayersTrackerConfig())
        calibrate_cls_head(source, frames[:8])
        tree = flax_from_state_dict(source.engine.model.state_dict())
        target = flax_from_state_dict(PlayerTracker(
            None, polygon_zone=polygon, config=PlayersTrackerConfig(), seed=1
        ).engine.model.state_dict())
        paths = {"msgpack": tmp / "det.msgpack", "orbax": tmp / "det_orbax"}
        for path in paths.values():
            save_checkpoint(tree, path)

        def serve(name: str, model_path=None, state_dict=None) -> tuple[bytes, dict]:
            save = tmp / f"{name}.json"
            t = PlayerTracker(None, polygon_zone=polygon, save_path=save,
                              config=PlayersTrackerConfig(model_path=model_path))
            if state_dict is not None:
                t.engine.model.load_state_dict(state_dict)
            t.video_info_post_init(info)
            conv3x3.reset_launches()
            t.predict_and_update(iter(frames), total_frames=n)
            t.save_predictions()
            return save.read_bytes(), {"conv3x3_bn_act": conv3x3.launches,
                                       "heatmap_cc": heatmap.launches}

        want_bytes, _ = serve("one_argument", model_path=str(paths["msgpack"]))
        load_ms = {}
        for fmt, path in paths.items():
            t0 = time.perf_counter()
            restored = load_checkpoint(target, path)
            load_ms[fmt] = (time.perf_counter() - t0) * 1e3
            heatmap.reset_launches()
            got, launches = serve(fmt, state_dict=state_dict_from_flax(restored))
            check(got == want_bytes, f"load_checkpoint(target, {fmt}): the cache differs")
            want_launches = {"conv3x3_bn_act": want["conv3x3_bn_act"], "heatmap_cc": 0}
            check(launches == want_launches,
                  f"load_checkpoint(target, {fmt}): launches {launches} != {want_launches}")
        boxes = sum(len(p) for p in json.loads(want_bytes))
        check(boxes > 0, "load_checkpoint(target, path): the served detector found no player")
    print(f"entry points (b): YOLOv8m detect through load_checkpoint(target, path): read "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in load_ms.items())
          + f"; {n} frames served from each, caches byte-equal to the one-argument load's "
            f"({boxes} boxes); launches {launches} a pass")
    return launches


def phase_entry_points(ball_launches: dict, players_launches: dict, smi: str) -> dict:
    t0 = time.perf_counter()
    out = {"ball_no_inpaint": phase_ball_no_inpaint(ball_launches),
           "load_target": phase_load_target(synthetic_players(64, seed=9), players_launches)}
    print(f"entry points: phase 22 took {time.perf_counter() - t0:.1f} s on {smi}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels need one")
    dev = torch.device("cuda", 0)
    smi = phase_report()
    phase_build()
    if "--mesh-ranks" in sys.argv:
        world = int(sys.argv[sys.argv.index("--mesh-ranks") + 1])
        if "--model-axis-only" not in sys.argv:
            phase_mesh_cards(world, smi)
        phase_model_axis_cards(world, smi)
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return
    timed: dict = {}
    k1 = phase_k1(dev, timed)
    k1["sums"]["fast"] = phase_fast_k1(dev, timed, k1)
    k1["sums"]["court"] = phase_court_k1(dev, timed, k1)
    k2 = phase_k2(dev)
    phase_model(dev)
    by_path = {"ball": phase_slice()}
    frames = synthetic_players(64, seed=9)
    by_path["players"] = phase_players(frames)
    by_path["pose"] = phase_pose(frames)
    phase_fused_decisive()
    by_path["fused"] = phase_fused(synthetic_players(128, seed=9))
    phase_collect_decisive()
    by_path["collect"] = phase_collect(synthetic_players(128, seed=9), smi)
    by_path["cli"] = phase_cli()
    fast_frames = synthetic_players(128, seed=9)
    phase_banded(dev, fast_frames)
    phase_area(fast_frames)
    phase_fast_decisive()
    fast = phase_fast(fast_frames, smi)
    by_path.update({k: {name: v[name] for name in ("conv3x3_bn_act", "heatmap_cc")}
                    for k, v in fast.items()})
    phase_court_decisive()
    by_path.update(phase_court(synthetic_players(128, seed=9), smi))
    init_distributed("cuda", rank=0, world_size=1, timeout_s=300,
                     init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        mesh = make_mesh(data=1, device=dev)
        phase_mesh_decisive(mesh)
        by_path["mesh"] = phase_mesh(mesh, synthetic_players(128, seed=9), smi)
        phase_train_mesh(mesh)
    finally:
        torch.distributed.destroy_process_group()
    phase_train(dev, smi)
    by_path.update(phase_train_serve(smi))
    by_path.update(phase_weights_validate(smi))
    by_path["model_axis"] = phase_model_axis(dev, smi)
    tools = phase_tools(smi)
    by_path.update(tools["launches_by_path"])
    k1["max_abs_err"] = max(k1["max_abs_err"], tools["max_abs_err"])
    t0 = time.perf_counter()
    phase_staged_decisive()
    phase_staged_weights()
    staged = phase_staged(synthetic_players(128, seed=9), smi)
    fast_tracknet = phase_fast_tracknet(dev, k1)
    print(f"staged: phase 21 took {time.perf_counter() - t0:.1f} s")
    by_path.update(phase_entry_points(by_path["ball"], by_path["players"], smi))
    # Device ms a chunk from the profiled fast passes; null where the
    # profiler saw no launch of the kernel (not measured, never 0).
    for k, name in ((k1, "K1"), (k2, "K2")):
        k["fast_device_ms_a_chunk"] = {
            p: v["device_ms"][name] / v["chunks"] if name in v["device_ms"] else None
            for p, v in fast.items()}
    # The main path is the fused pipeline with the collect pass: its
    # launches are the kernels'.
    for k, name in ((k1, "conv3x3_bn_act"), (k2, "heatmap_cc")):
        k["launches"] = by_path["collect"][name]
        k["launches_by_path"] = {p: v[name] for p, v in by_path.items()}
    print(smi)
    print(json.dumps({"kernels": [k1, k2, *staged_kernel_entries(k1, k2, staged),
                                  fast_tracknet]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
