"""The training and quality harness: convergence and quality demos that
train small models on synthetic scenes with known truth and serve the
trained weights through the port's own inference paths.

Counterpart of the JAX package's repository-level ``tools/*_demo.py`` (which
stay the reference):

- `convergence`: TrackNet learns a synthetic rally; decoded ball positions
  before and after training (``tools/convergence_demo.py``);
- `stride_quality`: the same trained TrackNet through BallTracker at window
  stride 1 and in the nonoverlap mode (``tools/stride_quality_demo.py``);
- `inpaint_convergence`: InpaintNet learns to fill gaps of held-out
  trajectories (``tools/inpaint_convergence_demo.py``);
- `yolo_convergence`: YOLOv8n detect learns synthetic scenes, mAP@0.5
  before and after (``tools/yolo_convergence_demo.py``);
- `derived_quality`: YOLOv8n detect and pose trained on synthetic players,
  served through FusedPipeline at the reference plan and the fast plan
  (``tools/derived_quality_demo.py``).

Each runs as ``python -m padel_analytics_tpu_torch.tools.<name>`` with
``--device {cuda,cpu}`` (cuda by default). Training runs in fp32 (TF32 off)
from Flax's truncated LeCun normal (the JAX demos' init) drawn from torch
seed 0, or from given initial weights; serving runs in bf16 on the card
(kernels K1 and K2) and in fp32 on the CPU. The scenes are drawn with
OpenCV, imported when a scene is made.
"""
