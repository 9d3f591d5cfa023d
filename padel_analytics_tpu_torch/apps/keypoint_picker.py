"""Court-keypoint click tool (the reference's ui.py).

    python -m padel_analytics_tpu_torch.apps.keypoint_picker <video> [out.json]

Opens the first frame in an OpenCV window; left clicks append (x, y); any
key exits and writes the JSON list. Counterpart of
``padel_analytics_tpu/apps/keypoint_picker.py``.
"""

from __future__ import annotations

import json
import sys

from ..utils.video import read_video


def pick_keypoints(img_rgb, window: str = "image") -> list[tuple[int, int]]:
    """Interactive click loop over an RGB frame: left clicks append (x, y)
    with a label drawn on the image; any key exits. Shared by this tool and
    the CLI's fallback when no keypoints JSON is given."""
    import cv2

    img = cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR)
    keypoints: list[tuple[int, int]] = []

    def click_event(event, x, y, flags, params):
        if event == cv2.EVENT_LBUTTONDOWN:
            keypoints.append((x, y))
            cv2.putText(img, f"{x},{y}", (x, y), cv2.FONT_HERSHEY_SIMPLEX, 1, (255, 0, 0), 2)
            cv2.imshow(window, img)

    cv2.imshow(window, img)
    cv2.setMouseCallback(window, click_event)
    cv2.waitKey(0)
    cv2.destroyAllWindows()
    return keypoints


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: keypoint_picker <video> [out.json]")
        return 2
    video_path = argv[0]
    out_path = argv[1] if len(argv) > 1 else "source_keypoints.json"
    frames, _, _, _ = read_video(video_path, max_frames=1)
    keypoints = pick_keypoints(frames[0])
    with open(out_path, "w") as f:
        json.dump(keypoints, f)
    print(f"wrote {len(keypoints)} keypoints to {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
