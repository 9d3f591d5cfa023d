"""Pipe-fed video encoder child: imports cv2 and numpy only.

Run by path, not with -m: ``python .../encoder_worker.py``, so that it
imports nothing of the package (and no torch). The parent,
`utils.video.SubprocessVideoWriter`, streams raw RGB frames over stdin;
this process converts and encodes them (cv2 mp4v), overlapping the
parent's work.

stdin protocol (little-endian):
  b'O' u16 path_len path_utf8 f64 fps u32 w u32 h   open a writer
  b'F' <w*h*3 raw RGB bytes>                        encode one frame
  b'C'                                              release; ack b'K' on stdout
  b'Q'                                              exit 0

The parent's release() waits for the 'C' ack, so an encode backlog is paid
inside the parent's timing.
"""

from __future__ import annotations

import struct
import sys


def main() -> int:
    import cv2
    import numpy as np

    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    writer = None
    frame_bytes = 0
    w = h = 0

    def read_exact(n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            c = stdin.read(n - got)
            if not c:
                return b""
            chunks.append(c)
            got += len(c)
        return b"".join(chunks)

    while True:
        t = stdin.read(1)
        if not t or t == b"Q":
            if writer is not None:
                writer.release()
            return 0
        if t == b"O":
            (plen,) = struct.unpack("<H", read_exact(2))
            path = read_exact(plen).decode("utf-8")
            fps, w, h = struct.unpack("<dII", read_exact(16))
            frame_bytes = w * h * 3
            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        elif t == b"F":
            data = read_exact(frame_bytes)
            if len(data) < frame_bytes:
                return 1
            frame = np.frombuffer(data, np.uint8).reshape(h, w, 3)
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        elif t == b"C":
            if writer is not None:
                writer.release()
                writer = None
            stdout.write(b"K")
            stdout.flush()
        else:
            return 2


if __name__ == "__main__":
    sys.exit(main())
