"""Per-frame metrics as JSONL (port of optixpathtracer_tpu/utils/logging.py).

The original writes fps rows to a hard-coded 'data.tsv' (sutil.cpp:758-773)
and sv3 appends `i, stateUpdate, render, display, cursorX, cursorY` rows
(HelloPathtracing_sv3/main.cpp:348-383). `FrameLog` writes those columns
(and any extras) as one JSON object per frame with the reference's keys,
and keeps a windowed fps for `display_stats`; `Timer` splits wall time.
"""
from __future__ import annotations

import json
import time
from typing import IO, Any


class FrameLog:
    """Append-only JSONL metrics writer + windowed fps aggregation."""

    def __init__(self, path: str | None = None, window_s: float = 0.5):
        self._f: IO | None = open(path, "a") if path else None
        self._window_s = window_s
        self._win_start = time.perf_counter()
        self._win_frames = 0
        self.frame_index = 0
        self.fps = 0.0

    def log_frame(self, state_update_s: float = 0.0, render_s: float = 0.0,
                  display_s: float = 0.0, cursor=(0, 0), **extra: Any) -> None:
        """One row per frame (sv3 main.cpp:348-373 columns + extras)."""
        row = dict(
            i=self.frame_index,
            state_update_s=round(state_update_s, 6),
            render_s=round(render_s, 6),
            display_s=round(display_s, 6),
            cursor_x=cursor[0],
            cursor_y=cursor[1],
            t=time.time(),
            **extra,
        )
        if self._f:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        self.frame_index += 1
        self._win_frames += 1
        now = time.perf_counter()
        if now - self._win_start >= self._window_s:
            self.fps = self._win_frames / (now - self._win_start)
            self._win_start = now
            self._win_frames = 0

    def display_stats(self) -> str:
        """displayStats-style overlay text (sutil.cpp:723-783)."""
        return f"fps: {self.fps:5.1f} | frame {self.frame_index}"

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class Timer:
    """Segment timer for state-update / render / display splits (main.cpp:248-282)."""

    def __init__(self):
        self._t = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self._t
        self._t = now
        return dt
