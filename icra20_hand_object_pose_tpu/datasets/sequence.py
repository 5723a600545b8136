"""Recorded RGB-D grasp-sequence I/O.

Rebuild of the reference's dataset reader (SURVEY.md §3 "Dataset I/O":
16-bit depth PNGs, ground-truth poses, camera intrinsics, per-frame hand
poses, read by the main.cpp driver with OpenCV). Directory layout:

    <seq>/
      cam_K.txt            # 3x3 intrinsics, row-major
      meta.json            # optional: {"depth_scale": 1e-3, "width":, "height":}
      depth/000000.png     # 16-bit grayscale, depth_scale units -> meters
      rgb/000000.png       # optional 8-bit color stream (visualization)
      pose_gt/000000.txt   # optional 4x4 object model->camera (evaluation)
      hand_base/000000.txt # optional 4x4 hand base->camera
      hand_q/000000.txt    # optional joint angles (one row)

Decoding prefers the native C++ loader (the `native` subpackage: libpng-free
zlib decoder + prefetch thread pool) and falls back to the pure-Python
codec in utils/pngio.py.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..utils import pngio
from ..utils.config import CameraIntrinsics
from .synthetic import SyntheticFrame


def _read_matrix(path: str, shape: tuple) -> np.ndarray:
    m = np.loadtxt(path, dtype=np.float64).reshape(shape)
    return m.astype(np.float32)


@dataclass
class RecordedFrame:
    depth: np.ndarray              # [H,W] float32 meters, 0 invalid
    pose_gt: np.ndarray | None     # [4,4] or None
    hand_base: np.ndarray | None   # [4,4] or None
    hand_q: np.ndarray | None      # [J] or None
    index: int
    rgb: np.ndarray | None = None  # [H,W,3] uint8 or None


class RecordedSequence:
    """Lazy frame access over a sequence directory."""

    def __init__(self, root: str, use_native: bool | None = None):
        self.root = root
        kpath = os.path.join(root, "cam_K.txt")
        if not os.path.exists(kpath):
            raise FileNotFoundError(f"{kpath} (not a sequence dir?)")
        K = _read_matrix(kpath, (3, 3))
        meta = {}
        mpath = os.path.join(root, "meta.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                meta = json.load(f)
        self.depth_scale = float(meta.get("depth_scale", 1e-3))
        ddir = os.path.join(root, "depth")
        self._depth_files = sorted(
            os.path.join(ddir, n) for n in os.listdir(ddir)
            if n.endswith(".png")
        )
        if not self._depth_files:
            raise FileNotFoundError(f"no depth PNGs under {ddir}")
        # read one frame for the resolution
        first = self._read_depth_raw(self._depth_files[0])
        h, w = first.shape
        self.camera = CameraIntrinsics(
            fx=float(K[0, 0]), fy=float(K[1, 1]),
            cx=float(K[0, 2]), cy=float(K[1, 2]),
            width=int(meta.get("width", w)), height=int(meta.get("height", h)),
            depth_scale=self.depth_scale,
        )
        self._native = None
        if use_native is not False:
            try:
                from .. import native
                self._native = native if native.available() else None
            except Exception:
                self._native = None
        if use_native is True and self._native is None:
            raise RuntimeError("native loader requested but not available")

    def _read_depth_raw(self, path: str) -> np.ndarray:
        return pngio.read_png_gray(path)

    def __len__(self) -> int:
        return len(self._depth_files)

    def _side_file(self, sub: str, idx: int, ext: str = ".txt") -> str | None:
        base = os.path.splitext(os.path.basename(self._depth_files[idx]))[0]
        p = os.path.join(self.root, sub, base + ext)
        return p if os.path.exists(p) else None

    def __getitem__(self, idx: int) -> RecordedFrame:
        path = self._depth_files[idx]
        if self._native is not None:
            raw = self._native.read_png16(path)
        else:
            raw = self._read_depth_raw(path)
        depth = raw.astype(np.float32) * self.depth_scale
        p = self._side_file("pose_gt", idx)
        hb = self._side_file("hand_base", idx)
        hq = self._side_file("hand_q", idx)
        return RecordedFrame(
            depth=depth,
            pose_gt=_read_matrix(p, (4, 4)) if p else None,
            hand_base=_read_matrix(hb, (4, 4)) if hb else None,
            hand_q=np.loadtxt(hq, dtype=np.float64).reshape(-1).astype(np.float32)
            if hq else None,
            index=idx,
            rgb=self._load_rgb(idx),
        )

    def _load_rgb(self, idx: int) -> np.ndarray | None:
        p = self._side_file("rgb", idx, ext=".png")
        return pngio.read_png_rgb(p) if p else None

    def __iter__(self) -> Iterator[RecordedFrame]:
        if self._native is not None:
            # prefetch pipeline: the C++ pool decodes frames ahead of the
            # tracker (SURVEY.md §2 L1 "host loader")
            yield from self._native.prefetch_frames(
                self._depth_files, self._load_side, self.depth_scale
            )
        else:
            for i in range(len(self)):
                yield self[i]

    def _load_side(self, idx: int):
        p = self._side_file("pose_gt", idx)
        hb = self._side_file("hand_base", idx)
        hq = self._side_file("hand_q", idx)
        return (
            _read_matrix(p, (4, 4)) if p else None,
            _read_matrix(hb, (4, 4)) if hb else None,
            np.loadtxt(hq, dtype=np.float64).reshape(-1).astype(np.float32)
            if hq else None,
            self._load_rgb(idx),
        )


def save_sequence(
    frames: list[SyntheticFrame],
    camera: CameraIntrinsics,
    root: str,
) -> None:
    """Persist a (synthetic) sequence in the recorded-sequence layout —
    gives tests and demos a real on-disk dataset exercising the full IO
    path, and a template for converting the reference's released data."""
    os.makedirs(root, exist_ok=True)
    subs = ["depth", "pose_gt", "hand_base", "hand_q"]
    if any(getattr(f, "rgb", None) is not None for f in frames):
        subs.append("rgb")
    for sub in subs:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    np.savetxt(os.path.join(root, "cam_K.txt"), camera.K, fmt="%.9g")
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({
            "depth_scale": camera.depth_scale,
            "width": camera.width, "height": camera.height,
        }, f)
    for i, fr in enumerate(frames):
        name = f"{i:06d}"
        raw = np.round(fr.depth / camera.depth_scale)
        raw = np.clip(raw, 0, 65535).astype(np.uint16)
        pngio.write_png16(os.path.join(root, "depth", name + ".png"), raw)
        if getattr(fr, "rgb", None) is not None:
            pngio.write_png_rgb(os.path.join(root, "rgb", name + ".png"), fr.rgb)
        np.savetxt(os.path.join(root, "pose_gt", name + ".txt"),
                   fr.pose_gt, fmt="%.9g")
        np.savetxt(os.path.join(root, "hand_base", name + ".txt"),
                   fr.hand_base, fmt="%.9g")
        np.savetxt(os.path.join(root, "hand_q", name + ".txt"),
                   fr.hand_q.reshape(1, -1), fmt="%.9g")
