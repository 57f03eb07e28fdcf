"""Mitsuba .vol grid volume loader.

Port of ``mitsuba_nlvrl_tpu/scene/vol_io.py`` (host side, numpy). Format:
bytes 'VOL' + version 3, int32 encoding (1 = float32), int32
xres/yres/zres, int32 channels, 6 float32 bbox (xmin ymin zmin xmax ymax
zmax), then xres*yres*zres*channels float32 with x varying fastest.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np


class VolumeGrid(NamedTuple):
    data: np.ndarray       # (zres, yres, xres, channels) float32
    bbox_min: np.ndarray   # (3,) float32
    bbox_max: np.ndarray   # (3,) float32

    @property
    def max_value(self) -> float:
        return float(self.data.max())


def load_vol(path: str) -> VolumeGrid:
    with open(path, 'rb') as f:
        raw = f.read()
    if raw[:3] != b'VOL':
        raise ValueError(f"{path}: not a Mitsuba .vol file")
    version = raw[3]
    if version != 3:
        raise ValueError(f"{path}: unsupported .vol version {version}")
    enc, xres, yres, zres, channels = struct.unpack_from('<iiiii', raw, 4)
    if enc != 1:
        raise ValueError(f"{path}: only float32 encoding supported, got {enc}")
    bbox = struct.unpack_from('<6f', raw, 24)
    n = xres * yres * zres * channels
    data = np.frombuffer(raw, '<f4', n, 48).reshape(zres, yres, xres, channels)
    return VolumeGrid(np.ascontiguousarray(data),
                      np.asarray(bbox[:3], np.float32),
                      np.asarray(bbox[3:], np.float32))
