"""Scene configuration: the reference's JSON schema, parsed strictly.

Copy of volume_path_tracer_tpu/utils/config.py (the port imports nothing of
the JAX package). The reference renderer parses one JSON scene file with
glaze static reflection and `error_on_missing_keys = true` (its
src/configuration.cpp:8-22, include/vpt/configuration.hpp:14-65). Its scene
files must parse unmodified; unknown or missing keys are errors, matching
glaze's strictness in both directions.

`volume_path` is resolved relative to the config file's directory, as the
reference does at main.cpp:40.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple


class ConfigError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class CameraParameters:
    position: Tuple[float, float, float]
    look: Tuple[float, float, float]
    up: Tuple[float, float, float]
    vfov_deg: float
    imaging_ratio: float


@dataclasses.dataclass(frozen=True)
class InfiniteLightParameters:
    xyz: Tuple[float, float, float]
    multiplier: float


@dataclasses.dataclass(frozen=True)
class DistantLightParameters:
    xyz: Tuple[float, float, float]
    multiplier: float
    inv_direction: Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class SinglePixelMode:
    enabled: bool
    coord: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class WorkerParameters:
    single_pixel: SinglePixelMode
    use_jitter: bool
    infinite_light: InfiniteLightParameters
    distant_light: DistantLightParameters
    max_depth: int


@dataclasses.dataclass(frozen=True)
class VolumeParameters:
    henyey_greenstein_g: float
    le_scale: float
    sigma_a: float
    sigma_s: float
    temperature_offset: float
    temperature_scale: float

    @property
    def sigma_t(self) -> float:
        return self.sigma_a + self.sigma_s


@dataclasses.dataclass(frozen=True)
class Configuration:
    seed: int
    output_size: Tuple[int, int]  # (width, height)
    tile_size: Tuple[int, int]
    num_waves: int
    num_workers: int
    camera_parameters: CameraParameters
    worker_parameters: WorkerParameters
    volume_path: str  # resolved to an absolute path at load time
    volume_parameters: VolumeParameters


def _vec(value, n, caster, where):
    if not isinstance(value, (list, tuple)) or len(value) != n:
        raise ConfigError(f"{where}: expected a {n}-element array, got {value!r}")
    return tuple(caster(v) for v in value)


def _build(cls, obj, where):
    """Strictly map a JSON object onto a dataclass: no missing/unknown keys."""
    if not isinstance(obj, dict):
        raise ConfigError(f"{where}: expected an object, got {type(obj).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    missing = sorted(set(fields) - set(obj))
    unknown = sorted(set(obj) - set(fields))
    if missing:
        raise ConfigError(f"{where}: missing required key(s): {', '.join(missing)}")
    if unknown:
        raise ConfigError(f"{where}: unknown key(s): {', '.join(unknown)}")
    kwargs = {}
    for name, f in fields.items():
        v = obj[name]
        sub = f"{where}.{name}"
        t = f.type
        if t in ("Tuple[float, float, float]",):
            kwargs[name] = _vec(v, 3, float, sub)
        elif t in ("Tuple[int, int]",):
            kwargs[name] = _vec(v, 2, int, sub)
        elif t == "float":
            kwargs[name] = float(v)
        elif t == "int":
            if isinstance(v, bool) or not isinstance(v, (int, float)) or int(v) != v:
                raise ConfigError(f"{sub}: expected an integer, got {v!r}")
            kwargs[name] = int(v)
        elif t == "bool":
            if not isinstance(v, bool):
                raise ConfigError(f"{sub}: expected a boolean, got {v!r}")
            kwargs[name] = v
        elif t == "str":
            kwargs[name] = str(v)
        elif t == "SinglePixelMode":
            kwargs[name] = _build(SinglePixelMode, v, sub)
        elif t == "InfiniteLightParameters":
            kwargs[name] = _build(InfiniteLightParameters, v, sub)
        elif t == "DistantLightParameters":
            kwargs[name] = _build(DistantLightParameters, v, sub)
        elif t == "CameraParameters":
            kwargs[name] = _build(CameraParameters, v, sub)
        elif t == "WorkerParameters":
            kwargs[name] = _build(WorkerParameters, v, sub)
        elif t == "VolumeParameters":
            kwargs[name] = _build(VolumeParameters, v, sub)
        else:  # pragma: no cover - schema bug
            raise AssertionError(f"unhandled field type {t} at {sub}")
    return cls(**kwargs)


def read_configuration(path: str) -> Configuration:
    """Load and strictly validate a scene JSON file (configuration.cpp:8-22)."""
    with open(path, "r") as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            raise ConfigError(f"Failed to parse configuration file {path!r}: {e}")
    cfg = _build(Configuration, obj, "configuration")
    # Resolve volume_path relative to the config file's directory (main.cpp:40).
    base = os.path.dirname(os.path.abspath(path))
    resolved = os.path.normpath(os.path.join(base, cfg.volume_path))
    return dataclasses.replace(cfg, volume_path=resolved)


def loads_configuration(text: str, base_dir: str = ".") -> Configuration:
    """Parse a scene JSON string (for tests and programmatic use)."""
    cfg = _build(Configuration, json.loads(text), "configuration")
    resolved = os.path.normpath(os.path.join(base_dir, cfg.volume_path))
    return dataclasses.replace(cfg, volume_path=resolved)
