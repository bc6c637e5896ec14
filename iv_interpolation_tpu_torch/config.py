"""Typed configuration tree with environment overlays (port of
``iv_interpolation_tpu/config.py``).

Every section and field of the JAX package's config is here with the same
name and default, so ``config_to_dict`` of both packages agree and a
config carried across (``convert.config_from_dict``) loads unchanged.
A few knobs exist only for the TPU's compiler; the port keeps
them so configs load, and says in each one's comment that it does not
read it.

Layering: defaults -> environment preset (``development`` / ``testing`` /
``production``) -> env vars (``IVTPU_<SECTION>__<FIELD>``) -> explicit
overrides.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StorageConfig:
    """Storage adapter selection: the ``memory``, ``parquet`` and
    ``postgres`` backends."""

    backend: str = "parquet"  # 'parquet' | 'memory' | 'postgres'
    root: str = "./data"  # dataset root for the parquet backend
    # Postgres adapter settings (read by PostgresStore)
    pg_host: str = "localhost"
    pg_database: str = "trading_data"
    pg_user: str = "postgres"
    pg_password: str = ""
    pg_port: int = 5432


@dataclass
class ProcessingConfig:
    """Batching / sharding configuration."""

    batch_size: int = 256  # symbols (series) per device step
    # padded series lengths; 65536 covers a 30-day span of minutes
    bucket_sizes: tuple = (64, 256, 1024, 4096, 16384, 65536)
    # the JAX package's cap on batch x bucket_len slots per step, which
    # bounds the TPU compiler's time. The port does not read it: a batch
    # is capped by batch_size alone (the JAX behaviour with 0)
    max_slots_per_batch: int = 1 << 20
    # symbols per storage read (bounds host RAM); 0 = all at once
    read_chunk_symbols: int = 2048
    # process-level scale-out: process i of n owns symbol s iff
    # crc32(s) % n == i; storage upserts are the rendezvous, run
    # manifests are per process. CLI: --shard I/N.
    shard_index: int = 0
    shard_count: int = 1
    # data-parallel mesh over torch.distributed ranks
    # (parallel.mesh.pipeline_mesh): batches shard their symbol dim over
    # the first axis. None -> every launched rank; a product other than
    # the launched world raises
    mesh_shape: Optional[tuple] = None
    mesh_axis_names: tuple = ("data",)
    dtype: str = "float32"  # device compute dtype ('float32'|'float64'|'bfloat16')
    enable_logging: bool = True  # cli: skip setup_logging when False
    log_level: str = "INFO"


@dataclass
class InterpolationConfig:
    """Task-1 settings."""

    frequency: str = "1min"
    method: str = "linear"  # 'linear' | 'nearest' | 'ffill' | 'cubic'
    max_gap_hours: int = 48
    min_data_points: int = 10
    extrapolate: bool = False
    compute_greeks: bool = True
    max_span_days: int = 30
    max_timeline_points: int = 100_000


@dataclass
class CandleReconstructionConfig:
    """Task-2 settings."""

    target_frequency: str = "5min"
    source_frequency: str = "1min"
    min_candles_required: int = 5  # incomplete-bucket filter
    validate_ohlc: bool = True


@dataclass
class DataBridgeConfig:
    """Synthetic-OHLCV bridge settings."""

    conversion_strategy: str = "spread_simulation"
    # 'spread_simulation' | 'price_midpoint' | 'trend_following' | 'simple_spread'
    enable_quality_checks: bool = True
    seed: int = 0  # counter-based PRNG root key
    base_spread_percent: float = 0.002
    volatility_factor: float = 1.5
    min_spread_percent: float = 0.0005
    # quality-gate ceiling on (high - low) / source price
    max_spread_percent: float = 0.10
    trend_strength: float = 0.6
    base_volume: float = 50.0  # exponential volume imputation scale


@dataclass
class SurfaceConfig:
    """Vol-surface settings, read by the surface task's families
    (``models``), ``fit_eval_surface`` through its callers and the
    streaming session. The ``rbf_*`` and ``ah_*`` knobs belong to families
    that are not ported yet."""

    smile_method: str = "cubic_spline"
    # 'cubic_spline' | 'smoothing_spline' | 'svi' | 'essvi' | 'sabr' | 'rbf' | 'ah'
    grid_strikes: int = 50   # dense eval grid in strike (per expiry)
    spline_bc: str = "not-a-knot"
    compute_local_vol: bool = False
    lm_max_iters: int = 50
    svi_weighting: str = "uniform"  # 'uniform' | 'vega' residual weights
    # the JAX package's switch to inline its LM iterations for the TPU's
    # dispatch floor; the port does not read it
    svi_unroll: bool | None = None
    smoothing_lam: float = 1e-4
    rbf_smoothing: float = 1e-8
    rbf_kernel: str = "thin_plate"  # 'thin_plate' | 'gaussian' | 'multiquadric'
    rbf_butterfly_penalty: float = 0.0
    rbf_calendar_penalty: float = 0.0
    rbf_penalty_iters: int = 16
    rbf_centers: int | None = None
    ah_grid: int = 257
    ah_iters: int = 16
    # the JAX package's cap on surfaces per compiled AH fit (a compile
    # bound on the TPU); the port does not read it
    ah_max_batch: int | None = 512
    compensated: bool = False
    butterfly_penalty: float = 0.0


@dataclass
class MonitoringConfig:
    """Observability settings."""

    log_dir: str = "./logs"
    snapshot_dir: str = "./snapshots"
    enable_snapshots: bool = True
    refresh_interval_s: float = 5.0
    memory_warn_pct: float = 80.0
    memory_crit_pct: float = 90.0
    low_throughput_surfaces_s: float = 100.0
    enable_profiler: bool = False
    profiler_dir: str = "./profiles"


@dataclass
class CheckpointConfig:
    """Run-manifest checkpoint/resume."""

    manifest_dir: str = "./runs"
    checkpoint_interval: int = 100  # manifest events buffered between flushes
    max_retries: int = 3  # batch retry budget (runner._attempt)


@dataclass
class Config:
    storage: StorageConfig = field(default_factory=StorageConfig)
    processing: ProcessingConfig = field(default_factory=ProcessingConfig)
    interpolation: InterpolationConfig = field(default_factory=InterpolationConfig)
    candle_reconstruction: CandleReconstructionConfig = field(
        default_factory=CandleReconstructionConfig
    )
    data_bridge: DataBridgeConfig = field(default_factory=DataBridgeConfig)
    surface: SurfaceConfig = field(default_factory=SurfaceConfig)
    monitoring: MonitoringConfig = field(default_factory=MonitoringConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    environment: str = "production"
    debug: bool = False


_ENV_PRESETS = {
    "development": dict(batch_size=16, log_level="DEBUG", debug=True),
    "testing": dict(batch_size=64, log_level="INFO", debug=False),
    "production": dict(batch_size=256, log_level="INFO", debug=False),
}


def load_dotenv(path: str = ".env", override: bool = False) -> bool:
    """Load ``KEY=VALUE`` lines from a ``.env`` file into ``os.environ``.

    ``#`` comments and blank lines are ignored, optional surrounding
    quotes are stripped, and existing environment variables win unless
    ``override``. Returns True if the file existed.
    """
    if not os.path.isfile(path):
        return False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip()
            if value[:1] in ("'", '"') and value[-1:] == value[:1]:
                value = value[1:-1]
            if override or key not in os.environ:
                os.environ[key] = value
    return True


def get_config(environment: Optional[str] = None, **overrides) -> Config:
    """Build a config for the given environment.

    ``environment`` falls back to the ``ENVIRONMENT`` env var.
    ``overrides`` takes ``section__field`` keys, e.g.
    ``get_config(surface__grid_strikes=64)``. A ``.env`` file in the
    working directory is loaded first (the real environment wins).
    """
    load_dotenv()
    env = environment or os.getenv("ENVIRONMENT", "production")
    if env not in _ENV_PRESETS:
        raise ValueError(f"Unknown environment: {env!r}")
    preset = _ENV_PRESETS[env]

    cfg = Config(environment=env, debug=preset["debug"])
    cfg.processing.batch_size = preset["batch_size"]
    cfg.processing.log_level = preset["log_level"]

    # Env-var overlay: IVTPU_<SECTION>__<FIELD>
    for key, raw in os.environ.items():
        if key.startswith("IVTPU_") and "__" in key:
            section_name, field_name = key[len("IVTPU_"):].lower().split("__", 1)
            _apply_override(cfg, section_name, field_name, raw)

    for key, value in overrides.items():
        if "__" not in key:
            raise ValueError(f"Override key must be section__field: {key!r}")
        section_name, field_name = key.split("__", 1)
        _apply_override(cfg, section_name, field_name, value)

    return cfg


def _parse_tuple(raw: str) -> tuple:
    """Comma-separated env string -> tuple, int elements where they parse
    (other elements stay strings, for tuple-of-str knobs)."""
    out = []
    for v in raw.split(","):
        v = v.strip()
        try:
            out.append(int(v))
        except ValueError:
            out.append(v)
    return tuple(out)


def _apply_override(cfg: Config, section_name: str, field_name: str, value) -> None:
    if not hasattr(cfg, section_name):
        raise ValueError(f"Unknown config section: {section_name!r}")
    section = getattr(cfg, section_name)
    if not hasattr(section, field_name):
        raise ValueError(f"Unknown field {field_name!r} in section {section_name!r}")
    current = getattr(section, field_name)
    if isinstance(value, str) and not isinstance(current, str):
        # parse env-var strings into the field's declared type
        if isinstance(current, bool):
            value = value.lower() in ("1", "true", "yes", "on")
        elif isinstance(current, int):
            value = int(value)
        elif isinstance(current, float):
            value = float(value)
        elif isinstance(current, tuple):
            value = _parse_tuple(value)
        elif current is None:
            # a None default hides the declared type: read the annotation
            ann = str(next((f.type for f in dataclasses.fields(section)
                            if f.name == field_name), ""))
            if value.strip().lower() in ("", "none", "null"):
                value = None
            elif "bool" in ann:  # before int: bools are ints in Python
                value = value.lower() in ("1", "true", "yes", "on")
            elif "tuple" in ann:
                value = _parse_tuple(value)
            elif "int" in ann:
                value = int(value)
            elif "float" in ann:
                value = float(value)
    setattr(section, field_name, value)


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)
