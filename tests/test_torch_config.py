"""Port parity: the port's config (``iv_interpolation_tpu_torch/config.py``)
against the JAX package's ``config.py``, and ``convert.config_from_dict``.

Exact: ``config_to_dict`` of both packages must be equal for every preset,
under the same ``IVTPU_*`` env-var overrides, ``.env`` values and explicit
overrides.
"""

import dataclasses
import json
import os

import pytest

from iv_interpolation_tpu import config as ref
from iv_interpolation_tpu_torch import config as port
from iv_interpolation_tpu_torch import convert
from iv_interpolation_tpu_torch.pipeline.runner import PipelineRunner
from iv_interpolation_tpu_torch.pipeline.storage import MemoryStore

OVERRIDES = {
    "IVTPU_PROCESSING__BATCH_SIZE": "32",
    "IVTPU_PROCESSING__MESH_SHAPE": "4,1",
    "IVTPU_PROCESSING__MESH_AXIS_NAMES": "data,model",
    "IVTPU_PROCESSING__BUCKET_SIZES": "64,4096",
    "IVTPU_SURFACE__SVI_UNROLL": "true",
    "IVTPU_SURFACE__RBF_CENTERS": "128",
    "IVTPU_SURFACE__AH_MAX_BATCH": "256",
    "IVTPU_DATA_BRIDGE__SEED": "7",
    "IVTPU_STORAGE__BACKEND": "memory",
    "IVTPU_INTERPOLATION__EXTRAPOLATE": "1",
    "IVTPU_MONITORING__REFRESH_INTERVAL_S": "2.5",
}


@pytest.fixture
def clean_env(monkeypatch, tmp_path):
    """No IVTPU_*/ENVIRONMENT variables and no .env from the caller."""
    monkeypatch.chdir(tmp_path)
    for key in list(os.environ):
        if key.startswith("IVTPU_") or key == "ENVIRONMENT":
            monkeypatch.delenv(key)
    return monkeypatch


@pytest.mark.parametrize("env", ["development", "testing", "production"])
def test_presets_match_jax(clean_env, env):
    assert port.config_to_dict(port.get_config(env)) == ref.config_to_dict(ref.get_config(env))


def test_default_environment_and_variable_match_jax(clean_env):
    assert port.config_to_dict(port.get_config()) == ref.config_to_dict(ref.get_config())
    clean_env.setenv("ENVIRONMENT", "development")
    got = port.config_to_dict(port.get_config())
    assert got == ref.config_to_dict(ref.get_config()) and got["environment"] == "development"


@pytest.mark.parametrize("env", ["testing", "production"])
def test_env_var_and_explicit_overrides_match_jax(clean_env, env):
    for key, value in OVERRIDES.items():
        clean_env.setenv(key, value)
    kw = dict(processing__dtype="float64", interpolation__method="cubic",
              candle_reconstruction__min_candles_required=3)
    got = port.config_to_dict(port.get_config(env, **kw))
    assert got == ref.config_to_dict(ref.get_config(env, **kw))
    assert got["processing"]["mesh_shape"] == (4, 1)
    assert got["surface"]["ah_max_batch"] == 256
    assert got["processing"]["batch_size"] == 32 and got["interpolation"]["method"] == "cubic"


def test_dotenv_matches_jax(clean_env, tmp_path):
    (tmp_path / ".env").write_text(
        "# a comment\n\nIVTPU_PROCESSING__BATCH_SIZE='48'\nIVTPU_DATA_BRIDGE__SEED=\"5\"\n"
        "ENVIRONMENT=testing\n")
    try:
        got = port.config_to_dict(port.get_config())
        assert got == ref.config_to_dict(ref.get_config())
        assert got["processing"]["batch_size"] == 48 and got["environment"] == "testing"
        assert got["data_bridge"]["seed"] == 5
    finally:
        for key in ("IVTPU_PROCESSING__BATCH_SIZE", "IVTPU_DATA_BRIDGE__SEED", "ENVIRONMENT"):
            os.environ.pop(key, None)
    assert not port.load_dotenv(str(tmp_path / "missing.env"))


@pytest.mark.parametrize("bad", [dict(environment="staging"),
                                 dict(nosection__x=1), dict(processing__nofield=1),
                                 dict(batch_size=3)])
def test_bad_keys_raise_like_jax(clean_env, bad):
    env = bad.pop("environment", None)
    for pkg in (ref, port):
        with pytest.raises(ValueError):
            pkg.get_config(env, **bad)


def test_config_from_dict_round_trips(clean_env):
    for key, value in OVERRIDES.items():
        clean_env.setenv(key, value)
    jax_dict = ref.config_to_dict(ref.get_config("testing"))
    cfg = convert.config_from_dict(jax_dict)
    assert isinstance(cfg, port.Config)
    assert port.config_to_dict(cfg) == jax_dict
    assert convert.config_from_dict(port.config_to_dict(cfg)) == cfg
    # through JSON, where tuples become lists
    assert convert.config_from_dict(json.loads(json.dumps(jax_dict))) == cfg
    for section in dataclasses.fields(port.Config):
        value = getattr(cfg, section.name)
        assert dataclasses.is_dataclass(value) or not isinstance(value, dict)


@pytest.mark.parametrize("bad", [{"nosection": {}}, {"processing": {"nofield": 1}}])
def test_config_from_dict_rejects_unknown_names(bad):
    with pytest.raises(ValueError, match="unknown"):
        convert.config_from_dict(bad)


@pytest.mark.parametrize("shape", [(4,), (2, 1), (1, 8)])
def test_a_mesh_of_more_than_one_device_raises(shape):
    cfg = port.get_config("testing")
    cfg.processing.mesh_shape = shape
    with pytest.raises(ValueError, match="mesh is not ported"):
        port.check_single_device(cfg.processing)
    with pytest.raises(ValueError, match="mesh is not ported"):
        PipelineRunner(cfg, store=MemoryStore(), device="cpu")


@pytest.mark.parametrize("shape", [None, (1,), (1, 1)])
def test_a_one_device_mesh_runs(shape):
    cfg = port.get_config("testing")
    cfg.processing.mesh_shape = shape
    runner = PipelineRunner(cfg, store=MemoryStore(), device="cpu")
    assert runner.device.type == "cpu"
