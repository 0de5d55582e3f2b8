from ipp_rl_tpu_torch.config.schema import (  # noqa: F401
    Config,
    EnvironmentConfig,
    MappingConfig,
    MCTSZeroHyperParams,
    MissionConfig,
    ScenarioConfig,
    SensorConfig,
    UAVConfig,
    config_from_dict,
    load_config,
)

import pathlib

#: the YAML configs live with the JAX package and are read in place
CONFIG_DIR = pathlib.Path(__file__).resolve().parents[2] / "ipp_rl_tpu" / "config"
