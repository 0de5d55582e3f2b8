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

#: the port's YAML configs (byte-for-byte copies of the JAX package's)
CONFIG_DIR = pathlib.Path(__file__).resolve().parent
