from .defaults import (
    TYPE_ID_CONVERSION,
    BackboneConfig,
    Config,
    DatasetsConfig,
    HeadConfig,
    InputConfig,
    ModelConfig,
    SolverConfig,
    TestConfig,
    default_config,
    dgde_run_config,
)

__all__ = [
    "Config",
    "BackboneConfig",
    "DatasetsConfig",
    "HeadConfig",
    "InputConfig",
    "ModelConfig",
    "SolverConfig",
    "TestConfig",
    "default_config",
    "dgde_run_config",
    "TYPE_ID_CONVERSION",
]
