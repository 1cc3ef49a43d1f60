from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    MoEConfig,
    ParallelConfig,
    RunConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    applicable_shapes,
    get_config,
    list_configs,
    reduce_config,
    skipped_shapes,
)
