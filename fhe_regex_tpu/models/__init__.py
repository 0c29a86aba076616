from fhe_regex_tpu.models.patterns import (  # noqa: F401
    CompiledPattern,
    CompiledPatternSet,
    CompiledPositions,
    BASELINE_CONFIGS,
)
