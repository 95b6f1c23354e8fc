from .generator import (
    GeneratorConfig,
    N_STYLE_CHANNELS,
    RESOLUTION_UNTIL_K,
    STYLE_DIM,
    generate,
    init_generator_params,
    mapping,
    split_ws,
    synthesis,
    w_to_s,
)
