from medmoe_torch.config.loader import (  # noqa: F401
    DotDict,
    compose,
    load_yaml,
    merge,
    resolve_interpolations,
    to_dict,
    DEFAULT_CONFIG_DIR,
)
