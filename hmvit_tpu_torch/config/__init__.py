from .loader import load_config, register_parser, save_config  # noqa: F401
