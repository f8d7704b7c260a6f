from .info import make_info, write_info  # noqa: F401
