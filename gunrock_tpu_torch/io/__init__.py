from .market import load_market, parse_market_bytes  # noqa: F401
from .generators import rmat, rgg, small_world, rmat_coo, rmat_device  # noqa: F401
