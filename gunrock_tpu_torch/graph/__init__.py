from .csr import CsrGraph, from_coo  # noqa: F401
from .device import DeviceGraph, to_device, from_numpy, round_up  # noqa: F401
