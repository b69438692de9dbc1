"""ETSI TS 103 636 standard tables of the port (copies of dectnrp_tpu/sections)."""
from . import part3  # noqa: F401
