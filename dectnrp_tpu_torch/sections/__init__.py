"""ETSI TS 103 636 standard tables and codecs of the port (copies of dectnrp_tpu/sections)."""
from . import part3, part4  # noqa: F401
