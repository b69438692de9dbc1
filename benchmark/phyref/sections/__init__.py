"""The standard's tables (ETSI TS 103 636-3), frozen copies."""
from . import part3  # noqa: F401
