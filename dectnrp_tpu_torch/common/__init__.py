"""Common infrastructure of the port (see dectnrp_tpu/common): clocks
(`watch.py`), logging (`logging.py`), the batched JSON record export
(`json_export.py`), the native host runtime's bindings (`native.py`),
the live-IQ TCP scope (`tcp_scope.py`) and the device mesh with its two
collectives (`mesh.py`)."""
from .json_export import JsonExport
from .watch import Watch

__all__ = ["JsonExport", "Watch"]
