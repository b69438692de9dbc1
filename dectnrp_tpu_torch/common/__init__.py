"""Common infrastructure of the port (see dectnrp_tpu/common): clocks
(`watch.py`), logging (`logging.py`), the batched JSON record export
(`json_export.py`), the native host runtime's bindings (`native.py`),
the live-IQ TCP scope (`tcp_scope.py`), the device mesh with its two
collectives (`mesh.py`) and the program's spans and counters
(`trace.py`)."""
from .json_export import JsonExport
from .watch import Watch

__all__ = ["JsonExport", "Watch"]
